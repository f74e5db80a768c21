"""Serving launcher for the port: build an index (one device, or S shards),
then serve batched queries and report recall against the exact LinScan.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 10000 \
        --queries 64 [--kprime 800] [--budget 16] [--m 60] [--h 1] \
        [--index-buckets 2048] [--sketch-kind full|lite] \
        [--value-dtype f32|bf16|f8] \
        [--score-backend fused|pallas|grouped|reference] \
        [--auto-tune --tune-memory-mb 8 --recall-floor 0.9] \
        [--query-batch 16] [--dataset splade_like] [--device cuda|cpu] \
        [--seed 0] [--wal runs/wal --snapshot-dir runs/snap \
         --snapshot-every 5000 --compact-threshold 0.5] \
        [--device-budget-mb 64 --tier-chunk-slots 256] [--shards 4] \
        [--metrics-port 0] [--serve-port 0 --hold-seconds 60]

Prints ``indexed N docs over S shard(s)`` and ``recall@k=... p50=...``,
the lines ``repro.launch.serve`` prints.  The corpus and queries are
drawn by ``repro_torch.data.synth`` (the reference's draws) from ``--seed``
and ``--seed + 1``; with the default seed they are the reference launcher's.

``--sketch-kind lite`` serves the §3.3 upper-bound-only half sketch and
``--value-dtype`` picks the quantized sketch-cell storage.  ``--auto-tune``
ignores ``--m/--sketch-kind/--value-dtype`` and grid-searches them on a
corpus sample (``repro_torch.eval.tune``, on ``--device``) for the fastest
configuration that fits ``--tune-memory-mb`` of index memory at ``--docs``
scale while holding ``--recall-floor`` on the sample.

``--wal DIR`` makes the index durable (``repro_torch.persist``, on disk in
the reference's formats): every insert/delete is logged to the write-ahead
log before it is applied, and on startup the launcher *recovers* (latest
snapshot from ``--snapshot-dir`` + WAL tail replay) instead of re-indexing,
printing ``recovered N docs from snapshot + WAL tail``.  The corpus flags
are pinned to the WAL dir (``launch_params.json``); a second run with
other ones is refused.  ``--snapshot-every N`` snapshots after every N
logged ops; ``--compact-threshold X`` rebuilds recycled sketch columns
whenever the max per-slot overestimate exceeds X.

``--device-budget-mb MB`` serves the hot/cold tiered index: the sketch
stays on the device, the raw rows live in pinned host memory behind a
device chunk cache of MB MiB (``--tier-chunk-slots`` slots a chunk); the
answers are the resident index's.  ``--shards N`` serves the sharded index
(``repro_torch.serving.sharded``): N shard states in this one process, all
on ``--device`` (without it, round robin over the visible CUDA devices),
the ``--docs`` capacity split over them.  Only the shard count may change
between runs on one ``--wal`` (the restore is then elastic); with
``--device-budget-mb`` each shard gets that budget, and
``--device-budget-mb`` + ``--wal`` + ``--shards > 1`` is refused.

Observability, the front door and robustness take the reference
launcher's flags, names, defaults and checks (``repro.launch.serve``):
``--metrics-port`` (``/metrics``, ``/metrics.json``, ``/healthz``,
``/readyz``, ``/debug/*``), ``--event-log`` (+ ``-max-bytes``, ``-keep``),
``--recorder-capacity``, ``--record-sample``, the ``--slo-*`` family,
``--trace-every``, ``--profile-dir`` (a ``torch.profiler`` Chrome trace of
the query loop, and ``/debug/profile``), ``--hold-seconds``;
``--serve-port P`` boots the HTTP/JSON front door
(``repro_torch.serving.frontend``: ``POST /v1/query`` plus the metrics
family on the same port, 0 = OS-assigned; the URL is printed) with
``--max-batch``, ``--batch-window-ms``, ``--queue-depth``,
``--deadline-ms``; ``--failpoints`` / ``--failpoint-seed``; ``--degrade``
and its ``--degrade-*`` thresholds; ``--watchdog-timeout-s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: Launch parameters the reference's launcher does not record, with the
#: value its runs imply (its corpus is always drawn from seed 0).
_PARAM_DEFAULTS = {"seed": 0}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=10_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--kprime", type=int, default=800)
    ap.add_argument("--budget", type=int, default=None,
                    help="anytime cutoff: score only the BUDGET largest-|q| "
                         "coordinates")
    ap.add_argument("--m", type=int, default=60)
    ap.add_argument("--h", type=int, default=1)
    ap.add_argument("--index-buckets", type=int, default=None,
                    help="hash coordinates into this many bitmap rows")
    ap.add_argument("--sketch-kind", default="full", choices=["full", "lite"],
                    help="lite = upper-bound-only half sketch (§3.3)")
    ap.add_argument("--value-dtype", default="bf16",
                    choices=["f32", "bf16", "f8"],
                    help="sketch cell storage dtype (directed-rounded)")
    ap.add_argument("--auto-tune", action="store_true",
                    help="pick m/sketch-kind/value-dtype with the "
                         "repro_torch.eval.tune grid search instead")
    ap.add_argument("--tune-memory-mb", type=float, default=8.0, metavar="MB",
                    help="auto-tune: index memory budget (sketch + inverted "
                         "index) at --docs scale")
    ap.add_argument("--recall-floor", type=float, default=0.9, metavar="R",
                    help="auto-tune: minimum recall@k on the tuning sample")
    ap.add_argument("--score-backend", default=None,
                    choices=["reference", "grouped", "fused", "pallas"],
                    help="scoring backend (default: $REPRO_SCORE_BACKEND or "
                         "'fused', kernel A; 'pallas', the reference "
                         "launcher's name for it, is an alias of 'fused')")
    ap.add_argument("--dataset", default="splade_like")
    ap.add_argument("--query-batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--wal", default=None, metavar="DIR",
                    help="write-ahead-log dir; enables the durable index")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="snapshot dir (recovery base + periodic snapshots)")
    ap.add_argument("--snapshot-every", type=int, default=None, metavar="N",
                    help="snapshot after every N logged ops")
    ap.add_argument("--compact-threshold", type=float, default=None,
                    metavar="X", help="compact when max sketch drift > X")
    ap.add_argument("--shards", type=int, default=1,
                    help="corpus shards, served by one process (several "
                         "may share a device)")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    metavar="MB",
                    help="per-device byte budget for raw vector rows; "
                         "enables the hot/cold tiered store (sketches stay "
                         "resident, rows page between a device chunk cache "
                         "and pinned host RAM); results are bit-identical "
                         "to the resident index")
    ap.add_argument("--tier-chunk-slots", type=int, default=256, metavar="S",
                    help="tiered store paging granularity in slots per chunk")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve /metrics (Prometheus text) + /metrics.json "
                         "+ /healthz on this port (0 = OS-assigned)")
    ap.add_argument("--event-log", default=None, metavar="FILE",
                    help="append one JSON line per query/maintenance op")
    ap.add_argument("--event-log-max-bytes", type=int, default=None,
                    metavar="B", help="rotate the event log at B bytes "
                                      "(default: never)")
    ap.add_argument("--event-log-keep", type=int, default=3, metavar="N",
                    help="rotated event-log segments to keep")
    ap.add_argument("--recorder-capacity", type=int, default=512,
                    metavar="N", help="flight-recorder ring size "
                                      "(0 disables the recorder)")
    ap.add_argument("--record-sample", type=float, default=0.05, metavar="R",
                    help="head-sampling rate for fast OK requests "
                         "(failures and the slow tail are always kept)")
    ap.add_argument("--slo-latency-ms", type=float, default=100.0,
                    metavar="MS", help="latency SLO bound")
    ap.add_argument("--slo-target", type=float, default=0.99, metavar="F",
                    help="fraction of requests that must meet the latency "
                         "bound")
    ap.add_argument("--slo-availability", type=float, default=0.999,
                    metavar="F", help="fraction of requests that must not "
                                      "be rejected/expired/errored")
    ap.add_argument("--slo-fast-window-s", type=float, default=300.0,
                    metavar="S", help="fast burn-rate window")
    ap.add_argument("--slo-slow-window-s", type=float, default=3600.0,
                    metavar="S", help="slow burn-rate window")
    ap.add_argument("--trace-every", type=int, default=None, metavar="N",
                    help="run every N-th query batch on the staged path "
                         "(per-stage histograms); default 32 when metrics "
                         "or the event log are enabled, 0 = off")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the query loop")
    ap.add_argument("--hold-seconds", type=float, default=0.0, metavar="S",
                    help="keep the process (and metrics endpoint) alive "
                         "this long after the query loop")
    ap.add_argument("--serve-port", type=int, default=None, metavar="P",
                    help="boot the HTTP/JSON front door (POST /v1/query + "
                         "/metrics family) on this port (0 = OS-assigned) "
                         "and hold for --hold-seconds")
    ap.add_argument("--max-batch", type=int, default=16, metavar="B",
                    help="front door: max queries coalesced into one fused "
                         "dispatch")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    metavar="W", help="front door: max coalesce wait after "
                                      "the first queued query")
    ap.add_argument("--queue-depth", type=int, default=128, metavar="D",
                    help="front door: bounded admission queue; beyond this "
                         "requests get 429 + Retry-After")
    ap.add_argument("--deadline-ms", type=float, default=1000.0, metavar="T",
                    help="front door: default per-request deadline; "
                         "requests expiring in-queue are dropped + counted")
    ap.add_argument("--failpoints", default=None, metavar="SPEC",
                    help="arm fault-injection failpoints: comma-separated "
                         "site=mode[:arg][:prob]; equivalent to "
                         "REPRO_FAILPOINTS")
    ap.add_argument("--failpoint-seed", type=int, default=0, metavar="N",
                    help="seed for the failpoint injection schedule")
    ap.add_argument("--degrade", action="store_true",
                    help="front door: enable the graceful-degradation "
                         "ladder (L1 shrink rerank, L2 sketch-only, "
                         "L3 shed lowest-priority tenants)")
    ap.add_argument("--degrade-enter-burn", type=float, default=4.0,
                    metavar="X", help="ladder: escalate when SLO fast-burn "
                                      ">= X")
    ap.add_argument("--degrade-exit-burn", type=float, default=1.0,
                    metavar="X", help="ladder: calm requires fast-burn <= X")
    ap.add_argument("--degrade-enter-queue-frac", type=float, default=0.75,
                    metavar="F", help="ladder: escalate when queue fill "
                                      "fraction >= F")
    ap.add_argument("--degrade-exit-queue-frac", type=float, default=0.25,
                    metavar="F", help="ladder: calm requires queue fill "
                                      "fraction <= F")
    ap.add_argument("--degrade-dwell-ticks", type=int, default=4,
                    metavar="N", help="ladder: consecutive calm ticks "
                                      "before de-escalating one level")
    ap.add_argument("--watchdog-timeout-s", type=float, default=None,
                    metavar="S", help="front door: fail in-flight queries "
                                      "with 504 when a fused dispatch is "
                                      "stuck longer than S seconds")
    args = ap.parse_args(argv)
    if args.trace_every is None:
        args.trace_every = 32 if (args.metrics_port is not None
                                  or args.event_log) else 0
    if args.wal is None and (args.snapshot_dir is not None
                             or args.snapshot_every is not None
                             or args.compact_threshold is not None):
        ap.error("--snapshot-dir/--snapshot-every/--compact-threshold "
                 "require --wal (durability is WAL-based)")
    if args.snapshot_every is not None and args.snapshot_dir is None:
        ap.error("--snapshot-every requires --snapshot-dir "
                 "(periodic snapshots need somewhere to go)")
    if (args.device_budget_mb is not None and args.wal is not None
            and args.shards > 1):
        ap.error("--device-budget-mb with both --wal and --shards > 1 is "
                 "not supported yet; drop one of the three")
    if args.auto_tune and args.wal is not None:
        ap.error("--auto-tune is incompatible with --wal: durable runs pin "
                 "their spec to the WAL dir; tune first, then launch with "
                 "the chosen flags")
    return args


def _check_launch_params(args) -> None:
    """Pin the corpus/spec flags of a durable run to its WAL directory."""
    params = {"dataset": args.dataset, "docs": args.docs, "m": args.m,
              "h": args.h, "index_buckets": args.index_buckets,
              "sketch_kind": args.sketch_kind,
              "value_dtype": args.value_dtype, "shards": args.shards,
              "seed": args.seed}
    os.makedirs(args.wal, exist_ok=True)
    pfile = os.path.join(args.wal, "launch_params.json")
    if os.path.exists(pfile):
        with open(pfile) as f:
            prev = json.load(f)
        changed = {k: (prev.get(k, _PARAM_DEFAULTS.get(k)), v)
                   for k, v in params.items()
                   if prev.get(k, _PARAM_DEFAULTS.get(k)) != v
                   and k != "shards"}
        if changed:
            sys.exit(f"refusing to recover from {args.wal}: "
                     f"{', '.join(f'--{k} was {a!r}, now {b!r}' for k, (a, b) in changed.items())} "
                     f"— the synthetic corpus/spec would no longer match the "
                     f"indexed vectors; rerun with the original flags or "
                     f"fresh --wal/--snapshot-dir directories")
        if prev != params:       # a reference run's file, or its shard count
            with open(pfile, "w") as f:
                json.dump(params, f)
    else:
        with open(pfile, "w") as f:
            json.dump(params, f)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.api import DurabilityConfig, IndexConfig, open_index
    from repro_torch.data import synth
    from repro_torch.kernels import ops
    from repro_torch.kernels.sinnamon_score import topk_desc
    from repro_torch.obs import (
        EventLog,
        FlightRecorder,
        MetricsServer,
        ReadyState,
        SLOMonitor,
        SLOSpec,
        set_event_log,
        set_recorder,
    )
    from repro_torch.obs.instrument import install_recorder_gauges
    from repro_torch.serving.serve import QueryServer
    from repro_torch.storage import vecstore

    if args.failpoints:
        from repro_torch.fault import FailpointRegistry, set_failpoints
        set_failpoints(FailpointRegistry(seed=args.failpoint_seed)
                       .configure(args.failpoints))
        print(f"failpoints armed: {args.failpoints} "
              f"(seed={args.failpoint_seed})", flush=True)

    obs_on = args.metrics_port is not None or args.serve_port is not None
    if args.event_log:
        set_event_log(EventLog(args.event_log,
                               max_bytes=args.event_log_max_bytes,
                               keep=args.event_log_keep))
        print(f"event log: {args.event_log}"
              + (f" (rotate at {args.event_log_max_bytes} B, "
                 f"keep {args.event_log_keep})"
                 if args.event_log_max_bytes else ""), flush=True)
    recorder = slo_monitor = None
    ready = ReadyState()
    ready.mark("engine", False, "index build/recovery in progress")
    if obs_on and args.recorder_capacity > 0:
        recorder = FlightRecorder(capacity=args.recorder_capacity,
                                  sample_rate=args.record_sample)
        set_recorder(recorder)
        install_recorder_gauges(recorder)
    if obs_on:
        slo_monitor = SLOMonitor(
            SLOSpec(latency_ms=args.slo_latency_ms,
                    latency_target=args.slo_target,
                    availability_target=args.slo_availability),
            fast_window_s=args.slo_fast_window_s,
            slow_window_s=args.slo_slow_window_s)
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = MetricsServer(
            port=args.metrics_port, ready=ready, recorder=recorder,
            slo=slo_monitor, profile_dir=args.profile_dir).start()
        print(f"metrics: {metrics_server.url}/metrics "
              f"(json: /metrics.json, liveness: /healthz, "
              f"readiness: /readyz, debug: /debug/requests /debug/slo)",
              flush=True)

    ds = synth.DATASETS[args.dataset]
    idx, val = synth.make_corpus(args.seed, ds, args.docs, pad=256)
    qi, qv = synth.make_queries(args.seed + 1, ds, args.queries, pad=96)
    cap = ((args.docs + 31) // 32) * 32
    sketch_kind, cell_dtype = args.sketch_kind, args.value_dtype
    if args.auto_tune:
        from repro_torch.eval import tune as tunelib
        result = tunelib.tune(
            idx, val, qi, qv, ds.n,
            memory_budget_bytes=args.tune_memory_mb * 2 ** 20,
            recall_floor=args.recall_floor, k=args.k,
            target_docs=args.docs, sample_docs=min(args.docs, 2048),
            sample_queries=min(args.queries, 32),
            ms=tuple(sorted({32, args.m, 96})),
            cell_dtypes=("bf16", "f8"),
            kprimes=(args.kprime,), budgets=(args.budget,),
            h=args.h, index_buckets=args.index_buckets,
            backend=args.score_backend, device=args.device)
        pt = result.point
        sketch_kind, cell_dtype, args.m = (pt["sketch_kind"],
                                           pt["cell_dtype"], pt["m"])
        print(f"auto-tune: m={pt['m']} sketch_kind={sketch_kind} "
              f"value_dtype={cell_dtype} -> predicted index "
              f"{pt['predicted_index_bytes'] / 2**20:.2f} MiB @ {args.docs} "
              f"docs, sample recall@{args.k}={pt['recall_at_k']:.3f} "
              f"({'meets constraints' if result.feasible else 'NO feasible point — best-recall fallback'})",
              flush=True)
    durability = None
    if args.wal:
        # Recovery serves the PREVIOUS run's vectors, while the corpus is
        # regenerated from the flags: refuse to mix durable state with a
        # differently-drawn corpus (or a spec the snapshot would override).
        _check_launch_params(args)
        durability = DurabilityConfig(
            wal_dir=args.wal, snapshot_dir=args.snapshot_dir,
            snapshot_every=args.snapshot_every,
            compact_threshold=args.compact_threshold)
    index = open_index(IndexConfig(n=ds.n, capacity=cap, m=args.m, h=args.h,
                                   max_nnz=256, positive_only=ds.nonneg,
                                   index_buckets=args.index_buckets,
                                   sketch_kind=sketch_kind,
                                   cell_dtype=cell_dtype,
                                   backend=args.score_backend,
                                   seed=args.seed, shards=args.shards,
                                   durability=durability,
                                   device_budget_mb=args.device_budget_mb,
                                   tier_chunk_slots=args.tier_chunk_slots),
                       device=args.device)
    recovered = index.size
    if recovered:
        print(f"recovered {recovered} docs from snapshot + WAL tail",
              flush=True)
    todo = np.array([d for d in range(args.docs)
                     if args.wal is None or d not in index], np.int64)
    for lo in range(0, len(todo), 2048):
        chunk = todo[lo:lo + 2048]
        index.insert_many(chunk.tolist(), idx[chunk], val[chunk])
    print(f"indexed {index.size} docs over "
          f"{getattr(index, 'n_shards', 1)} shard(s)", flush=True)
    if args.wal and args.snapshot_dir:
        index.snapshot()
        print(f"snapshot written to {args.snapshot_dir}", flush=True)

    server = QueryServer(index, k=args.k, kprime=args.kprime,
                         budget=args.budget,
                         score_backend=args.score_backend,
                         trace_every=args.trace_every)
    ready.mark("engine", True)      # built/recovered: ready to serve
    if slo_monitor is not None:
        slo_monitor.start()
    profiler = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if index.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
    recalls = []
    # the exact LinScan's ground truth reads the whole raw store (a tiered
    # or sharded index's logical state, moved to the device for it)
    dev = index.device
    state = index.logical_state()
    store = vecstore.VecStore(state.store.indices.to(dev),
                              state.store.values.to(dev))
    active, live_ids = state.active.to(dev), state.ids.to(dev)
    for lo in range(0, args.queries, args.query_batch):
        hi = min(lo + args.query_batch, args.queries)
        ids, _ = server.query_many(qi[lo:hi], qv[lo:hi])
        q_dense = vecstore.densify_query(
            ds.n, torch.as_tensor(qi[lo:hi], dtype=torch.int32, device=dev),
            torch.as_tensor(qv[lo:hi], dtype=torch.float32, device=dev))
        exact = ops.exact_scores_all(store, q_dense)
        exact = torch.where(active[None, :], exact, -torch.inf)
        _, top = topk_desc(exact, min(args.k, index.size))
        truth = live_ids[top.long()].cpu().numpy()
        for b in range(hi - lo):
            recalls.append(len(set(ids[b].tolist())
                               & set(truth[b].tolist())) / args.k)
    del store, state, active, live_ids
    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        out = os.path.join(args.profile_dir, "query_loop.json")
        profiler.export_chrome_trace(out)
        print(f"profiler trace written to {out}", flush=True)
    lat = server.latency_percentiles()
    print(f"recall@{args.k}={np.mean(recalls):.3f}  "
          f"p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
          f"p99={lat['p99']:.1f}ms", flush=True)
    frontend = front_door = None
    if args.serve_port is not None:
        from repro_torch.fault import DegradeConfig
        from repro_torch.serving.frontend import (FrontendServer,
                                                  ServingFrontend)
        degrade_cfg = DegradeConfig(
            enabled=args.degrade,
            enter_burn=args.degrade_enter_burn,
            exit_burn=args.degrade_exit_burn,
            enter_queue_frac=args.degrade_enter_queue_frac,
            exit_queue_frac=args.degrade_exit_queue_frac,
            dwell_ticks=args.degrade_dwell_ticks) if args.degrade else None
        frontend = ServingFrontend(
            server, max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms,
            queue_depth=args.queue_depth,
            default_deadline_ms=args.deadline_ms,
            slo=slo_monitor, degrade=degrade_cfg,
            watchdog_timeout_s=args.watchdog_timeout_s)
        front_door = FrontendServer(
            frontend, port=args.serve_port, slo=slo_monitor,
            profile_dir=args.profile_dir)
        front_door.ready.add_check("engine",
                                   lambda: ready()[1]["engine"]["ok"])
        front_door.start()
        print(f"front door: POST {front_door.url}/v1/query "
              f"(max_batch={args.max_batch}, "
              f"window={args.batch_window_ms:g}ms, "
              f"queue_depth={args.queue_depth}, "
              f"deadline={args.deadline_ms:g}ms); "
              f"metrics + /debug also on {front_door.url}", flush=True)
    if args.hold_seconds > 0:
        import time
        print(f"holding for {args.hold_seconds:.0f}s "
              f"(front door and metrics stay up); Ctrl-C to exit",
              flush=True)
        try:
            time.sleep(args.hold_seconds)
        except KeyboardInterrupt:
            pass
    if front_door is not None:
        front_door.stop()
    if frontend is not None:
        frontend.close()
    if slo_monitor is not None:
        slo_monitor.stop()
    set_recorder(None)
    log = set_event_log(None)
    if log is not None:
        log.close()
    if metrics_server is not None:
        metrics_server.stop()


if __name__ == "__main__":
    main()
