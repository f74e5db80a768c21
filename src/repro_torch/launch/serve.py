"""Serving launcher for the port: build an index on one device, then serve
batched queries and report recall against the exact LinScan.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 10000 \
        --queries 64 [--kprime 800] [--budget 16] [--m 60] [--h 1] \
        [--index-buckets 2048] [--sketch-kind full|lite] \
        [--value-dtype f32|bf16|f8] \
        [--score-backend fused|pallas|grouped|reference] \
        [--auto-tune --tune-memory-mb 8 --recall-floor 0.9] \
        [--query-batch 16] [--dataset splade_like] [--device cuda|cpu] \
        [--seed 0] [--wal runs/wal --snapshot-dir runs/snap \
         --snapshot-every 5000 --compact-threshold 0.5]

Prints ``indexed N docs over 1 shard(s)`` and ``recall@k=... p50=...``,
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
    args = ap.parse_args(argv)
    if args.wal is None and (args.snapshot_dir is not None
                             or args.snapshot_every is not None
                             or args.compact_threshold is not None):
        ap.error("--snapshot-dir/--snapshot-every/--compact-threshold "
                 "require --wal (durability is WAL-based)")
    if args.snapshot_every is not None and args.snapshot_dir is None:
        ap.error("--snapshot-every requires --snapshot-dir "
                 "(periodic snapshots need somewhere to go)")
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
              "value_dtype": args.value_dtype, "shards": 1,
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
    from repro_torch.serving.serve import QueryServer
    from repro_torch.storage import vecstore

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
                                   seed=args.seed, durability=durability),
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
    print(f"indexed {index.size} docs over 1 shard(s)", flush=True)
    if args.wal and args.snapshot_dir:
        index.snapshot()
        print(f"snapshot written to {args.snapshot_dir}", flush=True)

    server = QueryServer(index, k=args.k, kprime=args.kprime,
                         budget=args.budget,
                         score_backend=args.score_backend)
    recalls = []
    state = index.state
    for lo in range(0, args.queries, args.query_batch):
        hi = min(lo + args.query_batch, args.queries)
        ids, _ = server.query_many(qi[lo:hi], qv[lo:hi])
        q_dense = vecstore.densify_query(
            ds.n, index._tensor(qi[lo:hi], torch.int32),
            index._tensor(qv[lo:hi], torch.float32))
        exact = ops.exact_scores_all(state.store, q_dense)
        exact = torch.where(state.active[None, :], exact, -torch.inf)
        _, top = topk_desc(exact, min(args.k, index.size))
        truth = state.ids[top.long()].cpu().numpy()
        for b in range(hi - lo):
            recalls.append(len(set(ids[b].tolist())
                               & set(truth[b].tolist())) / args.k)
    lat = server.latency_percentiles()
    print(f"recall@{args.k}={np.mean(recalls):.3f}  "
          f"p50={lat['p50']:.1f}ms p90={lat['p90']:.1f}ms "
          f"p99={lat['p99']:.1f}ms", flush=True)


if __name__ == "__main__":
    main()
