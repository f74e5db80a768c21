"""Run one cell of the benchmark once, in this process.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by the names in
``BENCHMARK.json``, and the files they name (the data's value and
activation laws, the mix's loop, the configuration's reference; see
``benchlib/spec.py``), opens the port's index on the card, fills it with
the configuration's corpus drawn from the seed, warms up the cell's own
shapes, then runs the mix's loop for ``--seconds`` seconds.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
same window under ``torch.profiler`` with every few steps staged and
reports its per-layer metrics.  After the window the system is freed and
the plain reference judges a sample of the answers; the last line of
standard output is the result, a JSON object.

Exit codes: 0 with a result; 2 without the card(s) the cell needs; 3 when
a module of JAX or of the JAX package is loaded; anything else is a
failure of the run.  ``--control`` (not part of a benchmark run) puts a
lower-precision search in the system's place: ``f8-cells`` serves with
float8 sketch cells, ``f8-reference`` answers with the reference's own
search in float8 cells and store.  ``--device cpu`` and ``--set`` (dotted
key=JSON overrides of the configuration and the mix) serve the CPU tests.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Top-level modules that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among module ``names`` (by default
    those loaded in this process), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def loaded_forbidden(when: str) -> bool:
    """True (and says so) when JAX or the JAX package is loaded."""
    bad = forbidden_modules()
    if bad:
        log(f"run: modules of JAX or the JAX package loaded {when}: {bad}")
    return bool(bad)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("f8-cells", "f8-reference"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=JSON")
    return ap.parse_args(argv)


def apply_sets(cfg: dict, traffic: dict, sets: list) -> None:
    """``config.data.docs=3000`` / ``traffic.query_batch=4`` overrides."""
    for item in sets:
        key, value = item.split("=", 1)
        root, *path = key.split(".")
        d = {"config": cfg, "traffic": traffic}[root]
        for part in path[:-1]:
            d = d[part]
        d[path[-1]] = json.loads(value)


def cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths.  The port builds
    its kernels under ``build/repro_torch`` of the checkout itself."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")


class Run:
    """What a metric reader sees of one run."""

    def __init__(self, cfg, traffic, cell, device_kind):
        self.cfg, self.traffic, self.cell = cfg, traffic, cell
        self.device_kind = device_kind
        self.window: list = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.spans: list = []
        self.staged_queries: list = []
        self.timeline = None
        self.posting = None
        self.maps = None
        self.two_sided = True
        self.cell_bytes = 2


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchlib import check as bcheck
    from benchlib import data as bdata
    from benchlib import spec as bspec

    spec = bspec.Spec(ROOT)
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    apply_sets(cfg, traffic, args.set)
    # every file the cell names, found before any work: a missing one
    # fails here, naming the file looked for
    bspec.value_law(cfg["data"]["value_law"])
    bspec.activation_law(cfg["data"]["activation"])
    Loop = bspec.loop(traffic["loop"])
    reference = bspec.reference(cfg["reference"])
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            log(f"run: the cell needs {cell['chips']} CUDA device(s); "
                f"found {torch.cuda.device_count()}")
            return 2
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache_dirs()

    from benchlib.system import System

    # -- set-up: the system, the corpus, the pools, the warm-up --------------
    data = cfg["data"]
    trace = bool(args.trace)
    staged = traffic.get("staged", {})
    system = System(cfg, dev,
                    staged_queries=trace and bool(staged.get("every")),
                    cell_dtype="f8" if args.control == "f8-cells" else None)
    cdf = bdata.activation_cdf(data, dev)
    posting = torch.zeros(int(data["n"]), dtype=torch.int64, device=dev) \
        if trace else None
    doc_nnz = 0
    t0 = time.perf_counter()
    for c in range(bdata.n_chunks(data)):
        numbers, idx, val = bdata.corpus_chunk(args.seed, data, c, cdf, dev)
        system.insert(bdata.doc_id(numbers).cpu(), idx, val)
        doc_nnz += int((idx >= 0).sum())
        if posting is not None:
            posting += torch.bincount(idx[idx >= 0].long(),
                                      minlength=posting.numel())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    queries = bdata.query_pool(args.seed, data,
                               int(traffic["query_pool_batches"]),
                               int(traffic["query_batch"]), cdf, dev)
    del cdf
    loop = Loop(system, traffic, queries, trace, seed=args.seed, cfg=cfg)
    for _ in range(int(traffic["warmup_steps"])):
        loop.step("warmup")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS
    mem = system.memory_bytes()
    log(f"run: {args.workload} seed {args.seed} on {kind}: set-up "
        f"{setup_s:.3f} s (corpus of {data['docs']} docs drawn and inserted "
        f"in {t_fill:.3f} s); index bytes {mem}; device bytes in use "
        f"{torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}")
    log(f"run: mean non-zeros a document {doc_nnz / int(data['docs']):.4f} "
        f"(psi_doc {data['psi_doc']}, pad {data['doc_pad']}), a query "
        f"{float((queries[0] >= 0).sum()) / queries[0][..., 0].numel():.4f} "
        f"(psi_query {data['psi_query']}, pad {data['query_pad']})")
    if loaded_forbidden("after set-up"):
        return 3

    # -- the window ------------------------------------------------------------
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    t_start, t_end = loop.run(args.seconds)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    run = Run(cfg, traffic, cell, kind)
    run.window = loop.window()
    run.window_s = t_end - t_start
    run.setup_s = setup_s
    attempted = sum(s.calls for s in run.window)
    failed = sum(s.failed for s in run.window)
    if trace:
        from benchlib.trace import Timeline
        ix = cfg["index"]
        staged_steps = [s for s in run.window if s.spans is not None]
        run.spans = [s.spans for s in staged_steps]
        run.staged_queries = [(queries[0][s.query_batch].numpy(),
                               queries[1][s.query_batch].numpy())
                              for s in staged_steps]
        run.posting = posting.cpu().numpy()
        run.maps = reference.mappings(int(ix["seed"]), int(ix["n"]),
                                      int(ix["m"]), int(ix["h"]))
        run.two_sided = not (ix.get("positive_only") or
                             ix.get("sketch_kind", "full") == "lite")
        run.cell_bytes = system.index.state.sketch.element_size()
        run.timeline = Timeline(prof) if dev.type == "cuda" else None

    # -- correctness: the system freed, the reference judges ----------------
    system.close()
    del system, loop.system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pools = {"query_idx": queries[0], "query_val": queries[1]}
    t0 = time.perf_counter()
    answers = None
    if args.control == "f8-reference":
        answers = bcheck.reference_answers(cfg, traffic, args.seed,
                                           loop.steps, pools, dev, "f8", "f8")
    verdict = bcheck.check(cfg, traffic, args.seed, loop.steps, pools, dev,
                           answers)
    t_check = time.perf_counter() - t0
    limits = {"score_err": float(cfg["check"]["score_err"]),
              "rank_faults": int(cfg["check"]["rank_faults"])}
    correct = (failed == 0 and verdict["judged"] > 0
               and verdict["score_err"] <= limits["score_err"]
               and verdict["rank_faults"] <= limits["rank_faults"])
    recall = verdict["recall_hits"] / max(verdict["recall_total"], 1)
    log(f"run: window {run.window_s:.3f} s, {len(run.window)} steps, "
        f"{attempted} calls, {failed} failed; peak device bytes {peak}")
    log(f"run: judged {verdict['judged']} queries in {t_check:.3f} s; "
        f"faults {verdict['faults']}; recall@{cfg['serving']['k']} "
        f"{recall:.6f} against the exact top-{cfg['serving']['k']}")

    # -- metrics ------------------------------------------------------------------
    kind_metrics = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(kind_metrics, cell):
        value = bspec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": kind,
              "count": int(cell["chips"]) if dev.type == "cuda" else 0,
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if trace and dev.type == "cuda":
        tl = run.timeline
        device["busy_s"] = tl.busy_s
        device["window_s"] = tl.window_s
        result["breakdown"] = {"device_ops": tl.device_ops(),
                               "idle_gaps": tl.idle_gaps()}
    result["checks"] = {
        name: {"value": verdict[name], "limit": limits[name]}
        for name in ("score_err", "rank_faults")}
    if loaded_forbidden("once the window has closed"):
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
