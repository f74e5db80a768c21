"""Serving launcher for the port: build an index on one device, then serve
batched queries and report recall against the exact LinScan.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 10000 \
        --queries 64 [--kprime 800] [--budget 16] [--m 60] [--h 1] \
        [--index-buckets 2048] [--sketch-kind full|lite] \
        [--value-dtype f32|bf16|f8] \
        [--score-backend fused|pallas|grouped|reference] \
        [--auto-tune --tune-memory-mb 8 --recall-floor 0.9] \
        [--query-batch 16] [--dataset splade_like] [--device cuda|cpu] \
        [--seed 0]

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
"""

from __future__ import annotations

import argparse


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
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.api import IndexConfig, open_index
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
    index = open_index(IndexConfig(n=ds.n, capacity=cap, m=args.m, h=args.h,
                                   max_nnz=256, positive_only=ds.nonneg,
                                   index_buckets=args.index_buckets,
                                   sketch_kind=sketch_kind,
                                   cell_dtype=cell_dtype,
                                   backend=args.score_backend,
                                   seed=args.seed),
                       device=args.device)
    for lo in range(0, args.docs, 2048):
        hi = min(lo + 2048, args.docs)
        index.insert_many(range(lo, hi), idx[lo:hi], val[lo:hi])
    print(f"indexed {index.size} docs over 1 shard(s)", flush=True)

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
