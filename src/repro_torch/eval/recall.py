"""Recall harness: quality of the approximate engine against its exact oracle.

Counterpart of ``repro.eval.recall``: the paper's §6.2/§6.5 protocol.
Build an index at one lever configuration, serve the query set through
``QueryServer.query_many``, and score the returned ids against the exact
top-k.  :func:`frontier` emits one (memory, latency, recall) point per lever
configuration — the shape of the paper's Figure 8/9 trade-off curves.

The exact oracle (:func:`exact_topk_ids`) is kernel B's LinScan mode plus
``topk_desc`` on the card, and its plain twin on the CPU — the same result
set as ``repro_torch.core.linscan.brute_force_topk`` without a host pass over
the corpus.

Harness conventions (deliberate, see ``lever_spec``):

* documents are inserted with ``ext_id = corpus row``, so oracle ids and
  returned ids share a namespace;
* the raw store keeps float32 values so the Algorithm 7 rerank is exact
  against the oracle — the *sketch* quantization under test is isolated
  from incidental storage rounding;
* ``positive_only`` stays False so ``sketch_kind="full"`` always stores
  both U and L — the paper's full-vs-lite memory comparison (§3.3) is 2m
  rows vs m rows even on non-negative collections.

Corpora and queries may be numpy arrays or tensors on any device (tensors
already on the card stay there).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.kernels import csr_score as _csr
from repro_torch.kernels.sinnamon_score import topk_desc
from repro_torch.serving.serve import QueryServer
from repro_torch.storage import vecstore

#: Queries per LinScan launch of the exact oracle (bounds its [b, D]
#: score block and top-k keys: 64 x 1.1M docs is 0.29 GB of f32).
ORACLE_QUERIES = 64


def recall_at_k(pred_ids, true_ids) -> float:
    """|pred ∩ truth| / |truth| for one query (order-insensitive)."""
    truth = [int(t) for t in np.asarray(true_ids).ravel()]
    hit = set(int(p) for p in np.asarray(pred_ids).ravel())
    return sum(t in hit for t in truth) / max(len(truth), 1)


def reciprocal_rank(pred_ids, top1: int) -> float:
    """1/rank of the exact best document in the returned list (0 if absent)."""
    for rank, p in enumerate(np.asarray(pred_ids).ravel(), start=1):
        if int(p) == int(top1):
            return 1.0 / rank
    return 0.0


def _on(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def exact_topk_ids(doc_idx, doc_val, q_idx, q_val, n: int, k: int,
                   device=None) -> np.ndarray:
    """Exact oracle ids int64[B, k] (corpus-row ids, score-descending,
    exact-score ties toward the lower row id), on ``device`` (None: the
    card).  Kernel B scores every row; ``topk_desc`` keeps the best k."""
    dev = eng.resolve_device(device)
    idx = _on(doc_idx, torch.int32, dev).contiguous()
    val = _on(doc_val, torch.float32, dev).contiguous()
    qi, qv = _on(q_idx, torch.int32, dev), _on(q_val, torch.float32, dev)
    k = min(k, idx.shape[0])
    out = []
    for lo in range(0, qi.shape[0], ORACLE_QUERIES):
        qd = vecstore.densify_query(n, qi[lo:lo + ORACLE_QUERIES],
                                    qv[lo:lo + ORACLE_QUERIES])
        _, top = topk_desc(_csr.csr_score(qd, idx, val), k)
        out.append(top.cpu())
    if not out:
        return np.zeros((0, k), np.int64)
    return torch.cat(out).numpy().astype(np.int64)


def pad_capacity(docs: int) -> int:
    """Smallest valid engine capacity (multiple of 32) holding ``docs``."""
    return ((docs + 31) // 32) * 32


def lever_spec(n: int, docs: int, max_nnz: int, *, m: int = 64, h: int = 1,
               sketch_kind: str = "full", cell_dtype: str = "bf16",
               index_buckets: Optional[int] = None,
               seed: int = 0) -> eng.EngineSpec:
    """An :class:`~repro_torch.core.engine.EngineSpec` at one lever
    configuration; ``cell_dtype`` takes the aliases ``f32 | bf16 | f8``."""
    return eng.EngineSpec(
        n=n, m=m, capacity=pad_capacity(docs), max_nnz=max_nnz, h=h,
        positive_only=False, index_buckets=index_buckets,
        sketch_kind=sketch_kind, dtype=cell_dtype, value_dtype="float32",
        seed=seed)


def build_index(spec: eng.EngineSpec, doc_idx, doc_val, batch: int = 2048,
                device=None) -> eng.SinnamonIndex:
    """Index a padded (idx, val) corpus with ``ext_id = row`` in batches,
    on ``device`` (None: the card)."""
    index = eng.SinnamonIndex(spec, device=device)
    for lo in range(0, len(doc_idx), batch):
        hi = min(lo + batch, len(doc_idx))
        index.insert_many(range(lo, hi), doc_idx[lo:hi], doc_val[lo:hi])
    return index


def evaluate_index(index: eng.SinnamonIndex, q_idx, q_val,
                   truth: np.ndarray, *, k: int = 10,
                   kprime: Optional[int] = None,
                   budget: Optional[int] = None,
                   backend: Optional[str] = None, reps: int = 2) -> dict:
    """Serve the query batch and score it against the exact oracle ids.

    Returns ``{"recall_at_k", "mrr", "p50_ms", "p99_ms"}``.  Queries go
    through ``QueryServer.query_many``; the first call is warm-up and is
    excluded from the latency window (per-query latency = batch time / B).
    """
    server = QueryServer(index, k=k, kprime=kprime or 10 * k, budget=budget,
                         score_backend=backend)
    ids, _ = server.query_many(q_idx, q_val)      # warm-up + answers
    server.reset_stats()
    for _ in range(reps):
        ids, _ = server.query_many(q_idx, q_val)
    recalls = [recall_at_k(ids[b], truth[b]) for b in range(len(q_idx))]
    mrrs = [reciprocal_rank(ids[b], truth[b][0]) for b in range(len(q_idx))]
    lat = server.latency_percentiles()
    return {"recall_at_k": float(np.mean(recalls)),
            "mrr": float(np.mean(mrrs)),
            "p50_ms": lat["p50"], "p99_ms": lat["p99"]}


_POINT_DEFAULTS = {"m": 64, "sketch_kind": "full", "cell_dtype": "bf16",
                   "kprime": None, "budget": None}


def frontier(doc_idx, doc_val, q_idx, q_val, n: int,
             points: Sequence[dict], *, k: int = 10, h: int = 1,
             index_buckets: Optional[int] = None, seed: int = 0,
             backend: Optional[str] = None, reps: int = 2,
             bounds_params: Optional[dict] = None,
             device=None) -> list[dict]:
    """Sweep lever configurations -> (memory, latency, recall) points, on
    ``device`` (None: the card).

    ``points``: dicts with any of ``m / sketch_kind / cell_dtype / kprime /
    budget`` (missing keys take ``_POINT_DEFAULTS``).  The exact oracle is
    computed once.  Each point carries its configuration, the quality and
    latency metrics and the index memory split (``sketch_bytes`` /
    ``index_bytes`` — sketch plus bitmap; the raw store is rerank storage,
    not index memory, per the paper's §6.1.2 accounting).  Each point's
    index is released before the next is built.

    ``bounds_params``: kwargs for
    :func:`repro_torch.eval.bounds.check_upper_bounds`; when given, every
    point also carries its empirical-vs-theory verdict under ``"bounds"``.
    """
    truth = exact_topk_ids(doc_idx, doc_val, q_idx, q_val, n, k,
                           device=device)
    max_nnz = doc_idx.shape[1]
    out = []
    for raw in points:
        unknown = set(raw) - set(_POINT_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown lever(s) {sorted(unknown)}; "
                             f"expected {sorted(_POINT_DEFAULTS)}")
        pt = {**_POINT_DEFAULTS, **raw}
        spec = lever_spec(n, len(doc_idx), max_nnz, m=pt["m"], h=h,
                          sketch_kind=pt["sketch_kind"],
                          cell_dtype=pt["cell_dtype"],
                          index_buckets=index_buckets, seed=seed)
        index = build_index(spec, doc_idx, doc_val, device=device)
        kprime = pt["kprime"] or min(10 * k, spec.capacity)
        metrics = evaluate_index(index, q_idx, q_val, truth, k=k,
                                 kprime=kprime, budget=pt["budget"],
                                 backend=backend, reps=reps)
        mem = index.memory_bytes()
        point = {**pt, "kprime": kprime, "k": k,
                 **metrics,
                 "sketch_bytes": mem["sketch"],
                 "index_bytes": mem["index_total"]}
        if bounds_params is not None:
            from repro_torch.eval import bounds
            point["bounds"] = bounds.check_upper_bounds(index,
                                                        **bounds_params)
        out.append(point)
        del index
    return out
