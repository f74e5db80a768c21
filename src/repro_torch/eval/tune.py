"""Auto-tuner: pick a lever configuration for a memory budget + recall floor.

Counterpart of ``repro.eval.tune``.  :func:`tune` grid-searches the levers
(sketch half-size ``m``, ``sketch_kind`` full/lite, cell dtype, rerank
``k'``, anytime cutoff) on a *sample* of the corpus, measures each point
with :func:`repro_torch.eval.recall.frontier`, and returns a ready
:class:`~repro_torch.core.engine.EngineSpec` (plus the serving-side
``kprime`` / ``budget``) that fits the memory budget at the *target*
corpus size while holding the recall floor on the sample.

Memory is predicted analytically (:func:`spec_index_bytes`, the index
accounting of ``SinnamonIndex.memory_bytes``), so the sample only has to be
large enough for the recall estimate to transfer.
``repro_torch.launch.serve --auto-tune`` exposes this end to end.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

import torch

from repro_torch.core import engine as eng
from repro_torch.core import sketch
from repro_torch.eval import recall as _recall


def spec_index_bytes(spec: eng.EngineSpec) -> int:
    """Predicted index bytes (sketch + bit-packed inverted index), equal to
    ``SinnamonIndex.memory_bytes()['index_total']`` without allocating."""
    rows = spec.m if spec.upper_only else 2 * spec.m
    cell = torch.empty((), dtype=sketch.torch_cell_dtype(spec.dtype)
                       ).element_size()
    bit_rows = spec.index_buckets or spec.n
    return rows * spec.capacity * cell + bit_rows * (spec.capacity // 32) * 4


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of a :func:`tune` search.

    ``spec`` is sized for the *target* corpus; ``point`` is the winning
    sample measurement; ``frontier`` is every evaluated point (each carries
    ``predicted_index_bytes`` at target scale and ``feasible``).  When no
    point satisfies both constraints, ``feasible`` is False and
    ``spec/point`` describe the highest-recall point within the memory
    budget (or the overall highest-recall point if none fit).
    """

    spec: eng.EngineSpec
    kprime: int
    budget: Optional[int]
    point: dict
    frontier: list
    feasible: bool


def tune(doc_idx, doc_val, q_idx, q_val, n: int, *,
         memory_budget_bytes: float, recall_floor: float, k: int = 10,
         target_docs: Optional[int] = None,
         sample_docs: int = 2048, sample_queries: int = 32,
         ms: Sequence[int] = (16, 32, 64, 96),
         sketch_kinds: Sequence[str] = ("full", "lite"),
         cell_dtypes: Sequence[str] = ("bf16",),
         kprimes: Sequence[Optional[int]] = (None,),
         budgets: Sequence[Optional[int]] = (None,),
         h: int = 1, index_buckets: Optional[int] = None, seed: int = 0,
         backend: Optional[str] = None, device=None) -> TuneResult:
    """Grid-search the levers on ``device`` (None: the card); return a spec
    meeting both constraints.

    Among feasible points (predicted index bytes at ``target_docs`` ≤
    budget AND sample recall@k ≥ floor) the lowest measured p50 latency
    wins, ties toward smaller memory.  ``kprimes`` / ``budgets`` entries of
    None mean the harness defaults (10·k rerank, no query cutoff).
    """
    target_docs = target_docs or len(doc_idx)
    n_sample = min(sample_docs, len(doc_idx))
    nq = min(sample_queries, len(q_idx))
    points = [dict(m=m, sketch_kind=kind, cell_dtype=dt, kprime=kp,
                   budget=b)
              for m, kind, dt, kp, b in itertools.product(
                  ms, sketch_kinds, cell_dtypes, kprimes, budgets)]
    measured = _recall.frontier(doc_idx[:n_sample], doc_val[:n_sample],
                                q_idx[:nq], q_val[:nq], n, points, k=k,
                                h=h, index_buckets=index_buckets, seed=seed,
                                backend=backend, device=device)

    target_cap = _recall.pad_capacity(target_docs)
    max_nnz = doc_idx.shape[1]
    for pt in measured:
        spec = _target_spec(pt, n, target_cap, max_nnz, h, index_buckets,
                            seed)
        pt["predicted_index_bytes"] = spec_index_bytes(spec)
        pt["feasible"] = (pt["predicted_index_bytes"] <= memory_budget_bytes
                          and pt["recall_at_k"] >= recall_floor)

    feasible = [pt for pt in measured if pt["feasible"]]
    if feasible:
        best = min(feasible,
                   key=lambda pt: (pt["p50_ms"], pt["predicted_index_bytes"]))
    else:
        in_budget = [pt for pt in measured
                     if pt["predicted_index_bytes"] <= memory_budget_bytes]
        best = max(in_budget or measured, key=lambda pt: pt["recall_at_k"])
    spec = _target_spec(best, n, target_cap, max_nnz, h, index_buckets, seed)
    return TuneResult(spec=spec, kprime=int(best["kprime"]),
                      budget=best["budget"], point=best, frontier=measured,
                      feasible=bool(feasible))


def _target_spec(pt: dict, n: int, capacity: int, max_nnz: int, h: int,
                 index_buckets: Optional[int], seed: int) -> eng.EngineSpec:
    return eng.EngineSpec(
        n=n, m=pt["m"], capacity=capacity, max_nnz=max_nnz, h=h,
        positive_only=False, index_buckets=index_buckets,
        sketch_kind=pt["sketch_kind"], dtype=pt["cell_dtype"],
        value_dtype="float32", seed=seed)
