"""Host-side query serving over one index (counterpart of
``repro.serving.serve``).

``QueryServer.query`` / ``query_many`` return a :class:`QueryResult`.
Per-query latency is kept in a bounded window for ``latency_percentiles``;
with ``trace_every=N > 0`` every N-th ``query_many`` batch runs the staged
path — the same math as separate steps, with ``torch.cuda.synchronize()``
closing each span — and leaves its per-stage breakdown on ``last_trace``.

Not ported yet (they come with the obs and fault ports): the metrics
registry, the flight recorder, the event log and the failpoints.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import sinnamon_score as _sinn
from repro_torch.serving.results import QueryResult, new_trace_id

#: Stage names of the staged (traced) query path, in order.
QUERY_STAGES = ("admission", "sketch_scan", "topk_merge", "rerank")

#: Per-query latency samples kept for the percentiles.
LATENCY_WINDOW = 65_536


class Trace:
    """Named, timed spans of one staged query batch."""

    def __init__(self):
        self.spans: list = []           # [(name, ms)]

    def span(self, name: str, device: torch.device):
        return _Span(self, name, device)


class _Span:
    def __init__(self, trace: Trace, name: str, device: torch.device):
        self._trace, self._name, self._device = trace, name, device

    def __enter__(self):
        _sync(self._device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self._device)
        self._trace.spans.append(
            (self._name, (time.perf_counter() - self._t0) * 1e3))
        return False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class QueryServer:
    """Serves one single-device :class:`SinnamonIndex`.

    ``score_backend`` picks the scoring backend per server (``reference |
    grouped | fused``, or ``pallas`` for ``fused``; None -> the index
    default, then ``ops.resolve_backend``).  Results carry the canonical
    name, so ``pallas`` is labelled ``fused``.  ``score_fn`` (batch-native,
    e.g. ``ops.make_engine_score_fn()``: kernel C) overrides it; results
    are then labelled ``custom``, no batch runs the staged path and
    ``degrade >= 2`` does not answer sketch-only (it shrinks k' as
    ``degrade=1`` does).
    """

    def __init__(self, index: eng.SinnamonIndex, k: int = 10,
                 kprime: Optional[int] = 1000, budget: Optional[int] = None,
                 score_fn=None, score_backend: Optional[str] = None,
                 trace_every: int = 0):
        self.index = index
        self.k, self.kprime, self.budget = k, kprime, budget
        self.score_fn = score_fn
        self.score_backend = score_backend
        self.trace_every = int(trace_every)
        self.stats = {"queries": 0}
        self.last_latency_ms = 0.0
        self.last_trace: Optional[Trace] = None
        self._since_trace = 0
        self._latency = collections.deque(maxlen=LATENCY_WINDOW)

    def _backend_label(self) -> str:
        if self.score_fn is not None:
            return "custom"
        backend = self.score_backend
        if backend is None:
            backend = getattr(self.index, "default_backend", None)
        return _ops.resolve_backend(backend)

    # -- serving -------------------------------------------------------------
    def query(self, q_idx, q_val) -> QueryResult:
        """Serve one query: a :class:`QueryResult` with ``[k]`` ids/scores."""
        backend = self._backend_label()
        t0 = time.perf_counter()
        ids, scores = self.index.search(
            q_idx, q_val, k=self.k, kprime=self.kprime, budget=self.budget,
            score_fn=self.score_fn, backend=self.score_backend)
        self._record(1, (time.perf_counter() - t0) * 1e3)
        return QueryResult(ids=ids, scores=scores, k=len(ids),
                           backend=backend, trace_id=new_trace_id())

    def query_many(self, q_idx, q_val, degrade: int = 0) -> QueryResult:
        """Batched serving: [B, Lq] queries -> ``[B, k]`` result.

        Per-query latency is batch time / B.  ``degrade`` (the front door's
        ladder level): 1 shrinks the rerank candidate pool to k'/4; >= 2
        answers sketch-only (scores become upper bounds) unless a
        ``score_fn`` is set.  Degraded answers are stamped ``degraded=True``.
        """
        bn = len(q_idx)
        backend = self._backend_label()
        trace = None
        custom = self.score_fn is not None
        if self.trace_every > 0 and degrade == 0 and not custom:
            self._since_trace += 1
            if self._since_trace >= self.trace_every:
                self._since_trace = 0
                trace = Trace()
        t0 = time.perf_counter()
        if trace is not None:
            ids, scores = self._search_staged(q_idx, q_val, trace)
        elif degrade >= 2 and not custom:
            ids, scores = self.index.search_many_sketch(
                q_idx, q_val, k=self.k, budget=self.budget,
                backend=self.score_backend)
        else:
            kprime = self.kprime
            if degrade >= 1:
                if kprime is None:
                    kprime = max(5 * self.k, self.k)
                kprime = max(self.k, kprime // 4)
            ids, scores = self.index.search_many(
                q_idx, q_val, k=self.k, kprime=kprime, budget=self.budget,
                score_fn=self.score_fn, backend=self.score_backend)
        self._record(bn, (time.perf_counter() - t0) * 1e3)
        if trace is not None:
            self.last_trace = trace
        return QueryResult(ids=ids, scores=scores, k=ids.shape[-1],
                           backend=backend, trace_id=new_trace_id(),
                           degraded=degrade > 0)

    def _record(self, bn: int, dt_ms: float) -> None:
        per_query = dt_ms / bn
        self.stats["queries"] += bn
        self.last_latency_ms = per_query
        self._latency.extend([per_query] * min(bn, LATENCY_WINDOW))

    # -- staged (traced) path ------------------------------------------------
    def _search_staged(self, q_idx, q_val, trace: Trace):
        """The production search as separate synced steps, one span each;
        results equal ``index.search_many``'s (same operands, same kernels,
        same rerank)."""
        index = self.index
        dev = index.device
        backend = self._backend_label()
        with trace.span("admission", dev):
            spec, state = index.spec, index.state
            k, kprime = index._sizes(self.k, self.kprime)
            qi = index._tensor(q_idx, torch.int32)
            qv = index._tensor(q_val, torch.float32)
        if backend == "fused":
            with trace.span("sketch_scan", dev):
                tv, ts = _ops.sinnamon_tile_topk(state, spec, qi, qv, kprime,
                                                 budget=self.budget,
                                                 ok=state.active)
            with trace.span("topk_merge", dev):
                cand_scores, cand_slots = _sinn.merge_tile_topk(tv, ts,
                                                                kprime)
        else:
            with trace.span("sketch_scan", dev):
                s = eng.score_batch(state, spec, qi, qv, self.budget,
                                    grouped=backend == "grouped")
                s = torch.where(state.active[None, :], s, -torch.inf)
            with trace.span("topk_merge", dev):
                cand_scores, cand_slots = _sinn.topk_desc(s, kprime)
        with trace.span("rerank", dev):
            ids, scores, _ = eng.rerank_topk(state, cand_scores, cand_slots,
                                             qi, qv, k)
            out_ids, out_scores = ids.cpu().numpy(), scores.cpu().numpy()
        return out_ids, out_scores

    # -- stats ---------------------------------------------------------------
    def latency_percentiles(self) -> dict:
        """p50 / p90 / p99 per-query latency (ms) over the recent window.

        A batch's samples are its wall time / B (inverse throughput, as in
        ``repro.serving.serve``), not the time a request in it waits: that
        is the whole batch's wall time.
        """
        if not self._latency:
            return {}
        lat = np.fromiter(self._latency, np.float64)
        return {f"p{p}": float(np.percentile(lat, p)) for p in (50, 90, 99)}

    def reset_stats(self) -> None:
        self.stats["queries"] = 0
        self.last_trace = None
        self._latency.clear()
