"""Host-side query serving over one index (counterpart of
``repro.serving.serve``).

``QueryServer.query`` / ``query_many`` return a :class:`QueryResult`.
Every query reports into a metrics registry (``repro_torch.obs``, the
reference's metric names): latency and batch histograms per scoring
backend and a query counter, plus — on sampled batches (``trace_every``)
— a per-stage span breakdown (admission → sketch scan → top-k merge →
rerank) recorded by running the same math as separate steps, each span
closed with ``torch.cuda.synchronize()`` on the card; the breakdown is
left on ``last_trace``.  Each request gets a propagated
:class:`~repro_torch.obs.trace.TraceContext` that a flight recorder can
retain, and the ``device.dispatch`` / ``device.rerank`` failpoints sit
where the reference has them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core import engine as eng
from repro_torch.fault import failpoints as _fp
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import sinnamon_score as _sinn
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs.instrument import install_engine_gauges
from repro_torch.obs.trace import Trace, TraceContext
from repro_torch.serving.results import QueryResult

#: Stage names of the staged (traced) query path, in order.
QUERY_STAGES = ("admission", "sketch_scan", "topk_merge", "rerank")


class QueryServer:
    """Serves one single-device :class:`SinnamonIndex` (durable or not).

    ``score_backend`` picks the scoring backend per server (``reference |
    grouped | fused``, or ``pallas`` for ``fused``; None -> the index
    default, then ``ops.resolve_backend``).  Results carry the canonical
    name, so ``pallas`` is labelled ``fused``.  ``score_fn`` (batch-native,
    e.g. ``ops.make_engine_score_fn()``: kernel C) overrides it; results
    are then labelled ``custom``, no batch runs the staged path and
    ``degrade >= 2`` does not answer sketch-only (it shrinks k' as
    ``degrade=1`` does).

    Telemetry as in the reference: ``registry`` (default: the process-global
    ``repro_torch.obs.metrics.get_registry()``; ``NULL_REGISTRY`` turns
    metrics off), ``event_log`` (default: the process-global one, if set),
    ``recorder`` (a flight recorder; default: the process-global one) and
    ``index_name`` (the label of the engine health gauges installed for
    ``index``).  A durable index keeps serving during snapshots and
    background compaction: searches take only the index's state lock, to
    read, so searches from several threads run side by side.
    """

    def __init__(self, index: eng.SinnamonIndex, k: int = 10,
                 kprime: Optional[int] = 1000, budget: Optional[int] = None,
                 score_fn=None, score_backend: Optional[str] = None,
                 registry=None, event_log=None, trace_every: int = 0,
                 index_name: str = "index", recorder=None):
        self.index = index
        self.k, self.kprime, self.budget = k, kprime, budget
        self.score_fn = score_fn
        self.score_backend = score_backend
        self.registry = (obs_metrics.get_registry() if registry is None
                         else registry)
        self.event_log = event_log
        self.recorder = recorder
        self.trace_every = int(trace_every)
        self.stats = {"queries": 0}
        self.last_latency_ms = 0.0
        self.last_trace: Optional[Trace] = None
        self._since_trace = 0
        self._handles: dict = {}
        install_engine_gauges(index, self.registry, name=index_name)

    def _backend_label(self) -> str:
        if self.score_fn is not None:
            return "custom"
        backend = self.score_backend
        if backend is None:
            backend = getattr(self.index, "default_backend", None)
        return _ops.resolve_backend(backend)

    # -- metric handles (cached per label set) -------------------------------
    def _hist(self, name: str, help_text: str, labels=None, buckets=None):
        key = (name, tuple(sorted((labels or {}).items())))
        h = self._handles.get(key)
        if h is None:
            h = self.registry.histogram(name, help_text, labels=labels,
                                        buckets=buckets)
            self._handles[key] = h
        return h

    def _latency_hist(self, backend: str):
        return self._hist("repro_query_latency_ms",
                          "Per-query serving latency.",
                          labels={"backend": backend})

    def _recorder(self):
        return self.recorder if self.recorder is not None \
            else obs_recorder.get_recorder()

    def _fail(self, ctx: TraceContext, owns: bool, e: BaseException) -> None:
        """Seal + record an errored context this server owns."""
        if not owns:
            return      # the front door owns the context's lifecycle
        ctx.finish("error", error=repr(e))
        rec = self._recorder()
        if rec is not None:
            rec.record(ctx)

    # -- serving -------------------------------------------------------------
    def query(self, q_idx, q_val, ctx: Optional[TraceContext] = None) \
            -> QueryResult:
        """Serve one query: a :class:`QueryResult` with ``[k]`` ids/scores.

        ``ctx`` is an optional propagated :class:`TraceContext`; without
        one the server opens (and records) its own."""
        backend = self._backend_label()
        owns = ctx is None
        if owns:
            ctx = TraceContext()
        try:
            with ctx.stage("device"):
                t0 = time.perf_counter()
                _fp.fire("device.dispatch")
                ids, scores = self.index.search(
                    q_idx, q_val, k=self.k, kprime=self.kprime,
                    budget=self.budget, score_fn=self.score_fn,
                    backend=self.score_backend)
                dt_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            self._fail(ctx, owns, e)
            raise
        self._record(1, dt_ms, backend, ctx=ctx, owns=owns)
        return QueryResult(ids=ids, scores=scores, k=len(ids),
                           backend=backend, trace_id=ctx.trace_id)

    def query_many(self, q_idx, q_val, ctx: Optional[TraceContext] = None,
                   degrade: int = 0) -> QueryResult:
        """Batched serving: [B, Lq] queries -> ``[B, k]`` result.

        Per-query latency is batch time / B.  ``degrade`` (the front door's
        ladder level): 1 shrinks the rerank candidate pool to k'/4; >= 2
        answers sketch-only (scores become upper bounds) unless a
        ``score_fn`` is set.  Degraded answers are stamped ``degraded=True``
        and annotated on the trace context.  With a caller's ``ctx`` the
        server only annotates it; without one it owns the context.
        """
        bn = len(q_idx)
        backend = self._backend_label()
        owns = ctx is None
        if owns:
            ctx = TraceContext()
        trace = None
        custom = self.score_fn is not None
        if self.trace_every > 0 and degrade == 0 and not custom:
            self._since_trace += 1
            if self._since_trace >= self.trace_every:
                self._since_trace = 0
                trace = Trace(device=self.index.device)
        sketch_only = degrade >= 2 and not custom
        try:
            with ctx.stage("device"):
                t0 = time.perf_counter()
                _fp.fire("device.dispatch")
                if trace is not None:
                    ids, scores = self._search_staged(q_idx, q_val, trace)
                elif sketch_only:
                    ids, scores = self.index.search_many_sketch(
                        q_idx, q_val, k=self.k, budget=self.budget,
                        backend=self.score_backend)
                else:
                    kprime = self.kprime
                    if degrade >= 1:
                        if kprime is None:
                            kprime = max(5 * self.k, self.k)
                        kprime = max(self.k, kprime // 4)
                    # Rerank-bearing paths only: a stalled/broken rerank
                    # is exactly what sketch-only degradation sidesteps.
                    _fp.fire("device.rerank")
                    ids, scores = self.index.search_many(
                        q_idx, q_val, k=self.k, kprime=kprime,
                        budget=self.budget, score_fn=self.score_fn,
                        backend=self.score_backend)
                dt_ms = (time.perf_counter() - t0) * 1e3
        except Exception as e:
            self._fail(ctx, owns, e)
            raise
        if degrade > 0:
            ctx.annotate(degraded=True, degrade_level=int(degrade),
                         sketch_only=sketch_only)
        self._record(bn, dt_ms, backend, trace, ctx=ctx, owns=owns)
        return QueryResult(ids=ids, scores=scores, k=ids.shape[-1],
                           backend=backend, trace_id=ctx.trace_id,
                           degraded=degrade > 0)

    def _record(self, bn: int, dt_ms: float, backend: str,
                trace: Optional[Trace] = None,
                ctx: Optional[TraceContext] = None,
                owns: bool = False) -> None:
        per_query = dt_ms / bn
        self.stats["queries"] += bn
        self.last_latency_ms = per_query
        retained = None
        if ctx is not None:
            ctx.annotate(backend=backend, batch=bn)
            if trace is not None:
                ctx.add_trace(trace, prefix="device/")
            if owns:
                ctx.finish("ok", total_ms=dt_ms)
                rec = self._recorder()
                if rec is not None:
                    retained = rec.record(ctx)
        # exemplar only when the id actually resolves in the recorder ring
        self._latency_hist(backend).observe(
            per_query, n=bn,
            exemplar=ctx.trace_id if (ctx is not None and retained) else None)
        self._hist("repro_query_batch_docs", "Queries per serving batch.",
                   buckets=obs_metrics.DEFAULT_COUNT_BUCKETS).observe(bn)
        self.registry.counter("repro_queries_total", "Queries served.",
                              labels={"backend": backend}).inc(bn)
        if trace is not None:
            self.last_trace = trace
            self.registry.counter("repro_query_traces_total",
                                  "Sampled queries run on the staged "
                                  "(per-stage timed) path.").inc()
            for span in trace.spans:
                self._hist("repro_query_stage_ms",
                           "Wall time per query-path stage (sampled "
                           "staged dispatches, device-synced per span).",
                           labels={"stage": span.name,
                                   "backend": backend}).observe(span.ms)
        log = self.event_log if self.event_log is not None \
            else obs_events.get_event_log()
        if log is not None:
            log.emit("query", batch=bn, ms=round(dt_ms, 4), backend=backend,
                     trace_id=ctx.trace_id if ctx is not None else None,
                     spans=trace.as_dict()["spans"] if trace else None)

    # -- staged (traced) path ------------------------------------------------
    def _search_staged(self, q_idx, q_val, trace: Trace):
        """The production search as separate synced steps, one span each;
        results equal ``index.search_many``'s (same operands, same kernels,
        same rerank)."""
        index = self.index
        backend = self._backend_label()
        with index._state_lock.read():
            with trace.span("admission"):
                spec, state = index.spec, index.state
                k, kprime = index._sizes(self.k, self.kprime)
                qi = index._tensor(q_idx, torch.int32)
                qv = index._tensor(q_val, torch.float32)
            if backend == "fused":
                with trace.span("sketch_scan"):
                    tv, ts = _ops.sinnamon_tile_topk(state, spec, qi, qv,
                                                     kprime,
                                                     budget=self.budget,
                                                     ok=state.active)
                with trace.span("topk_merge"):
                    cand_scores, cand_slots = _sinn.merge_tile_topk(tv, ts,
                                                                    kprime)
            else:
                with trace.span("sketch_scan"):
                    s = eng.score_batch(state, spec, qi, qv, self.budget,
                                        grouped=backend == "grouped")
                    s = torch.where(state.active[None, :], s, -torch.inf)
                with trace.span("topk_merge"):
                    cand_scores, cand_slots = _sinn.topk_desc(s, kprime)
            with trace.span("rerank"):
                ids, scores, _ = eng.rerank_topk(state, cand_scores,
                                                 cand_slots, qi, qv, k)
                out_ids, out_scores = ids.cpu().numpy(), scores.cpu().numpy()
        return out_ids, out_scores

    # -- stats ---------------------------------------------------------------
    def latency_percentiles(self) -> dict:
        """p50 / p90 / p99 per-query latency (ms) from the registry's
        ``repro_query_latency_ms`` histogram (the one shared percentile
        implementation, ``obs.metrics.Histogram.percentile``).

        A batch's samples are its wall time / B (inverse throughput, as in
        ``repro.serving.serve``), not the time a request in it waits: that
        is the whole batch's wall time.
        """
        h = self._latency_hist(self._backend_label())
        if h.count == 0:
            return {}
        return {f"p{p}": h.percentile(p) for p in (50, 90, 99)}

    def reset_stats(self) -> None:
        """Zero the query counter and this server's latency/stage samples
        (shared-registry histograms for the current backend label)."""
        backend = self._backend_label()
        self.stats["queries"] = 0
        self.last_trace = None
        self._latency_hist(backend).reset()
        for stage in QUERY_STAGES:
            self._hist("repro_query_stage_ms", "",
                       labels={"stage": stage, "backend": backend}).reset()
