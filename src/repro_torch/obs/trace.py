"""Span tracer and propagated per-request trace context.

Two levels of tracing live here:

* `Trace` — a flat list of named spans recorded with a context manager;
  the serving layer opens one per sampled query on the index's device, and
  on a CUDA device each span opens and closes with
  ``torch.cuda.synchronize(device)`` so device work is attributed to the
  stage that launched it (see `QueryServer._search_staged`); on the CPU,
  where torch runs eagerly, a span syncs nothing.
* `TraceContext` — the *propagated* per-request context: created
  at the front door (`ServingFrontend.submit`) or at `QueryServer.query*`,
  threaded through quota check → admission queue → batch assembly → device
  dispatch → response, accumulating per-stage wall-clock timestamps and
  annotations (which coalesced batch the request rode in, its outcome).
  Finished contexts go to the flight recorder (`repro_torch.obs.recorder`) so a
  ``QueryResult.trace_id`` resolves to a full stage breakdown at
  ``/debug/trace/<id>``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Optional

__all__ = ["Span", "Trace", "TraceContext", "new_trace_id"]

_trace_counter = itertools.count(1)
_trace_lock = threading.Lock()


def new_trace_id() -> str:
    """Process-unique, monotonically increasing query trace id."""
    with _trace_lock:
        n = next(_trace_counter)
    return f"q-{os.getpid():x}-{n:x}"


class Span:
    __slots__ = ("name", "ms")

    def __init__(self, name: str, ms: float):
        self.name = name
        self.ms = ms

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.ms:.3f}ms)"


def _sync(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch
        torch.cuda.synchronize(device)


class _SpanCtx:
    __slots__ = ("_trace", "_name", "_t0")

    def __init__(self, trace: "Trace", name: str):
        self._trace = trace
        self._name = name

    def __enter__(self):
        _sync(self._trace.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        _sync(self._trace.device)
        self._trace.spans.append(
            Span(self._name, (time.perf_counter() - self._t0) * 1e3)
        )
        return False


class Trace:
    """Named collection of timed spans for one operation.  With a CUDA
    ``device`` (a ``torch.device``) each span is device-synced."""

    __slots__ = ("name", "spans", "device")

    def __init__(self, name: str = "query", device=None):
        self.name = name
        self.spans: list[Span] = []
        self.device = device

    def span(self, name: str) -> _SpanCtx:
        """Context manager timing one stage; appends a `Span` on exit."""
        return _SpanCtx(self, name)

    def total_ms(self) -> float:
        return sum(s.ms for s in self.spans)

    def stage_ms(self) -> dict:
        return {s.name: s.ms for s in self.spans}

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "spans": [{"stage": s.name, "ms": round(s.ms, 4)} for s in self.spans],
        }


class _CtxSpan:
    __slots__ = ("_ctx", "_name", "_t0")

    def __init__(self, ctx: "TraceContext", name: str):
        self._ctx = ctx
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._ctx.add_stage(
            self._name, (time.perf_counter() - self._t0) * 1e3,
            start_ms=(self._t0 - self._ctx._t0) * 1e3)
        return False


class TraceContext:
    """One request's propagated trace: id, stage timings, annotations.

    Stages are ``(name, start_ms, dur_ms)`` with ``start_ms`` relative to
    context creation (``None`` for sub-spans imported from a staged
    `Trace`, which only carry durations).  A context is built up by exactly
    one thread at a time (submit thread, then the dispatcher) — the
    hand-off happens through the admission queue, so no locking is needed.

    The context is deliberately cheap to create and finish (a couple of
    ``perf_counter`` calls and list appends): every request gets one, and
    the *retention* decision is the flight recorder's, made at completion
    — tail sampling, not head sampling.
    """

    __slots__ = ("trace_id", "tenant", "ts", "_t0", "stages",
                 "annotations", "outcome", "error", "total_ms")

    def __init__(self, tenant: str = "default",
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id if trace_id is not None else new_trace_id()
        self.tenant = tenant
        self.ts = time.time()                # wall-clock anchor (unix)
        self._t0 = time.perf_counter()       # monotonic anchor
        self.stages: list = []               # [name, start_ms|None, dur_ms]
        self.annotations: dict = {}
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.total_ms: Optional[float] = None

    # -- recording -----------------------------------------------------------
    def stage(self, name: str) -> _CtxSpan:
        """Context manager timing one stage of this request."""
        return _CtxSpan(self, name)

    def add_stage(self, name: str, dur_ms: float,
                  start_ms: Optional[float] = None) -> None:
        """Record a stage timed externally (e.g. with the frontend's
        injectable clock); ``start_ms`` is relative to context creation."""
        self.stages.append((name, start_ms, float(dur_ms)))

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def annotate(self, **fields) -> None:
        """Attach key/value annotations (batch id, width bucket, ...)."""
        self.annotations.update(fields)

    def add_trace(self, trace: Trace, prefix: str = "") -> None:
        """Import a staged `Trace`'s spans as sub-stages (duration only)."""
        for s in trace.spans:
            self.stages.append((prefix + s.name, None, s.ms))

    def finish(self, outcome: str, total_ms: Optional[float] = None,
               error: Optional[str] = None) -> "TraceContext":
        """Seal the context: outcome + total latency.  ``total_ms`` defaults
        to the context's own elapsed wall clock."""
        self.outcome = outcome
        self.error = error
        self.total_ms = self.elapsed_ms() if total_ms is None \
            else float(total_ms)
        return self

    # -- reading -------------------------------------------------------------
    def stage_ms(self) -> dict:
        """{stage: dur_ms}; repeated stage names accumulate."""
        out: dict = {}
        for name, _start, dur in self.stages:
            out[name] = out.get(name, 0.0) + dur
        return out

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "ts": round(self.ts, 6),
            "outcome": self.outcome,
            "total_ms": None if self.total_ms is None
            else round(self.total_ms, 4),
            "stages": [
                {"stage": name,
                 **({} if start is None
                    else {"start_ms": round(start, 4)}),
                 "ms": round(dur, 4)}
                for name, start, dur in self.stages
            ],
        }
        if self.error is not None:
            d["error"] = self.error
        if self.annotations:
            d.update(self.annotations)
        return d

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, tenant={self.tenant!r}, "
                f"outcome={self.outcome!r}, stages={len(self.stages)})")
