"""Span tracer and propagated per-request trace context.

Two levels of tracing live here:

* `Trace` — a flat list of named spans recorded with a context manager,
  in one of two modes:

  - *synced* (the default): the serving layer opens one per sampled query
    on the index's device, and on a CUDA device each span opens and closes
    with ``torch.cuda.synchronize(device)`` so device work is attributed
    to the stage that launched it (see `QueryServer._search_staged`); on
    the CPU, where torch runs eagerly, a span syncs nothing.
  - *device-timed* (``device_timed=True``): nothing is synced.  Each span
    keeps its host start and its host duration (the time to issue its
    work); on a CUDA device a timing event recorded on the current stream
    at each span boundary (neighbouring spans share one) gives its device
    duration, read (never waited for) once the events have completed,
    when the trace is read.  The query path, the insert path and the
    kernel loads record one such trace per call; :meth:`Trace.finish`
    keeps it in a bounded per-operation ring that :func:`recent` reads.  While ``torch.profiler`` records, each span
    also opens the range ``repro.<op>.<span>``, so the stages sit on the
    profiler's clock beside the kernels.
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

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["RING", "Span", "Trace", "TraceContext", "clear", "new_trace_id",
           "profiler_range", "recent", "span"]

_trace_counter = itertools.count(1)
_trace_lock = threading.Lock()


def new_trace_id() -> str:
    """Process-unique, monotonically increasing query trace id."""
    with _trace_lock:
        n = next(_trace_counter)
    return f"q-{os.getpid():x}-{n:x}"


class Span:
    """One stage of a `Trace`: its host duration ``ms``, its host start
    ``start_ms`` (from the trace's start) and, on a device-timed trace on
    a CUDA device, its device duration ``device_ms`` (None until the
    stage's events have completed, and on the CPU)."""

    __slots__ = ("name", "ms", "start_ms", "device_ms", "_ev")

    def __init__(self, name: str, ms: float,
                 start_ms: Optional[float] = None,
                 device_ms: Optional[float] = None, _ev=None):
        self.name = name
        self.ms = ms
        self.start_ms = start_ms
        self.device_ms = device_ms
        self._ev = _ev              # (start, end) timing events, until read

    def __repr__(self) -> str:
        dev = "" if self.device_ms is None else f", device {self.device_ms:.3f}ms"
        return f"Span({self.name!r}, {self.ms:.3f}ms{dev})"


def _sync(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _profiling() -> bool:
    """True while ``torch.profiler`` records (one flag read; False when
    torch is not loaded)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


def profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else a no-op context."""
    if _profiling():
        import torch
        return torch.profiler.record_function(name)
    return _NOSPAN


_NOSPAN = contextlib.nullcontext()


def span(trace: Optional["Trace"], name: str):
    """``trace.span(name)``, or a no-op context without a trace."""
    return _NOSPAN if trace is None else trace.span(name)


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
        t1 = time.perf_counter()
        self._trace.spans.append(
            Span(self._name, (t1 - self._t0) * 1e3,
                 start_ms=(self._t0 - self._trace.t0) * 1e3))
        return False


class _TimedSpanCtx:
    """A span of a device-timed trace: no sync; a timing event at each
    boundary on a CUDA device."""

    __slots__ = ("_trace", "_name", "_t0", "_range")

    def __init__(self, trace: "Trace", name: str):
        self._trace = trace
        self._name = name
        self._range = None

    def __enter__(self):
        tr = self._trace
        if _profiling():
            self._range = profiler_range(f"repro.{tr.name}.{self._name}")
            self._range.__enter__()
        if tr._stream is not None and tr._last is None:
            tr._last = tr._record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._trace
        ev0 = tr._last
        if ev0 is not None:
            tr._last = tr._record()
        t1 = time.perf_counter()
        tr.spans.append(Span(self._name, (t1 - self._t0) * 1e3,
                             (self._t0 - tr.t0) * 1e3, None,
                             None if ev0 is None else (ev0, tr._last)))
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


# -- timing events: a small pool per CUDA device --------------------------------

#: Events kept for reuse per device; more than this are let go once read.
POOL = 1024

_EVENTS: dict = {}
_STREAMS: dict = {}


def _current_stream(index: int):
    """The current stream of CUDA device ``index``: ``torch.cuda.current_stream``
    builds a new ``Stream`` object at every call, so the objects are kept by
    the stream's key and only the key is read."""
    import torch
    key = torch._C._cuda_getCurrentStream(index)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(index)
    return stream


_READ: dict = {}


def _read_stream(index: int):
    """A stream of device ``index`` for reading a trace's counters: a copy
    on it waits for no work queued on the streams that serve queries."""
    stream = _READ.get(index)
    if stream is None:
        import torch
        stream = _READ[index] = torch.cuda.Stream(index)
    return stream


def _take_event(index: int):
    pool = _EVENTS.get(index)
    if pool:
        return pool.pop()
    import torch
    return torch.cuda.Event(enable_timing=True)


class Trace:
    """Named collection of timed spans for one operation.

    Synced (the default): with a CUDA ``device`` (a ``torch.device``) each
    span is device-synced.  Device-timed (``device_timed=True``): no span
    syncs; on a CUDA device each span also gets a device duration from
    timing events on the device's current stream, where a span opens at
    the previous span's closing event, so device work queued between two
    spans counts to the later one (spans of such a trace do not nest).
    The durations are read once the trace's last event has completed,
    when :func:`recent` or a `TraceContext` that imported the trace is
    read, never on the traced call.  ``trace_id`` links the trace to a
    request's `TraceContext`.  Beside its spans a trace keeps integer
    ``counters`` ({name: int}, see :meth:`count`), read at the same time.
    """

    __slots__ = ("name", "spans", "counters", "device", "device_timed", "t0",
                 "trace_id", "_stream", "_index", "_last", "_events",
                 "_pending")

    def __init__(self, name: str = "query", device=None, *,
                 device_timed: bool = False, trace_id: Optional[str] = None):
        self.name = name
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.device = device
        self.device_timed = device_timed
        self.t0 = time.perf_counter()
        self.trace_id = trace_id
        self._stream = None
        self._last = None           # the last boundary's event
        self._events: list = []     # every event recorded, to give back
        self._pending: list = []    # (names, counts tensor) until read
        if device_timed and getattr(device, "type", None) == "cuda":
            import torch
            self._index = device.index if device.index is not None \
                else torch.cuda.current_device()
            self._stream = _current_stream(self._index)

    def span(self, name: str):
        """Context manager timing one stage; appends a `Span` on exit."""
        if self.device_timed:
            return _TimedSpanCtx(self, name)
        return _SpanCtx(self, name)

    def count(self, names, values) -> None:
        """Add the integer tensor ``values`` (one entry a name) to the
        counters ``names``, read into :attr:`counters` when the trace is
        (repeated names accumulate).  A synced trace reads them now.  A
        device-timed trace keeps the tensor where it is and reads nothing
        here; call this inside a span, whose closing event follows the
        work that computes ``values``.  :func:`recent` reads them once the
        trace's last event has completed, a CUDA tensor through a copy on
        a stream of its own, which waits for nothing queued since."""
        if self.device_timed:
            self._pending.append((tuple(names), values))
        else:
            self._add(names, values)

    def _record(self):
        """A timing event recorded now on the trace's stream."""
        ev = _take_event(self._index)
        ev.record(self._stream)
        self._events.append(ev)
        return ev

    def _resolve(self) -> bool:
        """Read every device duration and counter if the trace's last event
        has completed (the stream runs its work in order), and give the
        events back to the pool; True when nothing is left to read.  Never
        waits."""
        if self._events:
            if not self._events[-1].query():
                return False
            for s in self.spans:
                if s._ev is not None:
                    ev0, ev1 = s._ev
                    s.device_ms = ev0.elapsed_time(ev1)
                    s._ev = None
            pool = _EVENTS.setdefault(self._index, [])
            pool.extend(self._events[:max(0, POOL - len(pool))])
            self._events = []
            self._last = None
        for names, values in self._pending:
            self._add(names, values)
        self._pending = []
        return True

    def _add(self, names, values) -> None:
        """Add counts to :attr:`counters`.  A device-timed trace's events
        have completed, so its CUDA counts are computed and are read on
        the ring's own stream, behind nothing queued since; a synced trace
        reads on the current stream, behind the work that computes them."""
        if values.device.type == "cuda" and self.device_timed:
            import torch
            with torch.cuda.stream(_read_stream(values.device.index)):
                values = values.cpu()
        for name, v in zip(names, values.tolist()):
            self.counters[name] = self.counters.get(name, 0) + v

    def finish(self) -> "Trace":
        """Seal a device-timed trace and keep it in the ring of its
        operation (see :func:`recent`); reads nothing."""
        with _ring_lock:
            ring = _rings.get(self.name)
            if ring is None:
                ring = _rings[self.name] = (deque(maxlen=RING),
                                            deque(maxlen=RING))
            ring[0].append(self)
            if self._events or self._pending:
                ring[1].append(self)
        return self

    def total_ms(self) -> float:
        return sum(s.ms for s in self.spans)

    def stage_ms(self) -> dict:
        """{stage: host ms}; repeated stage names accumulate."""
        out: dict = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.ms
        return out

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "spans": [{"stage": s.name, "ms": round(s.ms, 4)} for s in self.spans],
        }


# -- the ring of finished device-timed traces ---------------------------------------

#: Traces kept per operation name (``query``, ``insert_many``, ...).
RING = 8192

_rings: dict = {}               # op -> (kept traces, kept traces left to read)
_ring_lock = threading.Lock()


def recent(op: str) -> list:
    """The kept traces of operation ``op``, oldest first (at most
    :data:`RING`), with the device durations and counters read of every
    trace whose events have completed."""
    with _ring_lock:
        ring = _rings.get(op)
        if ring is None:
            return []
        kept, unread = ring
        for _ in range(len(unread)):
            tr = unread.popleft()
            if not tr._resolve():
                unread.append(tr)
        return list(kept)


def clear() -> None:
    """Drop every kept trace."""
    with _ring_lock:
        _rings.clear()


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
    context creation (``None`` where a stage was timed without a start).
    Sub-spans imported from a `Trace` keep their host starts and, from a
    device-timed trace, their device durations, read when the context is
    (:meth:`to_dict`) once the trace's events have completed.  A context is
    built up by exactly
    one thread at a time (submit thread, then the dispatcher) — the
    hand-off happens through the admission queue, so no locking is needed.

    The context is deliberately cheap to create and finish (a couple of
    ``perf_counter`` calls and list appends): every request gets one, and
    the *retention* decision is the flight recorder's, made at completion
    — tail sampling, not head sampling.
    """

    __slots__ = ("trace_id", "tenant", "ts", "_t0", "stages",
                 "annotations", "outcome", "error", "total_ms", "_spans",
                 "_traces")

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
        self._spans: dict = {}               # stage index -> timed Span
        self._traces: list = []              # device-timed traces imported

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
        """Import a `Trace`'s spans as sub-stages, with their host starts
        (and a device-timed trace's device durations, once read)."""
        base = (trace.t0 - self._t0) * 1e3
        if trace.device_timed:
            self._traces.append(trace)
        for s in trace.spans:
            if trace.device_timed:
                self._spans[len(self.stages)] = s
            self.stages.append((prefix + s.name,
                                None if s.start_ms is None
                                else base + s.start_ms, s.ms))

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
        if self._traces:
            with _ring_lock:
                for tr in self._traces:
                    tr._resolve()
        d = {
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "ts": round(self.ts, 6),
            "outcome": self.outcome,
            "total_ms": None if self.total_ms is None
            else round(self.total_ms, 4),
            "stages": [self._stage_dict(i, *st)
                       for i, st in enumerate(self.stages)],
        }
        if self.error is not None:
            d["error"] = self.error
        if self.annotations:
            d.update(self.annotations)
        return d

    def _stage_dict(self, i: int, name: str, start, dur: float) -> dict:
        d = {"stage": name}
        if start is not None:
            d["start_ms"] = round(start, 4)
        d["ms"] = round(dur, 4)
        span = self._spans.get(i)
        if span is not None and span.device_ms is not None:
            d["device_ms"] = round(span.device_ms, 4)
        return d

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, tenant={self.tenant!r}, "
                f"outcome={self.outcome!r}, stages={len(self.stages)})")
