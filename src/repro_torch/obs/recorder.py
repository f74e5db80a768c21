"""Tail-sampled flight recorder: a bounded in-memory ring of completed
request traces.

Retention is decided at request COMPLETION (tail sampling), when the
outcome and latency are known:

* every non-``ok`` request (error / deadline-exceeded / rejected) is
  retained — the requests an operator actually needs to explain;
* the slowest decile of recent OK requests is retained (the threshold is
  a running p90 over a sliding window of OK latencies);
* the rest are head-sampled at a configurable rate so the ring always
  holds a background of normal traffic to compare against.

Retained records spill to the JSONL event log (``request_trace`` events)
so they survive the ring; the ring itself backs the live debug surfaces
(``/debug/requests``, ``/debug/trace/<id>``, ``/debug/batches`` — see
`repro_torch.obs.server`).

A process-global recorder (installed by ``launch/serve.py``) mirrors the
event-log pattern: `get_recorder()` / `set_recorder()`; when none is
installed, recording is a cheap no-op at the call sites.
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import deque
from typing import Optional

from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import TraceContext

__all__ = ["FlightRecorder", "get_recorder", "set_recorder"]

_batch_counter = itertools.count(1)
_batch_lock = threading.Lock()


def new_batch_id() -> str:
    """Process-unique id for one coalesced dispatch."""
    with _batch_lock:
        n = next(_batch_counter)
    return f"b-{os.getpid():x}-{n:x}"


class FlightRecorder:
    """Bounded ring of finished request traces with tail-sampled retention.

    ``capacity`` bounds the request ring, ``batch_capacity`` the ring of
    coalesced-batch records.  ``sample_rate`` is the head-sampling fraction
    for fast OK requests (0 disables; 1.0 keeps everything).
    ``tail_fraction`` is the slowest fraction of OK traffic always kept
    (0.1 = slowest decile); the threshold is recomputed every 32 records
    over the last ``tail_window`` OK latencies and stays ``inf`` (no tail
    retention) until ``min_tail_samples`` latencies have been seen.

    ``spill=True`` emits every retained record as a ``request_trace``
    event to ``event_log`` (or the process-global log).
    """

    def __init__(self, capacity: int = 512, *, batch_capacity: int = 256,
                 sample_rate: float = 0.05, tail_fraction: float = 0.1,
                 tail_window: int = 512, min_tail_samples: int = 32,
                 registry=None, event_log=None, spill: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in [0, 1], "
                             f"got {sample_rate}")
        if not (0.0 < tail_fraction < 1.0):
            raise ValueError(f"tail_fraction must be in (0, 1), "
                             f"got {tail_fraction}")
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self.tail_fraction = float(tail_fraction)
        self.min_tail_samples = int(min_tail_samples)
        self.spill = bool(spill)
        self._every = round(1.0 / sample_rate) if sample_rate > 0 else 0
        self._registry = registry
        self._event_log = event_log
        self._lock = threading.Lock()
        self._ring: deque = deque()            # request record dicts
        self._by_id: dict = {}                 # trace_id -> record
        self._batches: deque = deque(maxlen=int(batch_capacity))
        self._batch_by_id: dict = {}
        self._ok_lat: deque = deque(maxlen=int(tail_window))
        self._tail_threshold_ms = float("inf")
        self._seen_ok = 0
        self.seen = 0

    # -- wiring --------------------------------------------------------------
    def _reg(self):
        return self._registry if self._registry is not None \
            else _metrics.get_registry()

    def _log(self):
        return self._event_log if self._event_log is not None \
            else _events.get_event_log()

    # -- recording -----------------------------------------------------------
    def record(self, ctx) -> Optional[str]:
        """Decide retention for a finished context (or record dict).

        Returns the retention reason (``"outcome"`` / ``"tail"`` /
        ``"sampled"``) when the record was kept, else ``None``.  The
        returned truthiness is what links *exemplars* to the ring: callers
        attach the trace_id as a histogram exemplar only when it resolves.
        """
        rec = ctx.to_dict() if isinstance(ctx, TraceContext) else dict(ctx)
        outcome = rec.get("outcome")
        total_ms = rec.get("total_ms")
        with self._lock:
            self.seen += 1
            reason = None
            if outcome != "ok":
                reason = "outcome"
            else:
                if total_ms is not None:
                    self._seen_ok += 1
                    self._ok_lat.append(float(total_ms))
                    if (self._seen_ok % 32 == 0
                            and len(self._ok_lat) >= self.min_tail_samples):
                        lat = sorted(self._ok_lat)
                        i = int(len(lat) * (1.0 - self.tail_fraction))
                        self._tail_threshold_ms = lat[min(i, len(lat) - 1)]
                    if float(total_ms) >= self._tail_threshold_ms:
                        reason = "tail"
                if (reason is None and self._every
                        and self.seen % self._every == 0):
                    reason = "sampled"
            if reason is None:
                self._reg().counter(
                    "repro_recorder_dropped_total",
                    "Completed requests not retained by the recorder.").inc()
                return None
            rec["retained"] = reason
            self._ring.append(rec)
            self._by_id[rec["trace_id"]] = rec
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                # only unmap if a newer record didn't reuse the id
                if self._by_id.get(old["trace_id"]) is old:
                    del self._by_id[old["trace_id"]]
        self._reg().counter(
            "repro_recorder_retained_total",
            "Request traces retained in the flight-recorder ring, by "
            "retention reason (outcome / tail / sampled).",
            labels={"reason": reason}).inc()
        if self.spill:
            log = self._log()
            if log is not None:
                level = "INFO" if outcome == "ok" else "WARN"
                log.emit("request_trace", level=level, **rec)
        return reason

    def record_batch(self, rec: dict) -> None:
        """Retain one coalesced-dispatch record (always kept; the batch
        ring is small and batches are ~max_batch× rarer than requests)."""
        rec = dict(rec)
        with self._lock:
            if len(self._batches) == self._batches.maxlen:
                old = self._batches[0]
                if self._batch_by_id.get(old.get("batch_id")) is old:
                    self._batch_by_id.pop(old.get("batch_id"), None)
            self._batches.append(rec)
            bid = rec.get("batch_id")
            if bid:
                self._batch_by_id[bid] = rec

    # -- reading -------------------------------------------------------------
    @property
    def tail_threshold_ms(self) -> float:
        return self._tail_threshold_ms

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            return self._by_id.get(trace_id)

    def get_batch(self, batch_id: str) -> Optional[dict]:
        with self._lock:
            return self._batch_by_id.get(batch_id)

    def recent(self, *, outcome: Optional[str] = None,
               tenant: Optional[str] = None,
               min_ms: Optional[float] = None,
               limit: int = 50) -> list:
        """Newest-first retained records, optionally filtered by outcome
        (prefix match, so ``rejected`` matches both rejection flavours),
        tenant, and minimum total latency."""
        out = []
        with self._lock:
            records = list(self._ring)
        for rec in reversed(records):
            if outcome is not None and \
                    not str(rec.get("outcome", "")).startswith(outcome):
                continue
            if tenant is not None and rec.get("tenant") != tenant:
                continue
            if min_ms is not None and \
                    (rec.get("total_ms") or 0.0) < float(min_ms):
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    def recent_batches(self, limit: int = 50) -> list:
        with self._lock:
            records = list(self._batches)
        return list(reversed(records))[:limit]

    def stats(self) -> dict:
        with self._lock:
            return {
                "seen": self.seen,
                "ring_size": len(self._ring),
                "capacity": self.capacity,
                "batches": len(self._batches),
                "tail_threshold_ms":
                    None if self._tail_threshold_ms == float("inf")
                    else round(self._tail_threshold_ms, 4),
                "sample_rate": self.sample_rate,
                "tail_fraction": self.tail_fraction,
            }


_global_recorder: Optional[FlightRecorder] = None
_global_lock = threading.Lock()


def get_recorder() -> Optional[FlightRecorder]:
    return _global_recorder


def set_recorder(recorder: Optional[FlightRecorder]) -> \
        Optional[FlightRecorder]:
    """Install the process-global flight recorder; returns the previous."""
    global _global_recorder
    with _global_lock:
        old = _global_recorder
        _global_recorder = recorder
    return old
