"""Retry-with-backoff and circuit breaking — the two recovery primitives.

:func:`call_with_retry` retries a callable with exponential backoff and
full jitter, **under a deadline budget**: the total time spent (work +
sleeps) never exceeds ``policy.deadline_s``, and a sleep that would blow
the budget is clamped or skipped.  Retries are observable via
``repro_fault_retries_total{op}``.

:class:`CircuitBreaker` is the classic closed → open → half-open state
machine: after ``failure_threshold`` consecutive failures the circuit
opens and ``allow()`` returns False (callers fast-fail) until
``reset_timeout_s`` elapses; then exactly one probe is let through
(half-open) and its outcome closes or re-opens the circuit.  A probe
whose outcome is never reported (the holder got wedged, or the probed
request was dropped before reaching the dependency) is reclaimed after
``probe_timeout_s`` so a lost probe cannot fast-fail everyone forever.
State is exported as ``repro_fault_breaker_state{name}`` (0=closed,
1=open, 2=half-open) and each trip counts in
``repro_fault_breaker_open_total{name}``.

Adopters in this repo: ``WalWriter`` retries interrupted fsyncs
(:func:`fsync_transient`: EINTR/EAGAIN only — an fsync EIO is fatal,
see the fsyncgate note there); ``BackgroundCompactor`` circuit-breaks
instead of hot-looping on persistent errors; ``ServingFrontend``
fast-fails submits while its dispatch breaker is open and consumes the
half-open probe at *dispatch* time, so an admission-rejected or
queue-expired request can never strand it.  Semantics are documented
in docs/robustness.md.
"""

from __future__ import annotations

import dataclasses
import errno
import threading
import time
from typing import Callable, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "CircuitBreaker",
    "CircuitOpen",
    "RetryPolicy",
    "call_with_retry",
    "fsync_transient",
    "transient_oserror",
]

#: errnos worth retrying: interruptions and (possibly) transient I/O.
#: ENOSPC is deliberately absent — a full disk does not heal on retry.
_TRANSIENT_ERRNOS = (errno.EINTR, errno.EAGAIN, errno.EIO)

#: errnos safe to retry at a durability barrier: pure interruptions only.
_FSYNC_TRANSIENT_ERRNOS = (errno.EINTR, errno.EAGAIN)


def transient_oserror(exc: BaseException) -> bool:
    """Default ``should_retry`` for filesystem ops: retry EINTR/EAGAIN/EIO,
    never ENOSPC or non-OSErrors."""
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def fsync_transient(exc: BaseException) -> bool:
    """``should_retry`` for fsync call sites: EINTR/EAGAIN only.

    EIO is deliberately NOT retried here (fsyncgate): on Linux a failed
    fsync clears the kernel error state and marks the dirty pages clean,
    so a retried fsync can report success without the bytes ever reaching
    the disk.  A durability barrier that fails with EIO must be treated
    as fatal for the write it was meant to persist.
    """
    return isinstance(exc, OSError) and exc.errno in _FSYNC_TRANSIENT_ERRNOS


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape and budget for :func:`call_with_retry`.

    ``attempts`` counts total calls (1 = no retries).  Delay before
    retry ``i`` (1-based) is drawn uniformly from
    ``[base * mult^(i-1) * (1-jitter), base * mult^(i-1)]``, capped at
    ``max_delay_s``, and further clamped so the whole operation stays
    inside ``deadline_s`` (None = no budget).
    """

    attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None

    def delay(self, attempt: int, rand: Callable[[], float]) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        return d * (1.0 - self.jitter * rand())


def call_with_retry(fn: Callable[[], object], *,
                    policy: RetryPolicy = RetryPolicy(),
                    should_retry: Callable[[BaseException], bool] =
                    transient_oserror,
                    op: str = "op",
                    clock: Callable[[], float] = time.monotonic,
                    sleep: Callable[[float], None] = time.sleep,
                    rand: Callable[[], float] = None,
                    registry=None) -> object:
    """Call ``fn`` with retries per ``policy``; return its result.

    Re-raises the last exception when attempts or the deadline budget
    run out, or immediately when ``should_retry`` says the failure is
    not transient.  Each retry (not the first attempt) increments
    ``repro_fault_retries_total{op}``.
    """
    if rand is None:
        import random
        rand = random.random
    start = clock()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - filtered by should_retry
            if attempt >= policy.attempts or not should_retry(e):
                raise
            remaining = (None if policy.deadline_s is None
                         else policy.deadline_s - (clock() - start))
            if remaining is not None and remaining <= 0:
                raise
            d = policy.delay(attempt, rand)
            if remaining is not None:
                d = min(d, remaining)
            reg = registry if registry is not None \
                else obs_metrics.get_registry()
            reg.counter("repro_fault_retries_total",
                        "Retries taken by operation.",
                        labels={"op": op}).inc()
            if d > 0:
                sleep(d)


class CircuitOpen(RuntimeError):
    """Raised (by callers that choose to) when a breaker is open."""

    def __init__(self, name: str, remaining_s: float):
        super().__init__(f"circuit {name!r} open for {remaining_s:.2f}s more")
        self.name = name
        self.remaining_s = remaining_s


_STATE_CODE = {"closed": 0.0, "open": 1.0, "half_open": 2.0}


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed/open/half-open).

    Thread-safe.  Usage::

        if not breaker.allow():
            fast_fail(breaker.remaining_s())
        try:
            do_work(); breaker.record_success()
        except Exception:
            breaker.record_failure(); raise
    """

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 probe_timeout_s: Optional[float] = None,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        # How long a half-open probe may stay unreported before its token
        # is reclaimed (a holder that dies without calling record_* must
        # not wedge the breaker).  Defaults to the reset timeout.
        self.probe_timeout_s = (self.reset_timeout_s if probe_timeout_s
                                is None else float(probe_timeout_s))
        self.name = name
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        self._failures = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._probing = False
        self._probe_started = 0.0
        self._publish()

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs_metrics.get_registry()

    def _publish(self):
        self._reg().gauge(
            "repro_fault_breaker_state",
            "Breaker state: 0=closed, 1=open, 2=half-open.",
            labels={"name": self.name}).set(_STATE_CODE[self._state])

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        if self._state == "open" and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._state = "half_open"
            self._probing = False
            self._publish()
        # Reclaim a stale probe: if the holder never reported an outcome
        # (wedged, crashed, or the probed request was dropped upstream),
        # the next caller gets a fresh probe instead of everyone
        # fast-failing forever.
        if self._state == "half_open" and self._probing and \
                self._clock() - self._probe_started >= self.probe_timeout_s:
            self._probing = False

    def allow(self) -> bool:
        """True if a call may proceed.  While half-open, exactly one
        caller gets True (the probe); others keep fast-failing."""
        with self._lock:
            self._maybe_half_open()
            if self._state == "closed":
                return True
            if self._state == "half_open" and not self._probing:
                self._probing = True
                self._probe_started = self._clock()
                return True
            return False

    def remaining_s(self) -> float:
        """Seconds until the next probe is allowed (0 when not open)."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0,
                       self.reset_timeout_s - (self._clock()
                                               - self._opened_at))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != "closed":
                self._state = "closed"
                self._publish()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            tripped = (self._state == "half_open"
                       or (self._state == "closed"
                           and self._failures >= self.failure_threshold))
            if tripped:
                self._state = "open"
                self._opened_at = self._clock()
                self._publish()
        if tripped:
            self._reg().counter(
                "repro_fault_breaker_open_total",
                "Times a circuit breaker tripped open.",
                labels={"name": self.name}).inc()

    def snapshot(self) -> Tuple[str, int]:
        """(state, consecutive_failures) — for health surfaces."""
        with self._lock:
            self._maybe_half_open()
            return self._state, self._failures
