"""Fault injection and resilience primitives (counterpart of
``repro.fault``, with the same failpoint and metric names).

* :mod:`repro_torch.fault.failpoints` — deterministic seeded failpoints
  threaded through the real WAL / snapshot / compaction / serving
  error paths (armed via API or ``REPRO_FAILPOINTS``).
* :mod:`repro_torch.fault.retry` — retry with exponential backoff + jitter
  under a deadline budget, and a closed/open/half-open circuit breaker.
* :mod:`repro_torch.fault.degrade` — the serving degradation ladder
  (rerank-shrink → sketch-only → tenant shedding) with hysteresis.

See docs/robustness.md for the failpoint catalog and semantics.
"""

from repro_torch.fault.degrade import DegradationController, DegradeConfig
from repro_torch.fault.failpoints import (
    FailpointRegistry,
    InjectedError,
    InjectedFault,
    get_failpoints,
    injected,
    set_failpoints,
)
from repro_torch.fault.retry import (
    CircuitBreaker,
    CircuitOpen,
    RetryPolicy,
    call_with_retry,
    fsync_transient,
    transient_oserror,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpen",
    "DegradationController",
    "DegradeConfig",
    "FailpointRegistry",
    "InjectedError",
    "InjectedFault",
    "RetryPolicy",
    "call_with_retry",
    "fsync_transient",
    "get_failpoints",
    "injected",
    "set_failpoints",
    "transient_oserror",
]
