"""Deterministic, seeded failpoint registry.

A *failpoint* is a named injection site compiled into a real error path:
the WAL append/fsync, the snapshot writer, the compactor's optimistic
swap, the VecStore restore read, the serving device dispatch.  Arming a
site makes the production code fail (or stall) exactly where a real
disk/device would, through exactly the handling the real fault would
take — no monkeypatching, no test-only forks of the logic.

Sites ship disabled and cost one dict lookup per pass-through (measured
by ``benchmarks/obs_overhead.py``'s ≤5% gate, which runs with failpoints
compiled in).  Arm them via the API::

    from repro_torch.fault import failpoints
    with failpoints.injected("wal.fsync=error:0.02", seed=7):
        ...

or via the environment (read once, at first use)::

    REPRO_FAILPOINTS="wal.fsync=error:0.02,device.dispatch=stall:250ms"
    REPRO_FAILPOINT_SEED=7

Spec grammar (comma-separated ``site=mode[:arg][:prob]``):

* ``error[:prob]`` / ``eio[:prob]`` — raise :class:`InjectedError`
  (an ``OSError`` with ``errno=EIO``) with probability ``prob``
  (default 1.0);
* ``enospc[:prob]`` — same with ``errno=ENOSPC`` (disk full: callers
  must NOT retry this one);
* ``torn[:frac][:prob]`` — the site writes only ``frac`` (default 0.5)
  of its bytes, then raises ``InjectedError(EIO)`` — a torn write;
* ``stall:<ms>ms[:prob]`` — sleep ``ms`` milliseconds, then continue
  (a slow/stuck device or disk).

Every fire increments ``repro_fault_injected_total{site,mode}`` and the
per-site hit counter (``hits()``), so a chaos schedule can assert its
faults actually landed.  Probability rolls come from one seeded
``random.Random`` — the same seed replays the same fault schedule.

The failpoint catalog (which sites exist and what they model) lives in
docs/robustness.md.
"""

from __future__ import annotations

import errno
import os
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from random import Random
from typing import Dict, Optional

from repro_torch.obs import metrics as obs_metrics

__all__ = [
    "Action",
    "FailpointRegistry",
    "InjectedError",
    "InjectedFault",
    "fire",
    "get_failpoints",
    "injected",
    "set_failpoints",
]

MODES = ("error", "eio", "enospc", "torn", "stall")

_STALL_RE = re.compile(r"^(\d+(?:\.\d+)?)ms$")


class InjectedFault(Exception):
    """Marker base so tests/chaos can tell injected faults from real ones."""


class InjectedError(InjectedFault, OSError):
    """An injected ``OSError`` — callers' real ``except OSError`` paths
    (WAL unwind, snapshot abort, compactor error counting) handle it
    exactly as they would the disk fault it models."""


@dataclass(frozen=True)
class Action:
    """What an armed site decided for this pass (returned by :func:`fire`
    for modes the site must interpret itself, e.g. ``torn``)."""

    site: str
    mode: str
    arg: float      # torn: fraction of bytes written; stall: milliseconds


@dataclass
class _Armed:
    mode: str
    arg: float
    prob: float
    count: Optional[int]     # remaining fires; None = unlimited


def _parse_one(site: str, rest: str) -> _Armed:
    parts = rest.split(":")
    mode = parts[0]
    if mode not in MODES:
        raise ValueError(f"failpoint {site!r}: unknown mode {mode!r} "
                         f"(expected one of {'/'.join(MODES)})")
    arg, prob = 0.0, 1.0
    tail = parts[1:]
    if mode == "stall":
        if not tail:
            raise ValueError(f"failpoint {site!r}: stall needs a duration, "
                             f"e.g. stall:250ms")
        m = _STALL_RE.match(tail[0])
        if not m:
            raise ValueError(f"failpoint {site!r}: bad stall duration "
                             f"{tail[0]!r} (expected e.g. 250ms)")
        arg, tail = float(m.group(1)), tail[1:]
    elif mode == "torn":
        arg = 0.5
        if tail and tail[0]:
            arg, tail = float(tail[0]), tail[1:]
            if not (0.0 <= arg < 1.0):
                raise ValueError(f"failpoint {site!r}: torn fraction must "
                                 f"be in [0, 1), got {arg}")
    if tail:
        prob = float(tail[0])
        if not (0.0 < prob <= 1.0):
            raise ValueError(f"failpoint {site!r}: probability must be in "
                             f"(0, 1], got {prob}")
        tail = tail[1:]
    if tail:
        raise ValueError(f"failpoint {site!r}: trailing spec parts {tail}")
    return _Armed(mode=mode, arg=arg, prob=prob, count=None)


class FailpointRegistry:
    """Armed failpoints + the seeded dice that decide each pass.

    Thread-safe: the WAL writer, the dispatcher and the compactor all
    pass through the same registry.  ``sleep`` is injectable so tests
    can fake stalls without wall-clock cost.
    """

    def __init__(self, seed: Optional[int] = None, registry=None,
                 sleep=time.sleep):
        self._sites: Dict[str, _Armed] = {}
        self._hits: Dict[str, int] = {}
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._registry = registry
        self._sleep = sleep

    # -- arming --------------------------------------------------------------
    def configure(self, spec: str) -> "FailpointRegistry":
        """Arm sites from the env-style spec string (see module docs)."""
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad failpoint spec {part!r} "
                                 f"(expected site=mode[:arg][:prob])")
            site, rest = part.split("=", 1)
            with self._lock:
                self._sites[site.strip()] = _parse_one(site.strip(), rest)
        return self

    def set(self, site: str, mode: str, *, arg: float = 0.0,
            prob: float = 1.0, count: Optional[int] = None) -> None:
        """Arm one site programmatically.  ``count`` limits how many times
        it fires before auto-disarming (handy for fire-exactly-once)."""
        if mode not in MODES:
            raise ValueError(f"unknown failpoint mode {mode!r}")
        with self._lock:
            self._sites[site] = _Armed(mode=mode, arg=float(arg),
                                       prob=float(prob), count=count)

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    @property
    def active(self) -> bool:
        return bool(self._sites)

    def sites(self) -> Dict[str, str]:
        """{site: "mode:arg:prob"} of currently armed sites (for logs)."""
        with self._lock:
            return {s: f"{a.mode}:{a.arg:g}:{a.prob:g}"
                    for s, a in self._sites.items()}

    def hits(self, site: str) -> int:
        """How many times ``site`` actually fired (post-probability)."""
        return self._hits.get(site, 0)

    # -- firing --------------------------------------------------------------
    def check(self, site: str) -> Optional[Action]:
        """Roll the dice for ``site``; count + return the Action if it
        fires.  Does NOT raise or sleep — see :meth:`fire`."""
        if not self._sites:
            return None
        with self._lock:
            armed = self._sites.get(site)
            if armed is None:
                return None
            if armed.prob < 1.0 and self._rng.random() >= armed.prob:
                return None
            if armed.count is not None:
                armed.count -= 1
                if armed.count <= 0:
                    del self._sites[site]
            self._hits[site] = self._hits.get(site, 0) + 1
        reg = self._registry if self._registry is not None \
            else obs_metrics.get_registry()
        reg.counter("repro_fault_injected_total",
                    "Failpoint fires by site and mode.",
                    labels={"site": site, "mode": armed.mode}).inc()
        return Action(site=site, mode=armed.mode, arg=armed.arg)

    def fire(self, site: str) -> Optional[Action]:
        """The call-site entry point: roll, then act.

        * error / eio  -> raises ``InjectedError(EIO)``
        * enospc       -> raises ``InjectedError(ENOSPC)``
        * stall        -> sleeps ``arg`` ms, returns the Action
        * torn         -> returns the Action (the site tears its own write)
        * not armed / dice miss -> returns None
        """
        act = self.check(site)
        if act is None:
            return None
        if act.mode in ("error", "eio"):
            raise InjectedError(errno.EIO, f"injected {act.mode} at {site}")
        if act.mode == "enospc":
            raise InjectedError(errno.ENOSPC, f"injected enospc at {site}")
        if act.mode == "stall":
            self._sleep(act.arg / 1e3)
        return act


# ---------------------------------------------------------------------------
# Process-global registry (env-armed, overridable in tests)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[FailpointRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_failpoints() -> FailpointRegistry:
    """The process-global registry, created (and armed from
    ``REPRO_FAILPOINTS`` / ``REPRO_FAILPOINT_SEED``) on first use."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                seed = os.environ.get("REPRO_FAILPOINT_SEED")
                reg = FailpointRegistry(
                    seed=int(seed) if seed is not None else None)
                reg.configure(os.environ.get("REPRO_FAILPOINTS", ""))
                _GLOBAL = reg
    return _GLOBAL


def set_failpoints(reg: Optional[FailpointRegistry]
                   ) -> Optional[FailpointRegistry]:
    """Swap the process-global registry (None = back to env-lazy).
    Returns the previous one."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, reg
    return prev


def fire(site: str) -> Optional[Action]:
    """Module-level :meth:`FailpointRegistry.fire` against the global
    registry.  The disabled-site fast path is one attribute read and one
    empty-dict check — cheap enough for per-dispatch serving code."""
    reg = _GLOBAL
    if reg is None:
        reg = get_failpoints()
    if not reg._sites:
        return None
    return reg.fire(site)


@contextmanager
def injected(spec: str, seed: int = 0, registry=None):
    """Scoped injection for tests: arm ``spec`` on a fresh seeded registry,
    make it the global one, restore the previous on exit."""
    reg = FailpointRegistry(seed=seed, registry=registry).configure(spec)
    prev = set_failpoints(reg)
    try:
        yield reg
    finally:
        set_failpoints(prev)
