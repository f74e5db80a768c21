"""Sketch-drift metrics and compaction policy.

Counterpart of ``repro.persist.compact``.  The paper's §4.3 deletion
leaves recycled sketch columns carrying stale maxima (see
repro_torch.core.engine: merge-on-recycle insert), so the Theorem 5.1
upper bound stays *valid* but grows *loose* under churn — candidate
generation quality silently degrades.  This module measures that drift
against a freshly encoded sketch and decides when to pay for a rebuild:

* :func:`drift_metrics`  — mean/max per-slot overestimate + dirty counts,
  for the single-device index, durable or not.
  Every call also publishes the values as ``repro_sketch_drift_*`` gauges.
* :func:`maybe_compact`  — threshold policy: compact iff max drift exceeds.
* :class:`BackgroundCompactor` — a daemon thread that polls drift and
  compacts optimistically (a mutation-counter check at the write-in, via
  ``DurableSinnamonIndex.try_compact_async``), so serving never blocks.  Outcomes
  (compactions / skipped races / errors) are published as counters, and a
  nonzero post-compaction drift raises a WARN event.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from repro_torch.fault.retry import CircuitBreaker
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics


def drift_metrics(index, registry=None) -> dict:
    """Drift of the live sketch vs. a fresh one.  All values are host floats.

    mean/max are over ACTIVE slots (inactive columns never contribute to a
    search).  ``dirty_active`` counts recycled columns — the only place
    drift can live; ``dirty_total`` additionally counts deleted-not-yet-
    recycled columns (zeroed by the next compaction).

    The values are also published to ``registry`` (default: the
    process-global one) as gauges, so a scrape always reflects the most
    recent drift scan.
    """
    # A concurrent grow() can swap state between reads; retry until the
    # drift vector and the state snapshot agree on capacity.
    for _ in range(5):
        per_slot = index.slot_drift()                    # f32[C]
        state = index.state
        if per_slot.shape[0] == state.active.shape[0]:
            break
    else:
        raise RuntimeError("index capacity kept changing during drift scan")
    active = state.active.cpu().numpy()
    dirty = state.dirty.cpu().numpy()
    act = per_slot[active] if active.any() else np.zeros((0,), np.float32)
    out = {
        "mean_overestimate": float(act.mean()) if act.size else 0.0,
        "max_overestimate": float(act.max()) if act.size else 0.0,
        "dirty_active": int((dirty & active).sum()),
        "dirty_total": int(dirty.sum()),
        "active": int(active.sum()),
    }
    reg = registry if registry is not None else obs_metrics.get_registry()
    reg.gauge("repro_sketch_drift_mean",
              "Mean per-slot sketch overestimate vs. fresh (active slots)."
              ).set(out["mean_overestimate"])
    reg.gauge("repro_sketch_drift_max",
              "Max per-slot sketch overestimate vs. fresh (active slots)."
              ).set(out["max_overestimate"])
    reg.gauge("repro_sketch_dirty_active_slots",
              "Recycled (dirty & active) columns — where drift lives."
              ).set(out["dirty_active"])
    reg.gauge("repro_sketch_dirty_total_slots",
              "All dirty columns, incl. deleted-not-yet-recycled."
              ).set(out["dirty_total"])
    return out


def _publish_compaction(registry, before: dict, after: dict,
                        dt_ms: float, source: str) -> None:
    """Before/after drift gauges + WARN when residual drift survives."""
    registry.gauge("repro_compaction_drift_before",
                   "Max overestimate just before the last compaction."
                   ).set(before["max_overestimate"])
    registry.gauge("repro_compaction_drift_after",
                   "Max overestimate just after the last compaction."
                   ).set(after["max_overestimate"])
    registry.histogram("repro_compaction_ms",
                       "Wall time of one sketch compaction.").observe(dt_ms)
    if after["max_overestimate"] > 0:
        # Zero is the invariant a quiesced compaction restores; residue
        # means mutations raced the rebuild (benign churn) or the rebuild
        # itself is wrong — either way worth surfacing.
        registry.counter("repro_compaction_residual_drift_total",
                         "Compactions that left nonzero drift behind.").inc()
        obs_events.emit("compaction_residual_drift", level="WARN",
                        source=source,
                        drift_before=round(before["max_overestimate"], 6),
                        drift_after=round(after["max_overestimate"], 6))
    obs_events.emit("compaction", source=source, ms=round(dt_ms, 3),
                    drift_before=round(before["max_overestimate"], 6),
                    drift_after=round(after["max_overestimate"], 6),
                    dirty_active=before["dirty_active"])


def maybe_compact(index, threshold: float, registry=None) -> Optional[dict]:
    """Compact iff the max per-slot overestimate exceeds ``threshold``.

    Returns the pre-compaction metrics dict when compaction ran, else None.
    """
    reg = registry if registry is not None else obs_metrics.get_registry()
    metrics = drift_metrics(index, reg)
    if metrics["max_overestimate"] > threshold:
        t0 = time.perf_counter()
        index.compact()
        dt_ms = (time.perf_counter() - t0) * 1e3
        after = drift_metrics(index, reg)
        _publish_compaction(reg, metrics, after, dt_ms, source="maybe_compact")
        return metrics
    return None


class BackgroundCompactor:
    """Daemon thread: poll drift every ``interval_s``, compact when above
    ``threshold``.  Requires a durable index (``try_compact_async``) so the
    rebuild happens off the serving path and the WAL stays consistent.

    Persistent failures trip a circuit breaker (``breaker_failures``
    consecutive errors → skip ticks for ``breaker_reset_s``, then probe
    once) so a wedged rebuild path degrades to periodic probes instead of
    hot-looping error spam while drift monitoring keeps running."""

    def __init__(self, index, threshold: float, interval_s: float = 1.0,
                 registry=None, breaker_failures: int = 5,
                 breaker_reset_s: float = 30.0):
        self.index = index
        self.threshold = threshold
        self.interval_s = interval_s
        self.registry = (registry if registry is not None
                         else obs_metrics.get_registry())
        self.compactions = 0
        self.skipped_races = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        self.breaker = CircuitBreaker(failure_threshold=breaker_failures,
                                      reset_timeout_s=breaker_reset_s,
                                      name="compactor",
                                      registry=self.registry)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _outcome(self, outcome: str):
        return self.registry.counter(
            "repro_compactor_outcomes_total",
            "Background compactor ticks by outcome "
            "(compacted | skipped_race | error | breaker_open).",
            labels={"outcome": outcome})

    def start(self) -> "BackgroundCompactor":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not self.breaker.allow():
                self._outcome("breaker_open").inc()
                continue
            # The daemon must survive transient races (e.g. a grow swapping
            # state mid-scan): record the error and retry next tick rather
            # than silently dying and letting drift grow unbounded.
            try:
                self._tick()
                self.breaker.record_success()
            except Exception as e:                      # noqa: BLE001
                self.errors += 1
                self.last_error = e
                self.breaker.record_failure()
                self._outcome("error").inc()
                obs_events.emit("compactor_error", level="WARN",
                                error=repr(e))

    def _tick(self) -> None:
        metrics = drift_metrics(self.index, self.registry)
        if metrics["max_overestimate"] <= self.threshold:
            return
        t0 = time.perf_counter()
        n = self.index.try_compact_async()
        if n is None:
            self.skipped_races += 1     # a mutation raced us; retry next tick
            self._outcome("skipped_race").inc()
        elif n:
            self.compactions += 1
            self._outcome("compacted").inc()
            after = drift_metrics(self.index, self.registry)
            _publish_compaction(self.registry, metrics, after,
                                (time.perf_counter() - t0) * 1e3,
                                source="background_compactor")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
