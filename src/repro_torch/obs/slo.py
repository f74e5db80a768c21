"""SLO monitor: declared latency/availability objectives with multi-window
burn-rate computation from the existing registry histograms.

An `SLOSpec` declares the objectives (launcher flags spell them); an
`SLOMonitor` periodically snapshots the cumulative good/total counts the
registry already tracks and derives, per objective and per window
(fast 5 m / slow 1 h by default):

* **compliance** — fraction of requests that met the objective over the
  window;
* **burn rate** — ``(1 - compliance) / (1 - target)``: how many times
  faster than budget the error budget is being spent (1.0 = exactly on
  budget; >1 = burning).

Both surface as ``repro_slo_*`` gauges, as the ``/debug/slo`` endpoint
(`report()`), and as ``slo_burn`` WARN events when the fast window burns
hot while the slow window confirms it is sustained (the classic
multi-window alert shape: the fast window catches the spike, the slow
window suppresses blips).

Counts come from histograms/counters that already exist, so the monitor
adds zero cost to the request path:

* latency: good = samples ≤ the objective bound, read from the cumulative
  bucket counts of ``repro_frontend_latency_ms`` (preferred) or
  ``repro_query_latency_ms`` (when no front door is running).  The bound
  snaps UP to the nearest bucket boundary (≤ one bucket width, ±~9% with
  the default layout) — documented, deterministic, and free.
* availability: good = ``outcome="ok"`` from
  ``repro_frontend_requests_total``; without a front door every counted
  query was served, so availability reads 1.0.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics

__all__ = ["SLOMonitor", "SLOSpec"]

#: (family, good-outcome predicate input) preference order for latency.
_LATENCY_FAMILIES = ("repro_frontend_latency_ms", "repro_query_latency_ms")
_REQUESTS_FAMILY = "repro_frontend_requests_total"
_QUERIES_FAMILY = "repro_queries_total"


@dataclass(frozen=True)
class SLOSpec:
    """Declared serving objectives.

    ``latency_target`` of requests must complete within ``latency_ms``;
    ``availability_target`` of requests must not be rejected / expired /
    errored.  Targets are fractions in (0, 1).
    """

    latency_ms: float = 100.0
    latency_target: float = 0.99
    availability_target: float = 0.999

    def __post_init__(self):
        if self.latency_ms <= 0:
            raise ValueError(f"latency_ms must be > 0, got {self.latency_ms}")
        for name in ("latency_target", "availability_target"):
            v = getattr(self, name)
            if not (0.0 < v < 1.0):
                raise ValueError(f"{name} must be in (0, 1), got {v}")


def _family_counts_latency(snapshot: dict, bound_ms: float):
    """(good, total, effective_bound) from the first latency family with
    samples; good = cumulative count at the first bucket bound >= bound_ms
    (all series of the family summed — tenants/backends together)."""
    for family in _LATENCY_FAMILIES:
        fam = snapshot.get(family)
        if not fam or fam.get("type") != "histogram":
            continue
        good = total = 0
        eff = bound_ms
        for s in fam["series"]:
            spec = s["buckets"]
            bounds = [spec["start"] * spec["factor"] ** i
                      for i in range(spec["count"])]
            i = bisect.bisect_left(bounds, bound_ms)
            if i >= len(bounds):          # objective beyond the layout
                good += s["count"]
                eff = float("inf")
            else:
                good += sum(s["counts"][:i + 1])
                eff = bounds[i]
            total += s["count"]
        if total:
            return good, total, eff
    return 0, 0, bound_ms


def _family_counts_availability(snapshot: dict):
    """(good, total) request outcomes; falls back to the query counter
    (every counted query was served) when no front door reports."""
    fam = snapshot.get(_REQUESTS_FAMILY)
    if fam and fam["series"]:
        good = total = 0
        for s in fam["series"]:
            n = s["value"]
            total += n
            if s["labels"].get("outcome") == "ok":
                good += n
        return good, total
    fam = snapshot.get(_QUERIES_FAMILY)
    if fam and fam["series"]:
        n = sum(s["value"] for s in fam["series"])
        return n, n
    return 0, 0


class _Window:
    __slots__ = ("name", "seconds")

    def __init__(self, name: str, seconds: float):
        self.name = name
        self.seconds = float(seconds)


class SLOMonitor:
    """Multi-window burn-rate monitor over a metrics registry.

    ``tick()`` takes one sample (timestamp + cumulative good/total per
    objective) and publishes gauges; ``start(interval_s)`` runs it on a
    daemon thread.  ``report()`` is the ``/debug/slo`` payload.

    ``burn_warn`` (default 10) emits one ``slo_burn`` WARN event per
    breach episode when the fast-window burn exceeds it AND the
    slow-window burn exceeds 1 (sustained, not a blip).
    """

    def __init__(self, spec: SLOSpec, registry=None, *,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_warn: float = 10.0,
                 event_log=None, clock=time.time):
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        self.spec = spec
        self.registry = registry if registry is not None \
            else _metrics.get_registry()
        self.windows = (_Window("fast", fast_window_s),
                        _Window("slow", slow_window_s))
        self.burn_warn = float(burn_warn)
        self._event_log = event_log
        self._clock = clock
        self._samples: deque = deque()   # (t, {slo: (good, total)})
        self._lock = threading.Lock()
        self._burning = False            # edge-triggered WARN
        self._thread = None
        self._stop = threading.Event()
        self.ticks = 0
        self.last_stats: Optional[dict] = None   # most recent tick() output

    # -- sampling ------------------------------------------------------------
    def _read(self):
        snap = self.registry.snapshot()
        lat_good, lat_total, eff = _family_counts_latency(
            snap, self.spec.latency_ms)
        av_good, av_total = _family_counts_availability(snap)
        return {"latency": (lat_good, lat_total),
                "availability": (av_good, av_total)}, eff

    def tick(self, now: Optional[float] = None) -> dict:
        """Take one sample, publish gauges, emit WARN on sustained burn.
        Returns the per-objective window stats (the `report()` core)."""
        now = self._clock() if now is None else float(now)
        counts, eff_bound = self._read()
        horizon = self.windows[-1].seconds * 1.25
        with self._lock:
            self._samples.append((now, counts))
            while self._samples and now - self._samples[0][0] > horizon \
                    and len(self._samples) > 1:
                self._samples.popleft()
            samples = list(self._samples)
            self.ticks += 1

        targets = {"latency": self.spec.latency_target,
                   "availability": self.spec.availability_target}
        out: dict = {}
        for slo, target in targets.items():
            budget = 1.0 - target
            out[slo] = {"target": target, "windows": {}}
            for win in self.windows:
                base = self._window_base(samples, now, win.seconds)
                good = counts[slo][0] - base[slo][0]
                total = counts[slo][1] - base[slo][1]
                compliance = 1.0 if total <= 0 else good / total
                burn = (1.0 - compliance) / budget
                out[slo]["windows"][win.name] = {
                    "window_s": win.seconds,
                    "good": good, "total": total,
                    "compliance": round(compliance, 6),
                    "burn_rate": round(burn, 4),
                }
                self.registry.gauge(
                    "repro_slo_burn_rate",
                    "Error-budget burn rate over the window "
                    "(1.0 = spending exactly the budget).",
                    labels={"slo": slo, "window": win.name}).set(burn)
                self.registry.gauge(
                    "repro_slo_compliance_ratio",
                    "Fraction of requests meeting the objective over the "
                    "window.",
                    labels={"slo": slo, "window": win.name}).set(compliance)
            self.registry.gauge(
                "repro_slo_objective_ratio",
                "Declared SLO target fraction.",
                labels={"slo": slo}).set(target)
        self.registry.gauge(
            "repro_slo_latency_bound_ms",
            "Latency objective after snapping up to the nearest histogram "
            "bucket boundary.").set(
            -1.0 if eff_bound == float("inf") else eff_bound)
        out["latency"]["bound_ms"] = \
            None if eff_bound == float("inf") else round(eff_bound, 6)
        self._maybe_warn(out)
        self.last_stats = out
        return out

    def fast_burn(self) -> float:
        """Worst fast-window burn rate across objectives at the last tick
        (0.0 before any tick).  This is the degradation ladder's pressure
        signal — a cheap read, no fresh scrape."""
        stats = self.last_stats
        if not stats:
            return 0.0
        return max(stats[slo]["windows"]["fast"]["burn_rate"]
                   for slo in ("latency", "availability"))

    @staticmethod
    def _window_base(samples, now, window_s):
        """Earliest sample inside the window (the subtraction base); falls
        back to the oldest sample when the ring is younger than the
        window."""
        base = samples[0][1]
        for t, counts in samples:
            if now - t <= window_s:
                base = counts
                break
        return base

    def _maybe_warn(self, out: dict) -> None:
        hot = any(
            o["windows"]["fast"]["burn_rate"] > self.burn_warn
            and o["windows"]["slow"]["burn_rate"] > 1.0
            for o in (out["latency"], out["availability"]))
        if hot and not self._burning:
            log = self._event_log if self._event_log is not None \
                else _events.get_event_log()
            if log is not None:
                log.emit(
                    "slo_burn", level="WARN",
                    burn_warn=self.burn_warn,
                    latency=out["latency"]["windows"],
                    availability=out["availability"]["windows"])
        self._burning = hot

    # -- surfaces ------------------------------------------------------------
    def report(self) -> dict:
        """The ``/debug/slo`` payload: objectives + live window stats."""
        stats = self.tick()
        return {
            "objectives": {
                "latency_ms": self.spec.latency_ms,
                "latency_target": self.spec.latency_target,
                "availability_target": self.spec.availability_target,
            },
            "windows": {w.name: w.seconds for w in self.windows},
            "burn_warn": self.burn_warn,
            "ticks": self.ticks,
            "slos": stats,
        }

    # -- background loop -----------------------------------------------------
    def start(self, interval_s: float = 5.0) -> "SLOMonitor":
        """Tick on a daemon thread every ``interval_s`` until `stop()`."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:               # noqa: BLE001
                    pass    # a failed scrape must never kill the monitor

        self._thread = threading.Thread(target=loop, name="slo-monitor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
