"""Degradation ladder controller — brownout instead of blackout.

Sinnamon's accuracy levers are exactly the knobs an overloaded server
wants to turn: shrinking the rerank candidate pool (k') trades recall
for latency, and skipping the exact rerank entirely — answering from
the sketch upper-bounds alone — is the cheapest answer the index can
produce (the §3.3 "lite" regime).  The ladder maps overload pressure
onto those levers:

* **L0** — healthy, full fidelity.
* **L1** — shrink the rerank budget (k'/4): cheaper exact scoring.
* **L2** — sketch-only answers, ``degraded=true`` stamped on results.
* **L3** — additionally shed lowest-priority tenants with 429.

:class:`DegradationController` is a pure, clock-free state machine the
frontend housekeeping thread ticks with two pressure signals: the
``SLOMonitor`` fast-window burn rate and the queue fullness fraction.
Escalation is immediate (one level per tick while either signal is hot);
de-escalation requires ``dwell_ticks`` consecutive calm ticks
(hysteresis) so the ladder doesn't flap around the threshold.

Level is exported as ``repro_frontend_degraded_level`` and every
transition counts in
``repro_frontend_degraded_transitions_total{direction}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs import metrics as obs_metrics

__all__ = ["DegradeConfig", "DegradationController"]


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Thresholds + hysteresis for the ladder.

    Defaults: escalate when the fast window burns error budget at ≥4×
    the sustainable rate or the queue is ≥75% full; recover one level
    after ``dwell_ticks`` consecutive ticks with burn ≤1× and queue
    ≤25%.  In-between readings hold the current level (and reset the
    recovery dwell) — that asymmetry is the hysteresis.
    """

    enabled: bool = True
    max_level: int = 3
    enter_burn: float = 4.0
    exit_burn: float = 1.0
    enter_queue_frac: float = 0.75
    exit_queue_frac: float = 0.25
    dwell_ticks: int = 4


class DegradationController:
    """Tick-driven ladder state.  Not thread-safe by itself — ticked from
    one housekeeping thread; ``level`` reads are a single int load."""

    def __init__(self, config: Optional[DegradeConfig] = None,
                 registry=None):
        self.config = config or DegradeConfig()
        self._registry = registry
        self.level = 0
        self._calm_ticks = 0
        self._gauge().set(0.0)

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs_metrics.get_registry()

    def _gauge(self):
        return self._reg().gauge(
            "repro_frontend_degraded_level",
            "Current degradation ladder level (0=healthy .. 3=shedding).")

    def _transition(self, new_level: int, direction: str) -> None:
        self.level = new_level
        self._gauge().set(float(new_level))
        self._reg().counter(
            "repro_frontend_degraded_transitions_total",
            "Ladder level changes by direction.",
            labels={"direction": direction}).inc()

    def tick(self, *, burn: float, queue_frac: float) -> int:
        """Advance one tick with fresh pressure readings; return level."""
        cfg = self.config
        if not cfg.enabled:
            return self.level
        hot = burn >= cfg.enter_burn or queue_frac >= cfg.enter_queue_frac
        calm = burn <= cfg.exit_burn and queue_frac <= cfg.exit_queue_frac
        if hot:
            self._calm_ticks = 0
            if self.level < cfg.max_level:
                self._transition(self.level + 1, "up")
        elif calm and self.level > 0:
            self._calm_ticks += 1
            if self._calm_ticks >= cfg.dwell_ticks:
                self._calm_ticks = 0
                self._transition(self.level - 1, "down")
        else:
            self._calm_ticks = 0
        return self.level
