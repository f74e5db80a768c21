"""Closed-loop load generator for the serving front door.

Counterpart of ``repro.serving.loadgen``.  Drives a frontend (in-process
`ServingFrontend` or the HTTP endpoint) with
``clients`` closed-loop workers that collectively pace to an offered QPS,
and reduces each run to one `LoadPoint`: achieved/goodput throughput,
latency percentiles (p50/p99/p999), and outcome counts.

Pacing: a shared arrival schedule at ``offered_qps`` (deterministic,
evenly spaced) is consumed by the workers; each worker sleeps until its
next arrival slot, issues the query, and blocks for the answer (closed
loop).  When the system can't keep up the workers fall behind schedule and
achieved < offered — exactly the saturation signal the sweep is after.

Goodput counts only requests that returned OK *within* the deadline;
rejections (backpressure/quota) and expiries are tallied separately so a
sweep row distinguishes "fast because it sheds" from "fast and correct".
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

__all__ = ["LoadPoint", "frontend_client", "run_point"]


@dataclass
class LoadPoint:
    """One offered-load operating point, reduced to serving stats."""

    offered_qps: float
    duration_s: float
    clients: int
    ok: int = 0
    rejected: int = 0
    expired: int = 0
    errors: int = 0
    latencies_ms: List[float] = field(default_factory=list)

    @property
    def issued(self) -> int:
        return self.ok + self.rejected + self.expired + self.errors

    @property
    def achieved_qps(self) -> float:
        return self.issued / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def goodput_qps(self) -> float:
        return self.ok / self.duration_s if self.duration_s > 0 else 0.0

    def percentile_ms(self, q: float) -> float:
        """Latency percentile over OK requests; NaN when nothing succeeded."""
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)

    @property
    def p999_ms(self) -> float:
        return self.percentile_ms(99.9)

    def to_row(self) -> dict:
        return {
            "offered_qps": round(self.offered_qps, 3),
            "achieved_qps": round(self.achieved_qps, 3),
            "goodput_qps": round(self.goodput_qps, 3),
            "p50_ms": round(self.p50_ms, 4),
            "p99_ms": round(self.p99_ms, 4),
            "p999_ms": round(self.p999_ms, 4),
            "ok": self.ok,
            "rejected": self.rejected,
            "expired": self.expired,
            "errors": self.errors,
        }


def run_point(
    client_fn: Callable[[np.ndarray, np.ndarray], str],
    queries: Sequence,
    offered_qps: float,
    *,
    clients: int = 8,
    duration_s: float = 2.0,
    clock=time.monotonic,
    sleep=time.sleep,
) -> LoadPoint:
    """Drive one offered-load point and return its `LoadPoint`.

    ``client_fn(q_idx, q_val)`` issues one query and returns its outcome:
    ``"ok"``, ``"rejected"``, ``"expired"``, or ``"error"`` (anything it
    raises also counts as ``"error"``).  ``queries`` is a sequence of
    ``(q_idx, q_val)`` pairs cycled through by arrival index, so every run
    at the same offered load replays the same work.
    """
    if offered_qps <= 0:
        raise ValueError(f"offered_qps must be > 0, got {offered_qps}")
    point = LoadPoint(offered_qps=float(offered_qps),
                      duration_s=float(duration_s), clients=int(clients))
    period = 1.0 / offered_qps
    n_arrivals = max(1, int(round(offered_qps * duration_s)))
    next_slot = [0]
    lock = threading.Lock()
    start = clock()

    def worker():
        while True:
            with lock:
                slot = next_slot[0]
                if slot >= n_arrivals:
                    return
                next_slot[0] = slot + 1
            at = start + slot * period
            delay = at - clock()
            if delay > 0:
                sleep(delay)
            q_idx, q_val = queries[slot % len(queries)]
            t0 = clock()
            try:
                outcome = client_fn(q_idx, q_val)
            except Exception:                            # noqa: BLE001
                outcome = "error"
            dt_ms = (clock() - t0) * 1e3
            with lock:
                if outcome == "ok":
                    point.ok += 1
                    point.latencies_ms.append(dt_ms)
                elif outcome == "rejected":
                    point.rejected += 1
                elif outcome == "expired":
                    point.expired += 1
                else:
                    point.errors += 1

    threads = [threading.Thread(target=worker, name=f"loadgen-{i}",
                                daemon=True)
               for i in range(max(1, int(clients)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # Measure over the actual wall time so achieved_qps is honest when the
    # system falls behind the arrival schedule.
    point.duration_s = max(clock() - start, 1e-9)
    return point


def frontend_client(frontend, *, tenant: str = "default",
                    deadline_ms: Optional[float] = None,
                    k: Optional[int] = None) -> Callable:
    """Adapt a `ServingFrontend` to the ``client_fn`` protocol."""
    from repro_torch.serving.frontend import DeadlineExceeded, Rejected

    def call(q_idx, q_val) -> str:
        try:
            frontend.query(q_idx, q_val, tenant=tenant,
                           deadline_ms=deadline_ms, k=k)
            return "ok"
        except Rejected:
            return "rejected"
        except DeadlineExceeded:
            return "expired"

    return call
