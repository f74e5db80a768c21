"""The one general traffic loop: a closed loop of one client.

A traffic mix (``bench/traffic/<mix>.json``) sets the query batch of a
step (``query_batch``, from a pool of ``query_pool_batches`` drawn at
set-up and cycled).  The next step starts when the previous one has
returned.

Every step is recorded (its host-clock times, its answers), warm-up steps
included.  In a traced run every ``staged.every``-th step is staged: its
query goes down the server's staged path (synced spans); the other steps
run as in an untraced run.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback

import torch


class Step:
    __slots__ = ("phase", "staged", "query_batch", "t0", "t1", "query_ms",
                 "ids", "scores", "spans", "calls", "failed")

    def __init__(self, phase: str):
        self.phase = phase
        self.staged = False
        self.query_batch = None
        self.t0 = self.t1 = 0.0
        self.query_ms = None
        self.ids = self.scores = None
        self.spans = None              # a staged query's {stage: ms}
        self.calls = 0
        self.failed = 0


def _label(trace: bool, name: str):
    if not trace:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


class Loop:
    """Drives ``system`` (a :class:`benchlib.system.System`) with one
    traffic mix over the query pool drawn at set-up."""

    def __init__(self, system, traffic: dict, queries, trace: bool):
        self.system = system
        self.Q = int(traffic["query_batch"])
        self.q_idx, self.q_val = queries
        self.trace = trace
        staged = traffic.get("staged", {}) if trace else {}
        self.staged_every = int(staged.get("every", 0))
        self.steps: list = []

    def _call(self, st: Step, fn, *args):
        st.calls += 1
        try:
            return fn(*args)
        except Exception:          # a failed request: counted, run goes on
            st.failed += 1
            traceback.print_exc(file=sys.stderr)
            return None

    def step(self, phase: str) -> Step:
        s = len(self.steps)
        st = Step(phase)
        st.staged = bool(self.staged_every) and s % self.staged_every == 0
        st.t0 = time.perf_counter()
        with _label(self.trace,
                    "bench.step.staged" if st.staged else "bench.step"):
            st.query_batch = s % self.q_idx.shape[0]
            with _label(self.trace, "bench.query_many"):
                t = time.perf_counter()
                res = self._call(st, self.system.query,
                                 self.q_idx[st.query_batch],
                                 self.q_val[st.query_batch], st.staged)
                st.query_ms = (time.perf_counter() - t) * 1e3
            if res is not None:
                st.ids, st.scores, st.spans = res
        st.t1 = time.perf_counter()
        self.steps.append(st)
        return st

    def run(self, seconds: float):
        """Steps until ``seconds`` have passed; returns (t_start, t_end)
        of the window: from its first step's start to its last step's
        end."""
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            self.step("window")
            if self.steps[-1].t1 >= deadline:
                break
        return t_start, self.steps[-1].t1

    def window(self) -> list:
        return [s for s in self.steps if s.phase == "window"]
