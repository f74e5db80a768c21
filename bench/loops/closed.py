"""A closed loop of one client that only queries.

The mix sets the query batch of a step (``query_batch``, from a pool of
``query_pool_batches`` drawn at set-up and cycled).  The next step starts
when the previous one has returned.  No step writes.

Every step is recorded (its host-clock times, its answers), warm-up steps
included.  In a traced run every ``staged.every``-th step is staged: its
query goes down the server's staged path (synced spans); the other steps
run as in an untraced run.
"""

from __future__ import annotations

import time

from benchlib.loop import Step, call, label


class Loop:
    """Drives ``system`` (a :class:`benchlib.system.System`) with one
    traffic mix over the query pool drawn at set-up."""

    def __init__(self, system, traffic: dict, queries, trace: bool,
                 seed=None, cfg=None):
        self.system = system
        self.Q = int(traffic["query_batch"])
        self.q_idx, self.q_val = queries
        self.trace = trace
        staged = traffic.get("staged", {}) if trace else {}
        self.staged_every = int(staged.get("every", 0))
        self.steps: list = []

    def step(self, phase: str) -> Step:
        s = len(self.steps)
        st = Step(phase)
        st.staged = bool(self.staged_every) and s % self.staged_every == 0
        st.t0 = time.perf_counter()
        with label(self.trace,
                   "bench.step.staged" if st.staged else "bench.step"):
            st.query_batch = s % self.q_idx.shape[0]
            with label(self.trace, "bench.query_many"):
                t = time.perf_counter()
                res = call(st, self.system.query,
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
