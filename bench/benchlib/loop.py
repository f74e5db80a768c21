"""What every traffic loop shares: the record of a step and the call that
counts a failed request.

A traffic mix (``bench/traffic/<mix>.json``) names its loop (``loop``),
``bench/loops/<loop>.py``, found by :func:`benchlib.spec.loop`; the rest
of the mix is that loop's parameters.  A loop module gives a class
``Loop(system, traffic, queries, trace, seed=, cfg=)``: the system under
test, the mix, the query pool drawn at set-up, whether the run is traced,
and the run's seed and configuration for a loop that draws inputs of its
own (a feed of documents, from a stream of :mod:`benchlib.data` named
after it).  It has ``step(phase)``, ``run(seconds) -> (t_start, t_end)``,
``window()`` and ``steps`` (every :class:`Step`, warm-up steps included,
in order).  A step that writes lists its writes in ``Step.writes``, in the
order it made them, so that the configuration's reference can replay
them.
"""

from __future__ import annotations

import contextlib
import sys
import traceback
from typing import NamedTuple

import torch


class Write(NamedTuple):
    """One write a step made: ``op`` "insert" or "delete", and the
    document numbers (int64, on the host) in the order given."""
    op: str
    numbers: torch.Tensor


class Step:
    __slots__ = ("phase", "staged", "query_batch", "t0", "t1", "query_ms",
                 "ids", "scores", "spans", "calls", "failed", "writes")

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
        self.writes: list = []         # Write records, before its query


def label(trace: bool, name: str):
    """A profiler range named ``name`` in a traced run."""
    if not trace:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def call(st: Step, fn, *args):
    """``fn(*args)`` as one request of step ``st``: an exception is a
    failed request, counted, and the run goes on (None is returned)."""
    st.calls += 1
    try:
        return fn(*args)
    except Exception:
        st.failed += 1
        traceback.print_exc(file=sys.stderr)
        return None
