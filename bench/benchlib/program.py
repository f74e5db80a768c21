"""The port's own spans: the device-timed traces that ``repro_torch`` keeps
in memory (``repro_torch.obs.trace.recent``), matched to the run.

``benchlib/system.py`` stays the one module of the harness that imports
the port: this module reads the ring from ``repro_torch.obs.trace`` as the
system under test loaded it (``sys.modules``).  A version of the port
without the ring leaves every reading None; on a card, a process in which
the port's trace module is not loaded at all is an error, not a silent
None.

A ``query`` trace belongs to the window step whose ``[t0, t1]`` (the
host clock) holds the trace's host start; only the unstaged steps are
read, and only when each of them has exactly one trace.  The CPU records
no device duration, so there the device readers give None.
"""

from __future__ import annotations

import bisect
import math
import sys

#: The port's module that keeps the ring of device-timed traces.
TRACE_MODULE = "repro_torch.obs.trace"


def _trace_module(run):
    trace = sys.modules.get(TRACE_MODULE)
    if trace is None and run.device_kind != "cpu":
        raise RuntimeError(
            f"{TRACE_MODULE} is not loaded: the system under test was not "
            "loaded through benchlib/system.py")
    return trace if hasattr(trace, "recent") else None


def _recent(run, op: str):
    """The kept traces of ``op``, or None where the port keeps none."""
    trace = _trace_module(run)
    return None if trace is None else trace.recent(op)


def window_queries(run):
    """The ``query`` trace of each unstaged window step, in step order, or
    None unless every unstaged step has exactly one."""
    traces = _recent(run, "query")
    steps = run.window
    if traces is None or not steps:
        return None
    starts = [s.t0 for s in steps]
    per_step = [[] for _ in steps]
    for tr in traces:
        i = bisect.bisect_right(starts, tr.t0) - 1
        if i >= 0 and tr.t0 <= steps[i].t1:
            per_step[i].append(tr)
    out = []
    for st, got in zip(steps, per_step):
        if st.staged:
            continue
        if len(got) != 1:
            return None
        out.append(got[0])
    return out or None


def query_stage_ms(run, stages, device: bool):
    """Mean over the unstaged window batches of the summed device (or
    host) durations of ``stages``, in ms; None where a batch lacks one of
    them or its device duration."""
    traces = window_queries(run)
    if traces is None:
        return None
    sums = []
    for tr in traces:
        by_name = {s.name: s for s in tr.spans}
        total = 0.0
        for name in stages:
            span = by_name.get(name)
            ms = None if span is None else \
                (span.device_ms if device else span.ms)
            if ms is None:
                return None
            total += ms
        sums.append(total)
    return math.fsum(sums) / len(sums)


def setup_traces(run, op: str):
    """The kept traces of ``op`` that started before the window, or None
    where the port keeps none or its ring may have dropped some."""
    traces = _recent(run, op)
    if traces is None or len(traces) >= _trace_module(run).RING:
        return None
    w0 = run.window[0].t0 if run.window else math.inf
    return [tr for tr in traces if tr.t0 < w0]


def setup_stage_s(run, op: str, stages, device: bool):
    """Sum over the set-up's ``op`` traces of the device (or host)
    durations of their ``stages`` spans, in seconds; None without a trace
    or where a device duration is missing."""
    traces = setup_traces(run, op)
    if not traces:
        return None
    ms = []
    for tr in traces:
        for span in tr.spans:
            if span.name in stages:
                v = span.device_ms if device else span.ms
                if v is None:
                    return None
                ms.append(v)
    return math.fsum(ms) * 1e-3
