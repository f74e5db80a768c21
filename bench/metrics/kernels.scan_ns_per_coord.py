"""Time of the ``sketch_scan`` span (operand prep and kernel A) per
(query, coordinate) pair that kernel A scores, in ns: over the unstaged
window batches, the spans' summed time over the summed ``coords``
counters of their ``query`` traces.  On a card the time is the span's
device time; on the CPU, where the span's work runs as it is issued (the
plain twin), its host time.

A port whose traces carry no ``coords`` counter gives None, as does a
card's batch without the span's device duration."""

from benchlib import program


def read(run):
    traces = program.window_queries(run)
    if traces is None:
        return None
    cpu = run.device_kind == "cpu"
    ms = coords = 0.0
    for tr in traces:
        n = getattr(tr, "counters", {}).get("coords")
        span = next((s for s in tr.spans if s.name == "sketch_scan"), None)
        t = None if span is None else (span.ms if cpu else span.device_ms)
        if n is None or t is None:
            return None
        ms += t
        coords += n
    return 1e6 * ms / coords if coords else None
