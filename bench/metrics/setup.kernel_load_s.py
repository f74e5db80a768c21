"""Host time of the kernels' first loads before the window (an nvcc build
on a checkout's first run, else a cached library opened): the sum of
the ``kernel_load`` traces, in s; 0 where no kernel was loaded."""

import math

from benchlib import program


def read(run):
    traces = program.setup_traces(run, "kernel_load")
    if traces is None:
        return None
    return math.fsum(s.ms for tr in traces for s in tr.spans) * 1e-3
