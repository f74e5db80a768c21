"""Mean device time of the ``sketch_scan`` span (operand prep and kernel A)
over the unstaged window batches, from the port's device-timed query
traces (timing events at the stage boundaries, no sync), in ms: the
stream's elapsed time between the span's events, host issue gaps
included."""

from benchlib import program


def read(run):
    return program.query_stage_ms(run, ("sketch_scan",), device=True)
