"""Mean device time of the ``rerank`` span (kernel B's rerank, the copy of
the answers to the host excluded) over the unstaged window batches, from
the port's device-timed query traces, in ms."""

from benchlib import program


def read(run):
    return program.query_stage_ms(run, ("rerank",), device=True)
