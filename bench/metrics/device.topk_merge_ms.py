"""Mean device time of the ``topk_merge`` span (the tile merge) over the
unstaged window batches, from the port's device-timed query traces, in
ms."""

from benchlib import program


def read(run):
    return program.query_stage_ms(run, ("topk_merge",), device=True)
