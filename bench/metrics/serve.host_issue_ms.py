"""Mean host time to issue a batch, the ``admission``, ``sketch_scan``,
``topk_merge`` and ``rerank`` spans of the port's query traces (everything
before the blocking copy to the host), over the unstaged window batches,
in ms."""

from benchlib import program

BEFORE_COPY = ("admission", "sketch_scan", "topk_merge", "rerank")


def read(run):
    return program.query_stage_ms(run, BEFORE_COPY, device=False)
