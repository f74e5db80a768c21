"""Share of the unstaged window batches that redid candidate selection in
one pass (their ``query`` trace holds a ``fallback_scan`` span), in %.

A port without two-pass candidate selection (no ``two_pass`` count on
``sinnamon_score.candidate_scan``) gives None."""

import sys

from benchlib import program

#: The port's module that counts the batches of each candidate path.
KERNEL_MODULE = "repro_torch.kernels.sinnamon_score"


def read(run):
    kernel = sys.modules.get(KERNEL_MODULE)
    scan = getattr(kernel, "candidate_scan", None)
    if not hasattr(scan, "two_pass"):
        return None
    traces = program.window_queries(run)
    if traces is None:
        return None
    redone = sum(any(s.name == "fallback_scan" for s in tr.spans)
                 for tr in traces)
    return 100.0 * redone / len(traces)
