"""Device time of the set-up's inserts: the sum, over the ``insert_many``
traces that start before the window, of the device durations of their
``encode``, ``bitmap``, ``sketch`` and ``csr`` spans, in s.

A span's device duration is the stream's elapsed time between the timing
events at its boundaries: the write kernels' time and any gap in which
the card waited for the host to issue the next of them."""

from benchlib import program

WRITES = ("encode", "bitmap", "sketch", "csr")


def read(run):
    return program.setup_stage_s(run, "insert_many", WRITES, device=True)
