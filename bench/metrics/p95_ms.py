"""95th percentile of the query batches' latencies in the window: from a
batch handed to ``query_many`` to its ids on the host (host clock)."""

import numpy as np


def read(run):
    lat = [s.query_ms for s in run.window
           if s.query_ms is not None and s.ids is not None]
    return float(np.percentile(lat, 95)) if lat else None
