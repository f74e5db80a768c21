"""Mean ``rerank`` span of the staged query batches (the server's
staged path, each span closed by a sync on the card)."""

import numpy as np


def read(run):
    ms = [t["rerank"] for t in run.spans if "rerank" in t]
    return float(np.mean(ms)) if ms else None
