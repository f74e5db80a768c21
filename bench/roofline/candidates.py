"""The work of Algorithm 6's candidate generation for one query batch,
counted from the batch's inputs, whatever implements it.

Bytes: each distinct sketch row and each distinct bitmap row that the
batch's coordinates name, read once across the whole capacity (a sketch
row is ``capacity`` cells; a bitmap row ``capacity / 8`` bytes); the
per-slot liveness gate (one byte a slot); the queries (value, h sketch
rows and a bitmap row a coordinate, 4 bytes each); and k' candidates a
query written once (a float32 bound and an int32 slot).  Operations: one
multiply-add (2 f32 operations) per (query, member document) pair, the
member count of a coordinate being its posting-list length.

The sketch rows come from the benchmark's own copy of the index's hash
(``reference.sinnamon.mappings``) and the posting-list lengths from the
benchmark's own inputs; nothing is read from the system under test.
"""

from __future__ import annotations

import numpy as np


def candidate_work(q_idx: np.ndarray, q_val: np.ndarray, maps: np.ndarray,
                   m: int, two_sided: bool, posting: np.ndarray,
                   capacity: int, cell_bytes: int, kprime: int):
    """(bytes, f32 operations) for queries q_idx / q_val [B, L] (pad -1);
    ``maps`` int[h, n], ``posting`` int64[n] posting-list lengths."""
    q_idx = np.asarray(q_idx)
    q_val = np.asarray(q_val)
    B, L = q_idx.shape
    h = maps.shape[0]
    ok = q_idx >= 0
    coords = q_idx[ok].astype(np.int64)
    vals = q_val[ok]
    if not two_sided:                # q <= 0 adds nothing without l
        coords, vals = coords[vals > 0], vals[vals > 0]
    rows = maps[:, coords]                                    # [h, K]
    if two_sided:
        rows = np.where(vals[None] > 0, rows, rows + m)
    sketch_rows = np.unique(rows).size
    bit_rows = np.unique(coords).size
    nbytes = (sketch_rows * capacity * cell_bytes + bit_rows * capacity // 8
              + capacity + B * L * 4 * (2 + h) + B * kprime * 8)
    ops = 2 * int(posting[coords].sum())
    return nbytes, ops
