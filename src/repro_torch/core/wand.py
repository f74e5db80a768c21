"""WAND baseline (Broder et al. 2003), modified for real-valued vectors
(paper §6.1.4).

Document-at-a-time traversal with per-list score upper bounds and pivot-based
skipping.  Generalisation to real values: for list j the partial-score upper
bound is ``max(q[j]·max_val_j, q[j]·min_val_j)`` — exact for non-negative data
and still a valid bound for signed data.

This is intentionally host-side NumPy/Python: pointer-chasing DAAT traversal
(irregular, data-dependent skipping) has no place on the card, which is
itself one of the paper's findings (§6.3: WAND loses to regular scans once the
Zipfian/short-query assumptions break).  It exists to reproduce the paper's
comparison tables, not as a production path.

A copy of ``repro.core.wand`` (numpy only), so that the port imports
nothing of the JAX package; the parity tests hold the two equal.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np


class WandIndex:
    def __init__(self, n: int):
        self.n = n
        self._lists: dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._doc_idx: dict[int, np.ndarray] = {}
        self._doc_val: dict[int, np.ndarray] = {}

    def build(self, ids, idx_batch, val_batch) -> None:
        per_coord: dict[int, list] = {}
        for d, idx, val in zip(ids, idx_batch, val_batch):
            idx = np.asarray(idx); val = np.asarray(val, np.float32)
            keep = idx >= 0
            idx, val = idx[keep], val[keep]
            self._doc_idx[int(d)] = idx
            self._doc_val[int(d)] = val
            for j, v in zip(idx, val):
                per_coord.setdefault(int(j), []).append((int(d), float(v)))
        for j, postings in per_coord.items():
            postings.sort()
            docs = np.array([p[0] for p in postings], np.int64)
            vals = np.array([p[1] for p in postings], np.float32)
            self._lists[j] = (docs, vals)

    def exact_score(self, doc: int, q_idx, q_val) -> float:
        qd = dict(zip(np.asarray(q_idx).tolist(),
                      np.asarray(q_val, np.float32).tolist()))
        i, v = self._doc_idx[doc], self._doc_val[doc]
        return float(sum(qd.get(int(j), 0.0) * float(x) for j, x in zip(i, v)))

    def search(self, q_idx, q_val, k: int):
        """Classic WAND with a growing heap threshold θ."""
        q_idx = np.asarray(q_idx); q_val = np.asarray(q_val, np.float32)
        keep = (q_idx >= 0) & (q_val != 0)
        q_idx, q_val = q_idx[keep], q_val[keep]

        cursors = []   # per query term: [list_docs, list_vals, pos, ub, qv]
        for j, qv in zip(q_idx, q_val):
            if int(j) not in self._lists:
                continue
            docs, vals = self._lists[int(j)]
            ub = max(qv * float(vals.max()), qv * float(vals.min()))
            cursors.append([docs, vals, 0, ub, float(qv)])
        heap: list[Tuple[float, int]] = []   # (score, doc) min-heap
        theta = -np.inf

        def current_doc(c):
            return c[0][c[2]] if c[2] < len(c[0]) else np.iinfo(np.int64).max

        while True:
            cursors = [c for c in cursors if c[2] < len(c[0])]
            if not cursors:
                break
            cursors.sort(key=current_doc)
            # Real-valued generalisation: a document in any SUBSET of the
            # prefix lists is bounded by Σ max(UB_i, 0) — clamping keeps the
            # pruning sound when per-list bounds can be negative.
            acc, pivot = 0.0, -1
            for i, c in enumerate(cursors):
                acc += max(c[3], 0.0)
                if acc > theta or len(heap) < k:
                    pivot = i
                    break
            if pivot < 0:
                break
            pivot_doc = int(current_doc(cursors[pivot]))
            if int(current_doc(cursors[0])) == pivot_doc:
                # fully evaluate pivot_doc
                s = 0.0
                for c in cursors:
                    if int(current_doc(c)) == pivot_doc:
                        s += c[4] * float(c[1][c[2]])
                        c[2] += 1
                if len(heap) < k:
                    heapq.heappush(heap, (s, pivot_doc))
                elif s > heap[0][0]:
                    heapq.heapreplace(heap, (s, pivot_doc))
                if len(heap) == k:
                    theta = heap[0][0]
            else:
                # skip all cursors before the pivot up to pivot_doc
                for c in cursors[:pivot]:
                    c[2] += int(np.searchsorted(c[0][c[2]:], pivot_doc))
        out = sorted(heap, key=lambda t: -t[0])
        ids = np.array([d for _, d in out], np.int64)
        scores = np.array([s for s, _ in out], np.float32)
        return ids, scores

    def memory_bytes(self) -> int:
        return int(sum(d.nbytes + v.nbytes for d, v in self._lists.values()))
