"""LinScan: the paper's exact SMIPS baseline (§3, Algorithms 1–4).

Two implementations, both exact:

1. ``LinScanIndex`` — the *faithful* coordinate-at-a-time traversal over an
   inverted index of (slot, value) postings, including the anytime variant
   (Algorithm 4: process coordinates in descending |q[j]| order under a
   postings budget, then rerank k' candidates exactly).  Postings traversal is
   inherently ragged, so this lives in vectorised NumPy on the host — it is
   the ground-truth oracle and the CPU comparison point of the paper.

2. The exact scan on the card is `repro_torch.storage.vecstore.exact_scores_all`
   (kernel B's LinScan mode: a document-ordered padded-CSR scan — same
   exact scores, regular memory access); `repro_torch.eval.recall` uses it
   as the exact oracle.

A copy of ``repro.core.linscan`` (numpy only), so that the port imports
nothing of the JAX package; the parity tests hold the two equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class LinScanIndex:
    """Exact inverted index over a *static snapshot* plus a streaming tail.

    Streaming inserts/deletes are accumulated in a small uncompacted tail and
    merged into the CSR arrays on demand (``compact()``), mirroring how the
    paper's dynamic arrays amortise reallocation.
    """

    def __init__(self, n: int):
        self.n = n
        # CSR over coordinates: postings sorted by coordinate.
        self._coord_offsets = np.zeros(n + 1, np.int64)
        self._post_slot = np.zeros(0, np.int32)
        self._post_val = np.zeros(0, np.float32)
        # doc-major copies for exact rerank / deletion.
        self._doc_idx: dict[int, np.ndarray] = {}
        self._doc_val: dict[int, np.ndarray] = {}
        self._tail: list[Tuple[int, np.ndarray, np.ndarray]] = []
        self._deleted: set[int] = set()

    # -- updates (Algorithm 1 + §3.1 full deletion) -------------------------
    def insert(self, doc_id: int, idx, val) -> None:
        idx = np.asarray(idx, np.int32)
        val = np.asarray(val, np.float32)
        self._doc_idx[doc_id] = idx
        self._doc_val[doc_id] = val
        self._tail.append((doc_id, idx, val))
        self._deleted.discard(doc_id)

    def insert_many(self, ids, idx_batch, val_batch) -> None:
        for d, i, v in zip(ids, idx_batch, val_batch):
            valid = np.asarray(i) >= 0
            self.insert(int(d), np.asarray(i)[valid], np.asarray(v)[valid])
        self.compact()

    def delete(self, doc_id: int) -> None:
        """Full deletion: postings are physically removed at next compaction."""
        self._deleted.add(doc_id)
        self._doc_idx.pop(doc_id, None)
        self._doc_val.pop(doc_id, None)

    def compact(self) -> None:
        # Rebuild from the doc-major truth (simplest correct full-deletion).
        all_c, all_s, all_v = [], [], []
        for d, i in self._doc_idx.items():
            all_c.append(i)
            all_s.append(np.full(i.size, d, np.int32))
            all_v.append(self._doc_val[d])
        if all_c:
            c = np.concatenate(all_c)
            s = np.concatenate(all_s)
            v = np.concatenate(all_v)
            order = np.argsort(c, kind="stable")
            c, s, v = c[order], s[order], v[order]
        else:
            c = np.zeros(0, np.int32); s = np.zeros(0, np.int32)
            v = np.zeros(0, np.float32)
        self._coord_offsets = np.zeros(self.n + 1, np.int64)
        np.add.at(self._coord_offsets, c + 1, 1)
        self._coord_offsets = np.cumsum(self._coord_offsets)
        self._post_slot, self._post_val = s, v
        self._tail = []

    # -- retrieval (Algorithms 2–4) ------------------------------------------
    def scores(self, q_idx, q_val,
               posting_budget: Optional[int] = None) -> np.ndarray:
        """Coordinate-at-a-time accumulation; budget = anytime Algorithm 4."""
        if self._tail:
            self.compact()
        max_doc = (max(self._doc_idx) + 1) if self._doc_idx else 1
        scores = np.zeros(max_doc, np.float32)
        q_idx = np.asarray(q_idx, np.int64)
        q_val = np.asarray(q_val, np.float32)
        keep = q_idx >= 0
        q_idx, q_val = q_idx[keep], q_val[keep]
        order = np.argsort(-np.abs(q_val), kind="stable")   # Alg. 4 line 2
        spent = 0
        for t in order:
            j, v = q_idx[t], q_val[t]
            lo, hi = self._coord_offsets[j], self._coord_offsets[j + 1]
            if posting_budget is not None:
                hi = min(hi, lo + max(0, posting_budget - spent))
                spent += hi - lo
            if hi > lo:
                np.add.at(scores, self._post_slot[lo:hi],
                          v * self._post_val[lo:hi])
            if posting_budget is not None and spent >= posting_budget:
                break
        return scores

    def exact_score(self, doc_id: int, q_dense: np.ndarray) -> float:
        i = self._doc_idx[doc_id]
        return float(np.dot(q_dense[i], self._doc_val[doc_id]))

    def search(self, q_idx, q_val, k: int,
               kprime: Optional[int] = None,
               posting_budget: Optional[int] = None):
        """Exact top-k (budget=None) or anytime Algorithm 4 (budget set)."""
        s = self.scores(q_idx, q_val, posting_budget)
        if posting_budget is None:
            top = _find_largest(s, k)
            return top, s[top]
        kprime = kprime or 5 * k
        cands = _find_largest(s, min(kprime, s.size))
        q_dense = np.zeros(self.n, np.float32)
        qi = np.asarray(q_idx); qv = np.asarray(q_val, np.float32)
        q_dense[qi[qi >= 0]] = qv[qi >= 0]
        exact = np.array([
            self.exact_score(int(d), q_dense) if int(d) in self._doc_idx
            else -np.inf for d in cands])
        top = _find_largest(exact, min(k, exact.size))
        return cands[top], exact[top]

    def memory_bytes(self) -> int:
        return int(self._post_slot.nbytes + self._post_val.nbytes
                   + self._coord_offsets.nbytes)


def _find_largest(scores: np.ndarray, k: int) -> np.ndarray:
    """Algorithm 3 (FindLargest) — argpartition in place of the binary heap."""
    k = min(k, scores.size)
    part = np.argpartition(-scores, k - 1)[:k]
    return part[np.argsort(-scores[part], kind="stable")]


def brute_force_topk(doc_idx, doc_val, q_idx, q_val, n: int, k: int):
    """Dense brute force (test oracle): returns (ids, scores)."""
    q = np.zeros(n, np.float32)
    qi = np.asarray(q_idx); qv = np.asarray(q_val, np.float32)
    q[qi[qi >= 0]] = qv[qi >= 0]
    scores = np.zeros(len(doc_idx), np.float32)
    for d, (i, v) in enumerate(zip(doc_idx, doc_val)):
        i = np.asarray(i); v = np.asarray(v, np.float32)
        keep = i >= 0
        scores[d] = np.dot(q[i[keep]], v[keep])
    top = _find_largest(scores, k)
    return top, scores[top]
