"""Typed query results for the serving surface (counterpart of
``repro.serving.results``).

``QueryResult`` is frozen and stays unpackable as the legacy
``(ids, scores)`` tuple.  ``new_trace_id`` gives process-unique,
increasing ids in the same ``q-<pid>-<n>`` form as the reference.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from typing import Optional

import numpy as np

__all__ = ["QueryResult", "new_trace_id"]

_trace_counter = itertools.count(1)
_trace_lock = threading.Lock()


def new_trace_id() -> str:
    """Process-unique, monotonically increasing query trace id."""
    with _trace_lock:
        n = next(_trace_counter)
    return f"q-{os.getpid():x}-{n:x}"


@dataclasses.dataclass(frozen=True, eq=False)
class QueryResult:
    """One query (or query batch) answer.

    ``ids``/``scores`` are ``[k]`` for :meth:`QueryServer.query` and
    ``[B, k]`` for :meth:`QueryServer.query_many`.  ``backend`` is the
    scoring backend that produced the candidates, by its canonical name
    (``reference``, ``grouped``, ``fused`` — also when it was asked for as
    ``pallas`` — or ``custom`` for a ``score_fn``); ``degraded`` marks
    answers served under the degradation ladder (scores may be upper
    bounds).
    """

    ids: np.ndarray
    scores: np.ndarray
    k: int
    backend: str
    trace_id: str
    degraded: bool = False

    def __iter__(self):
        return iter((self.ids, self.scores))

    def __getitem__(self, i):
        return (self.ids, self.scores)[i]

    def __len__(self) -> int:
        return 2

    @property
    def batch_size(self) -> Optional[int]:
        """B for a batched result, None for a single-query result."""
        return self.ids.shape[0] if self.ids.ndim == 2 else None

    def row(self, i: int, k: Optional[int] = None,
            trace_id: Optional[str] = None) -> "QueryResult":
        """Per-request slice of a batched result (optionally trimmed)."""
        if self.ids.ndim != 2:
            raise ValueError("row() is only defined on batched results")
        kk = self.k if k is None else min(int(k), self.k)
        return QueryResult(ids=self.ids[i, :kk], scores=self.scores[i, :kk],
                           k=kk, backend=self.backend,
                           trace_id=trace_id or self.trace_id,
                           degraded=self.degraded)
