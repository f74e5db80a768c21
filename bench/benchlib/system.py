"""The system under test: the port's index and query server, opened from a
configuration's ``index`` and ``serving`` blocks.  This is the only module
of the harness that imports the port (``repro_torch``)."""

from __future__ import annotations

import torch


class System:
    def __init__(self, cfg: dict, device, staged_queries: bool = False,
                 cell_dtype=None):
        from repro_torch.api import IndexConfig, open_index
        from repro_torch.serving.serve import QueryServer

        index_cfg = dict(cfg["index"])
        if cell_dtype is not None:
            index_cfg["cell_dtype"] = cell_dtype
        self.device = torch.device(device)
        self.index = open_index(IndexConfig(**index_cfg),
                                device=str(self.device))
        serving = cfg["serving"]
        self.server = QueryServer(self.index, k=int(serving["k"]),
                                  kprime=int(serving["kprime"]))
        self.staged = QueryServer(self.index, k=int(serving["k"]),
                                  kprime=int(serving["kprime"]),
                                  trace_every=1) \
            if staged_queries else None

    def insert(self, ids, idx, val) -> None:
        self.index.insert_many(ids, idx, val)

    def delete(self, ids) -> None:
        """Delete the documents of external ``ids`` (``delete_many``: an
        id that is not live raises ``KeyError`` before anything
        changes)."""
        self.index.delete_many(ids)

    def query(self, q_idx, q_val, staged: bool = False):
        """One batch through ``query_many``: (ids, scores, spans) with the
        answers on the host.  A staged batch goes down the server's staged
        path and ``spans`` holds its synced spans {stage: ms}; otherwise
        None."""
        if staged and self.staged is not None:
            res = self.staged.query_many(q_idx, q_val)
            return res.ids, res.scores, {
                s.name: s.ms for s in self.staged.last_trace.spans}
        res = self.server.query_many(q_idx, q_val)
        return res.ids, res.scores, None

    def memory_bytes(self) -> dict:
        return self.index.memory_bytes()

    def close(self) -> None:
        self.server = self.staged = self.index = None
