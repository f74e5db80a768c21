"""Vector storage (the "S" box of the paper's Figure 1) in PyTorch.

Every active vector is kept in raw form as **padded CSR** over slots:

    indices : int32[C, P]   active coordinates, padded with -1
    values  : f32/bf16[C, P]

Fetching k' candidates is a row gather; the exact inner product is a
gather of ``q_dense[indices]`` and a masked dot.  Counterpart of
``repro.storage.vecstore``.  :func:`write` and :func:`erase` update the
store in place (the reference returns a new store).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class VecStore(NamedTuple):
    indices: Tensor   # int32[C, P], pad = -1
    values: Tensor    # [C, P]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]


def empty(capacity: int, max_nnz: int, dtype=torch.float32,
          device=None) -> VecStore:
    return VecStore(
        indices=torch.full((capacity, max_nnz), -1, dtype=torch.int32,
                           device=device),
        values=torch.zeros((capacity, max_nnz), dtype=dtype, device=device),
    )


def write(store: VecStore, slots: Tensor, idx: Tensor, val: Tensor) -> None:
    """Write rows ``idx``/``val`` [B, P] at ``slots`` [B] (in place)."""
    store.indices[slots] = idx.to(torch.int32)
    store.values[slots] = val.to(store.values.dtype)


def erase(store: VecStore, slots: Tensor) -> None:
    """Clear the rows at ``slots`` (in place)."""
    store.indices[slots] = -1
    store.values[slots] = 0


def densify_query(n: int, q_idx: Tensor, q_val: Tensor) -> Tensor:
    """Scatter padded sparse queries [..., L] into dense f32[..., n].

    Duplicate coordinates add, which is the same total that the reference's
    ``combine_query`` gives each duplicate run.
    """
    valid = q_idx >= 0
    safe = torch.where(valid, q_idx, 0).long()
    contrib = torch.where(valid, q_val.to(torch.float32), 0.0)
    out = torch.zeros(q_idx.shape[:-1] + (n,), dtype=torch.float32,
                      device=q_val.device)
    return out.scatter_add_(-1, safe, contrib)


def combine_query(q_idx: Tensor, q_val: Tensor):
    """Sort query coordinates (pads last) and combine duplicates.

    Returns ``(qs, comb)``: sorted coordinate keys (pad = int32 max) and, at
    every position, the total value of its coordinate's duplicate run.
    """
    big = torch.iinfo(torch.int32).max
    key = torch.where(q_idx >= 0, q_idx, big)
    qs, order = torch.sort(key, stable=True)
    qv = torch.where(q_idx >= 0, q_val.to(torch.float32), 0.0)[order]
    if qs.shape[0] == 0:
        return qs, qv
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=qs.device),
                       qs[1:] != qs[:-1]])
    seg = torch.cumsum(start.long(), 0) - 1
    sums = torch.zeros_like(qv).index_add_(0, seg, qv)
    return qs, sums[seg]


def exact_scores_rows(idx: Tensor, val: Tensor, q_idx: Tensor,
                      q_val: Tensor) -> Tensor:
    """Exact ⟨q, x⟩ for pre-gathered CSR rows (idx [K, P], val [K, P]) and
    one sparse query, matched by searchsorted.  f32[K]."""
    val = val.to(torch.float32)
    qs, comb = combine_query(q_idx, q_val)
    pos = torch.searchsorted(qs.contiguous(), idx.to(qs.dtype).contiguous())
    pos = pos.clamp(0, qs.shape[0] - 1)
    hit = (qs[pos] == idx) & (idx >= 0)
    qd = torch.where(hit, comb[pos], 0.0)
    return (qd * val).sum(-1)


def exact_scores_sparse(store: VecStore, slots: Tensor, q_idx: Tensor,
                        q_val: Tensor) -> Tensor:
    """Exact ⟨q, x_s⟩ for the given slots without densifying the query."""
    return exact_scores_rows(store.indices[slots], store.values[slots],
                             q_idx, q_val)


def exact_scores_all(store: VecStore, q_dense: Tensor) -> Tensor:
    """Exact scores for every slot (the exact LinScan), f32[..., C].

    ``q_dense`` is f32[n] or f32[B, n].  On a CUDA store this runs the
    ``csr_score`` kernel; on the CPU its plain twin.
    """
    from repro_torch.kernels import ops as _ops
    return _ops.exact_scores_all(store, q_dense)
