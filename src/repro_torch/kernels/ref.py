"""Dense plain-torch oracles, counterparts of ``repro.kernels.ref``.

Each takes the same (already prepared) operands as the reference oracle of
the same name, with the bit words as int32, and is the correctness contract
the tiled paths must reproduce.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.sinnamon_score import topk_desc

Tensor = torch.Tensor


def sinnamon_topk_ref(qv: Tensor, rows: Tensor, qbits: Tensor, gate: Tensor,
                      u: Tensor, l: Optional[Tensor], kprime: int):
    """Dense oracle for the fused path: score, gate, global top-k.

    qv f32[B, L]; rows int32[B, L, h] (un-offset, index [0, m)); qbits
    int32[B, L, W]; gate f32[1, C] (0 keep / -inf excluded); u, l [m, C].
    Decodes both sketch sides, selects by query sign, sums all coordinates
    in one dense [B, L, C] pass and returns (vals f32[B, kprime],
    slots int32[B, kprime]) in (score desc, slot asc) order.
    """
    B, L = qv.shape
    C = u.shape[1]
    r = rows.long()
    ub = u.to(torch.float32)[r].amin(dim=-2)                 # [B, L, C]
    lb = torch.zeros_like(ub) if l is None \
        else l.to(torch.float32)[r].amax(dim=-2)
    q = qv[..., None]
    contrib = torch.where(q > 0, q * ub, q * lb)
    shifts = torch.arange(32, dtype=torch.int32, device=qv.device)
    mask = ((qbits[..., None] >> shifts) & 1).reshape(B, L, C) != 0
    s = torch.where(mask, contrib, 0.0).sum(dim=1)           # [B, C]
    s = torch.where(gate == 0.0, s, -torch.inf)
    return topk_desc(s, kprime)


def csr_score_ref(q_dense: Tensor, indices: Tensor, values: Tensor) -> Tensor:
    """Exact scores f32[C] of one dense query f32[n] against padded-CSR
    documents (pad = -1)."""
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    return torch.where(valid, q_dense[safe] * values.to(torch.float32),
                       0.0).sum(-1)


def embed_bag_ref(table: Tensor, indices: Tensor, weights: Tensor) -> Tensor:
    """Weighted-sum embedding bags f32[B, D] of ``table`` [V, D] rows at
    ``indices`` int32[B, F] (pad -1, weight 0 there; mean folded into the
    weights): one einsum over the gathered rows."""
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    rows = table[safe].to(torch.float32)                     # [B, F, D]
    w = torch.where(valid, weights, 0.0)
    return torch.einsum("bfd,bf->bd", rows, w)
