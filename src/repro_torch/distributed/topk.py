"""The shard merge: per-shard candidate tuples into one global top-k.

Counterpart of ``repro.distributed.topk``.  The reference all-gathers each
shard's ``(value, payloads...)`` tuples over the corpus mesh axes, in
shard order, and takes ``lax.top_k`` of the concatenation: value
descending, then concatenated position ascending, so on equal values the
lower shard (and, within a shard, the earlier candidate) wins.  The port
concatenates the shards' tuples in shard order on one device and selects
on ``sinnamon_score.order_key`` keys (``topk_desc``'s), which build that
order in; a bare ``torch.topk`` of the values does not promise it on
ties.

Only the k-sized tuples cross shards: O(B·S·k) values, never a score
matrix.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.sinnamon_score import order_key, topk_desc

Tensor = torch.Tensor

SLOT_BITS = 24                      # up to 16M slots per shard
_SLOT_MASK = (1 << SLOT_BITS) - 1


def pack_shard_slot(shard, slot) -> Tensor:
    """Encode (shard, local slot) into one int32: shard << SLOT_BITS | slot.
    ``shard`` may be a Python int (no host-to-device copy) or a tensor."""
    slot = torch.as_tensor(slot).to(torch.int32)
    if not isinstance(shard, int):
        shard = torch.as_tensor(shard, device=slot.device).to(torch.int32)
    return (shard << SLOT_BITS) | (slot & _SLOT_MASK)


def unpack_shard_slot(packed) -> Tuple[Tensor, Tensor]:
    """Decode :func:`pack_shard_slot` back to (shard, local slot)."""
    packed = torch.as_tensor(packed).to(torch.int32)
    return packed >> SLOT_BITS, packed & _SLOT_MASK


def _as_tuple(payload):
    return (payload, True) if isinstance(payload, tuple) else ((payload,),
                                                               False)


def local_candidates(scores: Tensor, payload, k: int):
    """Per-shard top-k along the last axis in ``lax.top_k`` order; returns
    (values, payload(s)), each payload broadcast to ``scores`` and gathered
    at the chosen positions."""
    vals, pos = topk_desc(scores, k)
    pays, is_tuple = _as_tuple(payload)
    pos = pos.long()
    out = tuple(torch.broadcast_to(p, scores.shape).gather(-1, pos)
                for p in pays)
    return vals, (out if is_tuple else out[0])


def merge_shards(vals: Sequence[Tensor], payloads: Sequence, k: int,
                 device=None):
    """Global top-k of per-shard candidate tuples.

    ``vals[s]`` is shard s's [..., k_s] values and ``payloads[s]`` one
    tensor or a tuple of tensors shaped like it.  Everything moves to
    ``device`` (default: shard 0's), is concatenated in shard order, and
    the top-k is taken in (value desc, concatenated position asc) order —
    ``merge_over_axes``'s ``lax.top_k`` over the all-gathered tuples.
    Returns (values [..., k], payload(s) [..., k], positions int64 [..., k]
    in the concatenation).
    """
    device = vals[0].device if device is None else torch.device(device)
    pays = [_as_tuple(p) for p in payloads]
    is_tuple = pays[0][1]
    cat_v = torch.cat([v.to(device) for v in vals], dim=-1)
    idx = torch.arange(cat_v.shape[-1], device=device).expand_as(cat_v)
    key = torch.topk(order_key(cat_v, idx), k, dim=-1, largest=False,
                     sorted=True).values
    pos = key & 0xFFFFFFFF                 # the low word: the position
    out = tuple(torch.cat([p[0][j].to(device) for p in pays],
                          dim=-1).gather(-1, pos)
                for j in range(len(pays[0][0])))
    return (cat_v.gather(-1, pos), out if is_tuple else out[0], pos)
