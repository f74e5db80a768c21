"""Bit-packed streaming inverted index (paper §4.1's id-only inverted index).

Per coordinate ``j`` a bitmap over document *slots*:
``bit(j, s) = 1  ⇔  coordinate j is active in the vector at slot s``.
Slot ``s`` lives at word ``s // 32``, bit ``s % 32`` (LSB-first), as in
``repro.core.bitindex``.

The words are stored as **int32** (the reference uses uint32): torch has no
uint32 scatter-add on CUDA, and the bit patterns are the same.  Inserting
adds a word mask and deleting subtracts it; every (row, word, bit) is
touched at most once per batch, so the adds never carry and equal a bitwise
OR / clear, ``1 << 31`` included.  ``(w >> b) & 1`` reads bit ``b`` under
the arithmetic shift too.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

WORD = 32


def n_words(capacity: int) -> int:
    if capacity % WORD != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of {WORD}")
    return capacity // WORD


def empty(n: int, capacity: int, device) -> Tensor:
    return torch.zeros((n, n_words(capacity)), dtype=torch.int32,
                       device=device)


_MASKS = [1 << b for b in range(WORD - 1)] + [-(1 << (WORD - 1))]


def word_mask(slots: Tensor) -> Tensor:
    """int32 word masks ``1 << (slot % 32)``; bit 31 is the sign bit, taken
    from a table so that no signed shift overflows."""
    table = torch.tensor(_MASKS, dtype=torch.int32, device=slots.device)
    return table[(slots % WORD).long()]


def unpack_row(row: Tensor) -> Tensor:
    """int32[..., W] -> bool[..., W*32] membership mask (LSB-first)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=row.device)
    bitsets = (row.unsqueeze(-1) >> shifts) & 1              # [..., W, 32]
    return bitsets.reshape(*row.shape[:-1], row.shape[-1] * WORD).bool()
