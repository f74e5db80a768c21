"""The Sinnamon sketch (paper §4.1, Algorithm 5) in PyTorch.

A sparse vector ``x ∈ R^n`` with active set ``nz(x)`` is compressed into an
upper-bound sketch ``u ∈ R^m`` and a lower-bound sketch ``l ∈ R^m`` using
``h`` random mappings ``π_o : [n] → [m]``:

    u[k] = max { x[j] : j ∈ nz(x), ∃o π_o(j) = k }
    l[k] = min { x[j] : j ∈ nz(x), ∃o π_o(j) = k }

Decoding an active coordinate ``j`` probes the same ``h`` cells:
``x̄[j] = min_o u[π_o(j)]`` (used when ``q[j] > 0``) and
``x̲[j] = max_o l[π_o(j)]`` (used when ``q[j] < 0``), so ``q[j]·decode(j)``
upper-bounds ``q[j]·x[j]`` (Theorem 5.1).

Counterpart of ``repro.core.sketch``; cells come out bit-identical:

* mappings use the same numpy Philox draw, so the ``int32[h, n]`` tables
  are equal;
* narrow cells (bf16, f8 e4m3fn) are rounded *directed* — up in ``u``,
  down in ``l`` — by integer arithmetic on the float32 bit pattern
  (:func:`quantize_directed`).  No float cast to the narrow type is
  involved, so the cells do not depend on whether a backend's cast flushes
  subnormals: f8 values in the subnormal band [2⁻⁹, 2⁻⁶) land on the
  subnormal grid, exactly as the reference's cast-then-step rule gives on
  a cast that keeps subnormals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static configuration of a Sinnamon sketch (see ``EngineSpec``)."""

    n: int
    m: int
    h: int = 1
    positive_only: bool = False   # no lower sketch stored (Sinnamon+ / lite)
    dtype: str = "bfloat16"

    @property
    def tdtype(self) -> torch.dtype:
        return torch_cell_dtype(self.dtype)

    @property
    def sketch_rows(self) -> int:
        return self.m if self.positive_only else 2 * self.m


# ---------------------------------------------------------------------------
# Quantized sketch cells: f32 | bf16 | f8
# ---------------------------------------------------------------------------

_CELL_ALIASES = {
    "f32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f8": "float8_e4m3fn", "float8_e4m3fn": "float8_e4m3fn",
}

#: Lever names accepted by CLIs and configs.
CELL_DTYPES = ("f32", "bf16", "f8")

_TORCH_CELL = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def resolve_cell_dtype(name) -> str:
    """Canonical sketch-cell dtype name from a lever alias.

    Accepts ``f32 | bf16 | f8`` or the canonical names
    (``float32 | bfloat16 | float8_e4m3fn``), and torch dtypes.  The aliases
    are checked before numpy's parser on purpose: to numpy ``"f8"`` means
    float64.
    """
    key = str(name).removeprefix("torch.")
    if key not in _CELL_ALIASES:
        try:
            key = np.dtype(name).name
        except TypeError:
            pass
    if key not in _CELL_ALIASES:
        raise ValueError(f"unknown sketch cell dtype {name!r}; expected one "
                         f"of {CELL_DTYPES} (or a canonical name: "
                         f"{sorted(set(_CELL_ALIASES.values()))})")
    return _CELL_ALIASES[key]


def torch_cell_dtype(name) -> torch.dtype:
    return _TORCH_CELL[resolve_cell_dtype(name)]


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def cell_bits(cells: Tensor) -> Tensor:
    """Integer view of a cell tensor.  Indexing, scatter and select work
    through it for every cell dtype, float8 on the CPU included."""
    return cells.view(_INT_VIEW[cells.element_size()])


def cell_rows(cells: Tensor, r: Tensor) -> Tensor:
    """Rows ``r`` of a cell matrix, decoded to float32."""
    return cell_bits(cells)[r].view(cells.dtype).to(torch.float32)


def sortable_bits(x: Tensor) -> Tensor:
    """int32 keys whose order is the float32 order of ``x`` (-0.0 below
    +0.0, -inf lowest)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF)


def make_mappings(seed: int, n: int, m: int, h: int) -> np.ndarray:
    """h uniform random mappings [n] -> [m] as an int32[h, n] table
    (numpy Philox, the same draw as the reference)."""
    gen = np.random.Generator(np.random.Philox(key=seed))
    return gen.integers(0, m, size=(h, n), dtype=np.int32)


# ---------------------------------------------------------------------------
# Directed rounding on the float32 bit pattern
# ---------------------------------------------------------------------------

_F8_MAX = 448.0
_BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def _f8_codes(x: Tensor, toward_pos_inf: bool) -> Tensor:
    """uint8 e4m3fn codes of ``x`` (f32) rounded toward ±inf.

    The magnitude is first truncated toward zero onto the f8 grid: above
    the smallest normal 2⁻⁶ by clearing the low 20 mantissa bits, below it
    onto the subnormal grid of step 2⁻⁹.  Where that was inexact and the
    direction points away from zero, the code steps up by one (which also
    crosses from the subnormal into the normal range correctly).  The sign
    bit is kept, so a negative value rounded up to zero gives -0.0 — the
    cell the reference produces too.
    """
    x = x.clamp(-_F8_MAX, _F8_MAX)
    neg = torch.signbit(x)
    a = x.abs()
    bits = a.view(torch.int32)
    normal = a >= 2.0 ** -6
    # normal range: exponent field e+7 (4 bits), top 3 mantissa bits
    exp8 = (bits >> 23) - 120
    code_n = (exp8 << 3) | ((bits >> 20) & 7)
    exact_n = (bits & ((1 << 20) - 1)) == 0
    # subnormal range: multiples of 2**-9 (scaling by 512 is exact)
    scaled = a * 512.0
    code_s = torch.floor(scaled).to(torch.int32)
    exact_s = code_s.to(torch.float32) == scaled
    code = torch.where(normal, code_n, code_s)
    exact = torch.where(normal, exact_n, exact_s)
    away = neg if not toward_pos_inf else ~neg
    code = code + (~exact & away).to(torch.int32)
    code = code | (neg.to(torch.int32) << 7)
    return code.to(torch.uint8)


def _bf16_codes(x: Tensor, toward_pos_inf: bool) -> Tensor:
    """int16 bf16 bit patterns of ``x`` (f32) rounded toward ±inf."""
    x = x.clamp(-_BF16_MAX, _BF16_MAX)
    neg = torch.signbit(x)
    bits = x.view(torch.int32)
    mag = (bits >> 16) & 0x7FFF
    exact = (bits & 0xFFFF) == 0
    away = neg if not toward_pos_inf else ~neg
    mag = mag + (~exact & away).to(torch.int32)
    code = mag | (neg.to(torch.int32) << 15)
    return code.to(torch.int16)       # values < 2**16 wrap to the same bits


def quantize_directed(x: Tensor, dtype, toward_pos_inf: bool) -> Tensor:
    """Cast f32 -> cell dtype rounding toward +inf (u) or -inf (l).

    Values beyond the format's largest finite magnitude saturate there
    (e4m3fn has no inf), as in the reference.
    """
    x = x.to(torch.float32)
    name = resolve_cell_dtype(dtype)
    if name == "float32":
        return x
    if name == "bfloat16":
        return _bf16_codes(x, toward_pos_inf).view(torch.bfloat16)
    return _f8_codes(x, toward_pos_inf).view(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# Encode (Algorithm 5) / decode (Algorithm 6 inner step)
# ---------------------------------------------------------------------------

def encode_batch(mappings: Tensor, m: int, idx: Tensor, val: Tensor,
                 dtype="bfloat16", positive_only: bool = False
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Sketch a batch of padded sparse vectors -> (u[B, m], l[B, m]).

    ``idx`` int32/int64[B, P] padded with -1, ``val`` [B, P].  The segment
    max / min of the reference become ``scatter_reduce_`` from ∓inf; cells
    that receive no value are 0.  ``l`` is None when ``positive_only``.
    """
    B, P = idx.shape
    h = mappings.shape[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    targets = mappings[:, safe].permute(1, 0, 2).reshape(B, h * P).long()
    vals = val.to(torch.float32).unsqueeze(1).expand(B, h, P).reshape(B, h * P)
    ok = valid.unsqueeze(1).expand(B, h, P).reshape(B, h * P)
    inf = torch.tensor(float("inf"), device=val.device)

    u = torch.full((B, m), -float("inf"), dtype=torch.float32,
                   device=val.device)
    u.scatter_reduce_(1, targets, torch.where(ok, vals, -inf), "amax")
    u = torch.where(torch.isneginf(u), 0.0, u)
    u = quantize_directed(u, dtype, toward_pos_inf=True)
    if positive_only:
        return u, None
    l = torch.full((B, m), float("inf"), dtype=torch.float32,
                   device=val.device)
    l.scatter_reduce_(1, targets, torch.where(ok, vals, inf), "amin")
    l = torch.where(torch.isposinf(l), 0.0, l)
    l = quantize_directed(l, dtype, toward_pos_inf=False)
    return u, l


def encode(mappings: Tensor, m: int, idx: Tensor, val: Tensor,
           dtype="bfloat16", positive_only: bool = False
           ) -> Tuple[Tensor, Optional[Tensor]]:
    """Sketch one sparse vector -> (u[m], l[m]) (l is None for Sinnamon+)."""
    u, l = encode_batch(mappings, m, idx[None], val[None], dtype,
                        positive_only)
    return u[0], None if l is None else l[0]


def decode_coord(mappings: Tensor, u: Tensor, l: Optional[Tensor], j):
    """Least-upper / greatest-lower bounds of coordinate ``j`` for every
    column: (ub[...], lb[...]); ``lb`` is zeros when ``l`` is None."""
    rows = mappings[:, j].long()                            # [h]
    ub = cell_rows(u, rows).amin(dim=0)
    if l is None:
        return ub, torch.zeros_like(ub)
    return ub, cell_rows(l, rows).amax(dim=0)


def decode_vector(mappings: Tensor, u: Tensor, l: Optional[Tensor],
                  idx: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-coordinate (ub, lb) of sketched vectors: u, l [..., m] (one
    sketch per leading index), idx [..., P] active coordinates (pad -1).
    ``lb`` is zeros when ``l`` is None.  The §5 error analysis decodes
    through this."""
    safe = torch.where(idx >= 0, idx, 0).long()
    rows = mappings[:, safe].long()                         # [h, ..., P]

    def cells(s: Tensor) -> Tensor:
        x = s.to(torch.float32)
        return torch.stack([torch.gather(x, -1, r) for r in rows])

    ub = cells(u).amin(dim=0)
    if l is None:
        return ub, torch.zeros_like(ub)
    return ub, cells(l).amax(dim=0)
