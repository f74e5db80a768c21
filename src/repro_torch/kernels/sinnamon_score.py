"""Kernel A: fused Algorithm 6 candidate generation (score → per-tile top-kp).

Replaces the Pallas TPU kernel ``sinnamon_score_topk`` of
``repro/kernels/sinnamon_score.py``.  The CUDA source is
``csrc/sinnamon_score.cu``; its header says what bounds the kernel on an
H100 (bitmap and sketch bytes) and how the design meets that.

:func:`sinnamon_score_topk` launches the kernel for CUDA tensors and raises
if the build or the launch fails; for CPU tensors it runs the plain twin
:func:`sinnamon_score_topk_plain`, which computes the same function with
the same per-slot float program (coordinates added one at a time, in
order), so the two agree bit for bit on the card.
:func:`merge_tile_topk` merges the per-tile buffers into the global
top-k' — plain torch, as the merge is XLA in the reference.

Operands differ from the TPU kernel's in one place: membership comes as
``brows`` (each coordinate's bitmap row, -1 for a padded coordinate) plus
the bitmap ``bits`` itself, instead of pre-gathered words.  The kernel
reads the words it needs; at a 1.1M-slot shard the pre-gathered block
would be L·C/8 bytes per query.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import bitindex, sketch
from repro_torch.kernels import _build

Tensor = torch.Tensor

#: Slots per block of the CUDA kernel (``kTileC`` in the source).
TILE_C = 8192

_CELL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_TWO32 = 1 << 32


# -- the (score desc, slot asc) order key -------------------------------------

def order_key(vals: Tensor, slots: Tensor) -> Tensor:
    """int64 key whose ascending order is (score desc, slot asc).

    High word: the float32 bits of the score made order-preserving and
    inverted; low word: the slot (non-negative).  Built exactly as the CUDA
    kernel builds it.
    """
    hi = torch.bitwise_not(sketch.sortable_bits(vals)).to(torch.int64)
    return hi * _TWO32 + slots.to(torch.int64)


def split_key(key: Tensor):
    """Inverse of :func:`order_key`: (vals f32, slots int32)."""
    hi = torch.div(key, _TWO32, rounding_mode="floor")
    slots = (key - hi * _TWO32).to(torch.int32)
    sortable = torch.bitwise_not(hi.to(torch.int32))
    bits = torch.where(sortable >= 0, sortable, sortable ^ 0x7FFFFFFF)
    return bits.view(torch.float32), slots


def topk_desc(vals: Tensor, k: int):
    """Top-k along the last axis in (value desc, index asc) order — the tie
    order of ``lax.top_k``.  Returns (vals, idx int32)."""
    idx = torch.arange(vals.shape[-1], device=vals.device).expand_as(vals)
    key = torch.topk(order_key(vals, idx), k, dim=-1, largest=False,
                     sorted=True).values
    return split_key(key)


def merge_tile_topk(vals: Tensor, slots: Tensor, kprime: int):
    """Per-tile candidates [B, T, kp] -> global top-kprime [B, kprime].

    One selection on the (score desc, slot asc) key over all tiles: the
    order of a dense ``lax.top_k``, including the all -inf tail when fewer
    than kprime slots survive the gate.  Needs T * kp >= kprime.
    """
    B = vals.shape[0]
    key = order_key(vals, slots).reshape(B, -1)
    key = torch.topk(key, kprime, dim=-1, largest=False, sorted=True).values
    return split_key(key)


# -- plain twin -----------------------------------------------------------------

def sinnamon_score_topk_plain(qv: Tensor, rows: Tensor, brows: Tensor,
                              bits: Tensor, ok: Tensor, skmat: Tensor, *,
                              kp: int, tile_c: int = TILE_C,
                              one_sided: bool = True):
    """Plain-torch twin of the kernel: same operands, same result.

    qv f32[B, L]; rows int32[B, L, h] (pre-offset by +m for negative
    coordinates when ``one_sided``); brows int32[B, L] (-1 = padded);
    bits int32[nrows, C/32]; ok bool[C]; skmat [R, C].  Returns
    (vals f32[B, T, kp], slots int32[B, T, kp]) with T = ceil(C / tile_c);
    slots past C are gated to -inf.
    """
    B, L = qv.shape
    h = rows.shape[-1]
    C = skmat.shape[1]
    if kp > tile_c:
        raise ValueError(f"kp={kp} cannot exceed tile_c={tile_c}")
    T = -(-C // tile_c)
    pos = qv > 0
    acc = torch.zeros((B, C), dtype=torch.float32, device=qv.device)
    for t in range(L):
        r = rows[:, t].long()                               # [B, h]
        x = sketch.cell_rows(skmat, r[:, 0])                # [B, C]
        p = pos[:, t, None]
        for o in range(1, h):
            y = sketch.cell_rows(skmat, r[:, o])
            if one_sided:
                x = torch.where(p, torch.minimum(x, y), torch.maximum(x, y))
            else:
                x = torch.minimum(x, y)
        if not one_sided:
            x = torch.where(p, x, 0.0)
        contrib = qv[:, t, None] * x
        br = brows[:, t]
        mask = bitindex.unpack_row(bits[br.clamp_min(0).long()])
        mask = mask & (br >= 0)[:, None]
        acc = acc + torch.where(mask, contrib, 0.0)
    s = torch.where(ok[None, :], acc, -torch.inf)
    s = torch.nn.functional.pad(s, (0, T * tile_c - C), value=-torch.inf)
    slot_ids = torch.arange(T * tile_c, device=qv.device).expand(B, -1)
    key = order_key(s, slot_ids).reshape(B, T, tile_c)
    key = torch.topk(key, kp, dim=-1, largest=False, sorted=True).values
    return split_key(key)


# -- CUDA kernel ----------------------------------------------------------------

def _lib():
    lib = _build.load("sinnamon_score")
    fn = lib.sinnamon_topk_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.sinnamon_tile_c.argtypes = []
        lib.sinnamon_tile_c.restype = ctypes.c_int
        if lib.sinnamon_tile_c() != TILE_C:
            raise _build.KernelBuildFailure(
                f"kernel tile {lib.sinnamon_tile_c()} != TILE_C {TILE_C}")
    return lib


def _check(t: Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} with {ndim} dims "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _launch(qv, rows, brows, bits, ok, skmat, kp, one_sided):
    if kp > TILE_C:
        raise ValueError(f"kp={kp} cannot exceed TILE_C={TILE_C}")
    dev = qv.device
    B, L = qv.shape
    h = rows.shape[-1]
    R, C = skmat.shape
    _check(qv, "qv", torch.float32, 2, dev)
    _check(rows, "rows", torch.int32, 3, dev)
    _check(brows, "brows", torch.int32, 2, dev)
    _check(bits, "bits", torch.int32, 2, dev)
    _check(ok, "ok", torch.bool, 1, dev)
    if skmat.dtype not in _CELL_KIND:
        raise ValueError(f"skmat dtype {skmat.dtype} not supported")
    _check(skmat, "skmat", skmat.dtype, 2, dev)
    if rows.shape[:2] != (B, L) or brows.shape != (B, L) or ok.shape != (C,) \
            or bits.shape[1] * bitindex.WORD != C:
        raise ValueError("operand shapes disagree: "
                         f"qv {tuple(qv.shape)} rows {tuple(rows.shape)} "
                         f"brows {tuple(brows.shape)} ok {tuple(ok.shape)} "
                         f"bits {tuple(bits.shape)} skmat {tuple(skmat.shape)}")
    smem = TILE_C * 8 + L * (2 + h) * 4
    if smem > _build.SMEM_PER_BLOCK:
        raise ValueError(f"L={L}, h={h} need {smem} B of shared memory")
    T = -(-C // TILE_C)
    vals = torch.empty((B, T, kp), dtype=torch.float32, device=dev)
    slots = torch.empty((B, T, kp), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, slots
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().sinnamon_topk_launch(
        _CELL_KIND[skmat.dtype], qv.data_ptr(), rows.data_ptr(),
        brows.data_ptr(), bits.data_ptr(), ok.data_ptr(), skmat.data_ptr(),
        B, L, h, C, bits.shape[1], kp, int(one_sided), T,
        vals.data_ptr(), slots.data_ptr(), stream)
    _build.check(err, "sinnamon_score_topk")
    sinnamon_score_topk.launches += 1
    return vals, slots


def sinnamon_score_topk(qv: Tensor, rows: Tensor, brows: Tensor,
                        bits: Tensor, ok: Tensor, skmat: Tensor, *, kp: int,
                        one_sided: bool = True,
                        use_kernel: Optional[bool] = None):
    """Fused scoring + per-tile top-kp over tiles of ``TILE_C`` slots:
    (vals f32[B, T, kp], slots int32[B, T, kp]); feed to
    :func:`merge_tile_topk`.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin (the comparison
    path); True on CPU tensors raises.
    """
    if use_kernel is None:
        use_kernel = qv.is_cuda
    if use_kernel:
        if not qv.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        return _launch(qv, rows, brows, bits, ok, skmat, kp, one_sided)
    return sinnamon_score_topk_plain(qv, rows, brows, bits, ok, skmat, kp=kp,
                                     one_sided=one_sided)


sinnamon_score_topk.launches = 0
