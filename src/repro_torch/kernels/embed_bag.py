"""Kernel D: weighted-sum embedding bags (gather + per-bag reduce).

Replaces the Pallas TPU kernel ``embed_bag`` of
``repro/kernels/embed_bag.py``.  The CUDA source is ``csrc/embed_bag.cu``;
its header says what bounds the kernel on an H100 (the bytes of the rows it
gathers and of its output) and how the design meets that (32 bags a warp
with their indices loaded once, a cp.async ring that keeps 16 rows in
flight a lane group (U = 4 loads into registers for single-element rows),
streaming stores, an occupancy-sized grid, 64-bit row offsets).

:func:`embed_bag` has two forms, each one launch:

* flat: ``table`` [V, D], ``indices`` int32[B, hot], ``weights``
  f32[B, hot] or None → f32[B, D], the TPU kernel's function;
* stacked: ``tables`` [F, V, D], ``indices`` int32[B, F, hot] as a DLRM
  request holds them → f32[B, F, D]; bag (b, f) sums rows of table f.  No
  field-offset index array is built: the kernel adds f·V·D itself.

Each slot's row times its weight (1 where ``weights`` is None) is summed
over the slots in order; a slot with index -1 adds nothing.  ``out``, a
[B, D] or [B, F, D] f32 view with unit column stride (DLRM passes
``vecs[:, 1:]`` of its [B, F+1, D] interaction buffer), receives the bags
in place of a new tensor.  The wrapper launches the kernel for CUDA tensors
and raises if the build or the launch fails; for CPU tensors it runs the
plain twins :func:`embed_bag_plain` / :func:`stacked_embed_bag_plain`.
Kernel and twins run the same float program (``acc = acc + row * w`` per
slot, pads skipped), so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1}


def embed_bag_plain(table: Tensor, indices: Tensor,
                    weights: Optional[Tensor] = None) -> Tensor:
    """Plain-torch twin of the flat form: f32[B, D] bags of ``table``
    [V, D] rows picked by ``indices`` int32[B, F] (pad -1) and scaled by
    ``weights`` f32[B, F] (None: 1), summed over the slots in order."""
    B, F = indices.shape
    out = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    for f in range(F):
        rows = table[safe[:, f]].to(torch.float32)
        if weights is not None:
            rows = rows * weights[:, f, None]
        out = torch.where(valid[:, f, None], out + rows, out)
    return out


def stacked_embed_bag_plain(tables: Tensor, indices: Tensor,
                            weights: Optional[Tensor] = None) -> Tensor:
    """Plain-torch twin of the stacked form: f32[B, F, D] bags, bag (b, f)
    of ``tables[f]`` rows picked by ``indices[b, f]`` (pad -1), scaled by
    ``weights[b, f]`` (None: 1), summed over the slots in order."""
    B, F, hot = indices.shape
    out = torch.zeros((B, F, tables.shape[2]), dtype=torch.float32,
                      device=tables.device)
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    field = torch.arange(F, device=tables.device)[None, :]
    for s in range(hot):
        rows = tables[field, safe[:, :, s]].to(torch.float32)
        if weights is not None:
            rows = rows * weights[:, :, s, None]
        out = torch.where(valid[:, :, s, None], out + rows, out)
    return out


class Plan(NamedTuple):
    """The arguments of one launch that depend on the operands' layout."""
    kind: int            # table element type: 0 f32, 1 bf16
    vec: int             # elements a lane loads at once (16 bytes' worth:
                         # the cp.async ring; 1: loads into registers)
    group: int           # lanes a row
    fields: int          # F (1: flat)
    field_stride: int    # elements between two fields' tables (0: flat)
    out_bstride: int     # elements between bags b and b + 1 of ``out``
    out_fstride: int     # elements between fields f and f + 1 of ``out``


def row_plan(dtype: torch.dtype, D: int, aligned: bool):
    """(kind, vec, group) for rows of D ``dtype`` elements: 16 bytes' worth
    a lane where a row is a whole number of 16-byte chunks and every
    address is 16-byte aligned (``aligned``), else one element; lanes a row
    the smallest power of two that covers its loads, at most 32."""
    element_size = torch.empty((), dtype=dtype).element_size()
    vec = 16 // element_size
    if not aligned or (D * element_size) % 16:
        vec = 1
    chunks = max(1, D // vec)
    group = min(32, 1 << (chunks - 1).bit_length())
    return _TABLE_KIND[dtype], vec, group


def launch_plan(table: Tensor, out: Optional[Tensor] = None) -> Plan:
    """The launch's :class:`Plan` for ``table`` ([V, D] or [F, V, D]) and
    the output view ``out`` ([B, D] or [B, F, D]; None: a fresh contiguous
    one, which the caching allocator aligns to 512 B): field stride V·D for
    a stacked table, the output's strides, and 16-byte loads and stores only
    where the table, the output and its strides are all 16-byte aligned."""
    stacked = table.dim() == 3
    F = table.shape[0] if stacked else 1
    D = table.shape[-1]
    if out is None:
        s_b, s_f, out_aligned = F * D, D, True
    else:
        s_b = out.stride(0)
        s_f = out.stride(1) if stacked else D
        out_aligned = out.data_ptr() % 16 == 0
    aligned = (table.data_ptr() % 16 == 0 and out_aligned
               and s_b % 4 == 0 and s_f % 4 == 0)
    return Plan(*row_plan(table.dtype, D, aligned),
                fields=F,
                field_stride=table.shape[1] * D if stacked else 0,
                out_bstride=s_b, out_fstride=s_f)


def _bad(name: str, t: Tensor, want: str) -> ValueError:
    return ValueError(f"{name}: want {want}, got {t.dtype} "
                      f"{tuple(t.shape)} stride {t.stride()} on {t.device}")


def check_operands(table: Tensor, indices: Tensor,
                   weights: Optional[Tensor], out: Optional[Tensor]) -> None:
    """Raise ValueError for what the kernel cannot take: a table not f32 or
    bf16, [V, D] or [F, V, D] and contiguous; indices not int32, contiguous,
    [B, hot] or [B, F, hot] with the tables' F and hot >= 1; weights not
    f32 of the indices' shape; an ``out`` not an f32 [B, D] or [B, F, D]
    view with unit column stride and bags that do not overlap; operands on
    different devices."""
    dev, nd = table.device, table.dim()
    if table.dtype not in _TABLE_KIND or nd not in (2, 3) \
            or not table.is_contiguous():
        raise _bad("table", table, "a contiguous f32/bf16 [V, D] or "
                   "[F, V, D] tensor")
    if indices.dtype != torch.int32 or indices.dim() != nd \
            or indices.device != dev or not indices.is_contiguous() \
            or indices.shape[-1] < 1 \
            or (nd == 3 and indices.shape[1] != table.shape[0]):
        form = "[B, F, hot]" if nd == 3 else "[B, hot]"
        raise _bad("indices", indices, f"contiguous int32 {form} on {dev} "
                   f"with the table's fields and hot >= 1")
    if weights is not None and (
            weights.dtype != torch.float32 or weights.device != dev
            or weights.shape != indices.shape
            or not weights.is_contiguous()):
        raise _bad("weights", weights, f"contiguous f32 "
                   f"{tuple(indices.shape)} on {dev}")
    if out is not None:
        want = (*indices.shape[:-1], table.shape[-1])
        D = want[-1]
        ok = (out.dtype == torch.float32 and out.device == dev
              and tuple(out.shape) == want and out.stride(-1) == 1)
        if ok and nd == 3:
            ok = out.stride(1) >= D and out.stride(0) >= want[1] * \
                out.stride(1)
        elif ok:
            ok = out.stride(0) >= D
        if not ok:
            raise _bad("out", out, f"an f32 view {want} on {dev} with unit "
                       f"column stride and non-overlapping bags")


class _Launch(ctypes.Structure):
    """``struct Launch`` of ``csrc/embed_bag.cu``, field for field."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "field_stride", "n_bags", "out_bstride", "out_fstride")] + [
        (n, ctypes.c_int) for n in ("table_kind", "vec", "D", "F", "hot",
                                    "group", "sms", "pad")]


_FNS: dict = {}                 # the launcher of each loaded library
#: Launch structs by operand layout (:func:`layout_key`); a serving process
#: sees a few layouts, and the table is emptied past 256.
_LAUNCHES: dict = {}


def _launcher():
    lib = _build.load("embed_bag")              # a failed build raises here
    fn = _FNS.get(lib._name)
    if fn is None:
        # PyDLL: the call keeps the GIL, which a launch of a few
        # microseconds does not need to release
        fn = ctypes.PyDLL(lib._name).embed_bag_launch
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        _FNS[lib._name] = fn
    return fn


def layout_key(table: Tensor, indices: Tensor, weights: Optional[Tensor],
               out: Optional[Tensor]) -> tuple:
    """The operands' layout: all that :func:`check_operands` and
    :func:`launch_plan` read, so a layout seen before passed the checks and
    has its launch struct."""
    return (table.dtype, table.shape, table.is_contiguous(), table.device,
            table.data_ptr() % 16, indices.dtype, indices.shape,
            indices.is_contiguous(), indices.device,
            None if weights is None else (
                weights.dtype, weights.shape, weights.is_contiguous(),
                weights.device),
            None if out is None else (out.dtype, out.shape, out.stride(),
                                      out.device, out.data_ptr() % 16))


def _launch(table: Tensor, indices: Tensor, weights: Optional[Tensor],
            out: Optional[Tensor] = None) -> Tensor:
    key = layout_key(table, indices, weights, out)
    entry = _LAUNCHES.get(key)
    if entry is None:
        check_operands(table, indices, weights, out)
    fn = _launcher()
    if entry is None:
        if len(_LAUNCHES) >= 256:
            _LAUNCHES.clear()
        entry = _LAUNCHES[key] = _new_launch(table, indices, out)
    dev = table.device
    if out is None:
        out = torch.empty((*indices.shape[:-1], table.shape[-1]),
                          dtype=torch.float32, device=dev)
    if entry[1] is None:
        return out                          # nothing to compute
    err = fn(entry[0], table.data_ptr(), indices.data_ptr(),
             None if weights is None else weights.data_ptr(),
             out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "embed_bag")
    embed_bag.launches += 1
    return out


def _new_launch(table: Tensor, indices: Tensor, out: Optional[Tensor]):
    """(address of the launch struct, the struct), the struct None where
    there is no bag or no column.  The address is valid only while the
    struct is held."""
    D = table.shape[-1]
    p = launch_plan(table, out)
    n_bags = indices.shape[0] * p.fields
    if n_bags == 0 or D == 0:
        return 0, None
    st = _Launch(p.field_stride, n_bags, p.out_bstride, p.out_fstride,
                 p.kind, p.vec, D, p.fields,
                 indices.shape[-1], p.group, _build.sm_count(table.device), 0)
    return ctypes.addressof(st), st


def embed_bag(table: Tensor, indices: Tensor,
              weights: Optional[Tensor] = None, *,
              out: Optional[Tensor] = None,
              use_kernel: Optional[bool] = None) -> Tensor:
    """Weighted-sum bags, f32[B, D] (flat) or f32[B, F, D] (stacked), in
    ``out`` when given.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin; True on CPU
    tensors raises.  Indices must lie in [-1, V).
    """
    if use_kernel is None:
        use_kernel = table.is_cuda
    if use_kernel:
        if not table.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        return _launch(table, indices, weights, out)
    plain = embed_bag_plain if table.dim() == 2 else stacked_embed_bag_plain
    bags = plain(table, indices, weights)
    if out is None:
        return bags
    return out.copy_(bags)


embed_bag.launches = 0
