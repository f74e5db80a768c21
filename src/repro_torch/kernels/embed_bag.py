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

The gradient with respect to the table is a second kernel,
``csrc/embed_bag_backward.cu`` (:func:`embed_bag_backward`; the TPU kernel
has none: the reference differentiates its jnp gather).  Its operand prep
sorts the (row, slot) pairs stably by row (:func:`backward_operands`);
the kernel (:func:`backward_kernel`, planned by :func:`backward_plan`)
gives each block spans of output rows, streams a span's zeros out and
stores each named row's bag gradients, summed in slot order, over its
zeros, so every row of the dense [F, V, D] (or [V, D]) gradient has one
writer, two launches give the same bits and the plain
twin :func:`embed_bag_backward_plain` (``index_add_`` in slot order) the
same bits too.  :class:`EmbedBag` puts the forward and the backward
together under autograd; the weights take no gradient.
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


# ---------------------------------------------------------------------------
# The backward: d(bags) / d(table)
# ---------------------------------------------------------------------------

def embed_bag_backward_plain(grad_bags: Tensor, indices: Tensor, V: int,
                             weights: Optional[Tensor] = None) -> Tensor:
    """Plain-torch twin of :func:`embed_bag_backward`: ``index_add_`` of
    each valid slot's bag gradient (times its weight) into its row, the
    slots in order (b, f, j).  f32 [F, V, D] from ``grad_bags`` [B, F, D]
    and ``indices`` [B, F, hot]; [V, D] from [B, D] and [B, hot]."""
    stacked = indices.dim() == 3
    B, hot = indices.shape[0], indices.shape[-1]
    F = indices.shape[1] if stacked else 1
    D = grad_bags.shape[-1]
    src = grad_bags.to(torch.float32).reshape(B, F, 1, D).expand(
        B, F, hot, D)
    if weights is not None:
        src = src * weights.reshape(B, F, hot, 1)
    offs = torch.arange(F, device=indices.device)[None, :, None] * V
    # a pad adds into a spare last row (no data-dependent shapes, so the
    # twin also runs on meta and fake tensors)
    rows = torch.where(indices.reshape(B, F, hot) >= 0,
                       indices.reshape(B, F, hot).long() + offs, F * V)
    out = torch.zeros((F * V + 1, D), dtype=torch.float32,
                      device=grad_bags.device)
    out.index_add_(0, rows.reshape(-1), src.reshape(-1, D))
    out = out[:F * V]
    return out.view(F, V, D) if stacked else out


def backward_operands(indices: Tensor, V: int):
    """The operand prep of the backward kernel: each slot's output row
    (f·V + index; a pad gets the sentinel F·V, which sorts last), sorted
    stably, and the slot of each sorted entry.  Returns (keys int32[n],
    slots int64[n]), n = B·F·hot."""
    F = indices.shape[1] if indices.dim() == 3 else 1
    idx = indices.reshape(indices.shape[0], F, indices.shape[-1])
    offs = (torch.arange(F, dtype=torch.int32, device=indices.device)
            * V)[None, :, None]
    keys = torch.where(idx >= 0, idx + offs, F * V).reshape(-1)
    keys, slots = torch.sort(keys, stable=True)
    return keys.to(torch.int32).contiguous(), slots.contiguous()


def check_backward_operands(grad_bags: Tensor, indices: Tensor, V: int,
                            weights: Optional[Tensor]) -> None:
    """Raise ValueError for what the backward kernel cannot take:
    ``grad_bags`` not f32 [B, F, D] / [B, D] with unit column stride,
    indices not contiguous int32 [B, F, hot] /
    [B, hot] of the gradient's bags, weights not contiguous f32 of the
    indices' shape, F·V rows outside [0, 2**31), operands on different
    devices."""
    dev = grad_bags.device
    nd = grad_bags.dim()
    if grad_bags.dtype != torch.float32 or nd not in (2, 3) \
            or (grad_bags.numel() and grad_bags.stride(-1) != 1):
        raise _bad("grad_bags", grad_bags, "an f32 [B, F, D] or [B, D] "
                   "view with unit column stride")
    if indices.dtype != torch.int32 or indices.dim() != nd \
            or indices.device != dev or not indices.is_contiguous() \
            or tuple(indices.shape[:-1]) != tuple(grad_bags.shape[:-1]) \
            or indices.shape[-1] < 1:
        raise _bad("indices", indices, f"contiguous int32 "
                   f"{tuple(grad_bags.shape[:-1])} + (hot >= 1,) on {dev}")
    if weights is not None and (
            weights.dtype != torch.float32 or weights.device != dev
            or weights.shape != indices.shape
            or not weights.is_contiguous()):
        raise _bad("weights", weights, f"contiguous f32 "
                   f"{tuple(indices.shape)} on {dev}")
    F = indices.shape[1] if nd == 3 else 1
    if V < 0 or F * V >= 2**31:
        raise ValueError(f"{F}×{V} rows: want 0 <= F·V < 2**31 (int32 "
                         f"row keys)")


#: f32 a span holds (16 KB): R = max(1, SPAN_FLOATS // D) output rows.
SPAN_FLOATS = 4096


class BackwardPlan(NamedTuple):
    """The launch of the backward kernel, from shapes and alignment."""
    n: int               # slots: B·F·hot
    rows: int            # output rows: F·V
    span_rows: int       # R: output rows a block owns at a time
    n_spans: int         # ceil(rows / R)
    group: int           # lanes a run: D / 4 (16-byte loads) or D, at
                         # most 32, rounded up to a power of two
    vec4: int            # 16-byte gradient loads
    wide: int            # 16-byte stores to the output
    smem_bytes: int      # R run heads of 8 B


def backward_plan(B: int, F: int, hot: int, V: int, D: int, *,
                  grad_aligned: bool = True,
                  out_aligned: bool = True) -> BackwardPlan:
    """The :class:`BackwardPlan` for ``grad_bags`` [B, F, D] (F = 1: flat)
    and ``hot`` slots a bag over V rows a field.  ``grad_aligned``: the
    gradient's base and strides are 16-byte aligned; ``out_aligned``: the
    output is.  Raises ValueError where the kernel's 32-bit positions and
    rows do not reach: B·F·hot or F·V >= 2**31."""
    n, rows = B * F * hot, F * V
    if n >= 2**31 or rows >= 2**31 or min(B, F, hot, V) < 0 or D < 1:
        raise ValueError(f"{B}×{F}×{hot} slots over {F}×{V} rows of "
                         f"{D}: want B·F·hot and F·V below 2**31 (int32 "
                         f"positions and rows), D >= 1")
    R = max(1, SPAN_FLOATS // D)
    vec4 = int(D % 4 == 0 and grad_aligned)
    lanes = D // 4 if vec4 else D
    group = min(32, 1 << (lanes - 1).bit_length())
    return BackwardPlan(n, rows, R, -(-rows // R), group, vec4,
                        int(D % 4 == 0 and out_aligned), R * 8)


class _BackwardLaunch(ctypes.Structure):
    """``struct BackwardLaunch`` of ``csrc/embed_bag_backward.cu``."""
    _fields_ = [(n, ctypes.c_longlong) for n in ("g_bstride", "g_fstride")] \
        + [(n, ctypes.c_int) for n in (
            "n", "rows", "D", "F", "hot", "span_rows", "group", "vec4",
            "wide", "sms")]


def _backward_launcher():
    lib = _build.load("embed_bag_backward")     # a failed build raises here
    fn = _FNS.get(lib._name)
    if fn is None:
        fn = ctypes.PyDLL(lib._name).embed_bag_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 8
        fn.restype = ctypes.c_int
        _FNS[lib._name] = fn
    return fn


def backward_kernel(grad_bags: Tensor, keys: Tensor, slots: Tensor,
                    hot: int, V: int,
                    weights: Optional[Tensor] = None) -> Tensor:
    """One launch of the backward kernel on prepared operands: ``keys`` and
    ``slots`` from :func:`backward_operands` of the int32 indices with
    ``hot`` slots a bag, ``grad_bags`` and ``weights`` as
    :func:`embed_bag_backward` takes them (checked there).  Returns f32
    [F, V, D] (stacked) or [V, D] (flat)."""
    stacked = grad_bags.dim() == 3
    B, D = grad_bags.shape[0], grad_bags.shape[-1]
    F = grad_bags.shape[1] if stacked else 1
    dev = grad_bags.device
    if keys.dtype != torch.int32 or slots.dtype != torch.int64 \
            or keys.shape != (B * F * hot,) or slots.shape != keys.shape \
            or keys.device != dev or slots.device != dev \
            or not (keys.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"keys / slots: want contiguous int32 / int64 "
                         f"[{B * F * hot}] on {dev}")
    fn = _backward_launcher()
    out = torch.empty((F * V, D), dtype=torch.float32, device=dev)
    if out.numel():
        s_b = grad_bags.stride(0)
        s_f = grad_bags.stride(1) if stacked else 0
        p = backward_plan(
            B, F, hot, V, D,
            grad_aligned=(grad_bags.data_ptr() % 16 == 0 and s_b % 4 == 0
                          and s_f % 4 == 0),
            out_aligned=out.data_ptr() % 16 == 0)
        st = _BackwardLaunch(s_b, s_f, p.n, p.rows, D, F, hot, p.span_rows,
                             p.group, p.vec4, p.wide, _build.sm_count(dev))
        starts = torch.empty(p.n_spans + 1, dtype=torch.int32, device=dev)
        err = fn(ctypes.addressof(st), grad_bags.data_ptr(),
                 keys.data_ptr(), slots.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 starts.data_ptr(), out.data_ptr(),
                 torch._C._cuda_getCurrentRawStream(dev.index))
        _build.check(err, "embed_bag_backward")
        embed_bag_backward.launches += 1
    return out.view(F, V, D) if stacked else out


def embed_bag_backward(grad_bags: Tensor, indices: Tensor, V: int,
                       weights: Optional[Tensor] = None, *,
                       use_kernel: Optional[bool] = None) -> Tensor:
    """The gradient of the bag sums with respect to the table: f32
    [F, V, D] (stacked: ``grad_bags`` [B, F, D], any row and field stride,
    ``indices`` int32[B, F, hot]) or [V, D] (flat: [B, D] and [B, hot]).
    Row (f, v) sums ``grad_bags[b, f] * weights[b, f, j]`` (weight 1 where
    ``weights`` is None) over every slot (b, f, j) naming v, in slot order;
    rows no slot names are 0.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors (after
    :func:`backward_operands`, through :func:`backward_kernel`) and runs
    :func:`embed_bag_backward_plain` for CPU tensors; False forces the
    twin; True on CPU tensors raises.
    """
    check_backward_operands(grad_bags, indices, V, weights)
    if use_kernel is None:
        use_kernel = grad_bags.is_cuda
    if not use_kernel:
        return embed_bag_backward_plain(grad_bags, indices, V, weights)
    if not grad_bags.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors")
    keys, slots = backward_operands(indices, V)
    return backward_kernel(grad_bags, keys, slots, indices.shape[-1], V,
                           weights)


embed_bag_backward.launches = 0


class EmbedBag(torch.autograd.Function):
    """:func:`embed_bag` (flat or stacked, kernel or twin as ``use_kernel``
    says) with its gradient in the table through
    :func:`embed_bag_backward`.  No model trains the weights, so they take
    no gradient (``ops.embed_bag`` raises if they ask for one)."""

    @staticmethod
    def forward(ctx, table, indices, weights, use_kernel):
        ctx.save_for_backward(indices, weights)
        ctx.meta = (table.shape[-2], table.dtype, use_kernel)
        return embed_bag(table, indices, weights, use_kernel=use_kernel)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        indices, weights = ctx.saved_tensors
        V, dtype, use_kernel = ctx.meta
        if grad.stride(-1) != 1:
            grad = grad.contiguous()
        g = embed_bag_backward(grad, indices, V, weights,
                               use_kernel=use_kernel)
        return g.to(dtype), None, None, None
