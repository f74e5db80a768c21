"""Kernel D: weighted-sum embedding bags (gather + per-bag reduce).

Replaces the Pallas TPU kernel ``embed_bag`` of
``repro/kernels/embed_bag.py``.  The CUDA source is ``csrc/embed_bag.cu``;
its header says what bounds the kernel on an H100 (the bytes of the rows it
gathers and of its output) and how the design meets that (a group of lanes
per bag, 16-byte row loads, 64-bit row offsets).

``embed_bag(table [V, D], indices int32[B, F], weights f32[B, F])`` returns
f32[B, D]: each bag's rows times their weights, summed over the F slots in
order; a slot with index -1 adds nothing.  :func:`embed_bag` launches the
kernel for CUDA tensors and raises if the build or the launch fails; for
CPU tensors it runs the plain twin :func:`embed_bag_plain`.  Kernel and
twin run the same float program (``acc = acc + row * w`` per slot, pads
skipped), so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_BLOCKS_PER_SM = 32          # grid cap; the kernel strides over the rest


def embed_bag_plain(table: Tensor, indices: Tensor, weights: Tensor
                    ) -> Tensor:
    """Plain-torch twin: f32[B, D] bags of ``table`` [V, D] rows picked by
    ``indices`` int32[B, F] (pad -1) and scaled by ``weights`` f32[B, F],
    summed over the slots in order."""
    B, F = indices.shape
    out = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    valid = indices >= 0
    safe = torch.where(valid, indices, 0).long()
    for f in range(F):
        rows = table[safe[:, f]].to(torch.float32)
        out = torch.where(valid[:, f, None],
                          out + rows * weights[:, f, None], out)
    return out


def _plan(D: int, element_size: int, aligned: bool):
    """(vec, group) of a launch: elements per lane-load (16 bytes' worth
    where a row is a whole number of 16-byte chunks and the table is
    16-byte aligned, else 1) and lanes per bag (the smallest power of two
    that covers a row's loads, at most 32)."""
    vec = 16 // element_size
    if not aligned or (D * element_size) % 16:
        vec = 1
    chunks = D // vec
    group = min(32, 1 << max(0, (chunks - 1).bit_length()))
    return vec, group


def _lib():
    lib = _build.load("embed_bag")
    fn = lib.embed_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(table: Tensor, indices: Tensor, weights: Tensor) -> Tensor:
    dev = table.device
    for name, t, dtypes in (("table", table, tuple(_TABLE_KIND)),
                            ("indices", indices, (torch.int32,)),
                            ("weights", weights, (torch.float32,))):
        if t.dtype not in dtypes or t.dim() != 2 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous 2-d {dtypes} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} != indices "
                         f"{tuple(indices.shape)}")
    lib = _lib()                 # a failed build raises here
    B, F = indices.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        return out
    vec, group = _plan(D, table.element_size(), table.data_ptr() % 16 == 0)
    bags_per_block = _THREADS // group
    sms = _build.sm_count(dev)
    grid = max(1, min(-(-B // bags_per_block), sms * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.embed_bag_launch(
        _TABLE_KIND[table.dtype], table.data_ptr(), D, vec,
        indices.data_ptr(), weights.data_ptr(), B, F, group, grid,
        out.data_ptr(), stream)
    _build.check(err, "embed_bag")
    embed_bag.launches += 1
    return out


def embed_bag(table: Tensor, indices: Tensor, weights: Tensor, *,
              use_kernel: Optional[bool] = None) -> Tensor:
    """Weighted-sum bags f32[B, D].

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin; True on CPU
    tensors raises.  Indices must lie in [-1, V).
    """
    if use_kernel is None:
        use_kernel = table.is_cuda
    if use_kernel:
        if not table.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        return _launch(table, indices, weights)
    return embed_bag_plain(table, indices, weights)


embed_bag.launches = 0
