"""Kernel B: exact padded-CSR scoring (Algorithm 7 rerank and exact LinScan).

Replaces the Pallas TPU kernel ``csr_score`` of ``repro/kernels/csr_score.py``.
The CUDA source is ``csrc/csr_score.cu``; its header says what bounds the
kernel on an H100 (the CSR row bytes) and how the design meets that (the
dense query held in shared memory, one warp per row).

Two modes, one kernel:

* ``slots`` int32[B, K] given — the rerank: scores of each query's K
  candidate rows, f32[B, K];
* ``slots`` None — the exact LinScan over all C rows, f32[B, C].

:func:`csr_score` launches the kernel for CUDA tensors and raises if the
build or the launch fails; for CPU tensors it runs the plain twin
:func:`csr_score_plain`.  The kernel sums each row in a shuffle tree, the
twin in torch's order, so the two agree to f32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_WARPS_PER_BLOCK = 32


def csr_score_plain(q_dense: Tensor, indices: Tensor, values: Tensor,
                    slots: Optional[Tensor] = None) -> Tensor:
    """Plain-torch twin: exact scores f32[B, K] (or f32[B, C] when
    ``slots`` is None) of dense queries f32[B, n] against padded-CSR rows
    (pad index -1 counts as 0)."""
    B = q_dense.shape[0]
    if slots is None:
        idx = indices.unsqueeze(0).expand(B, -1, -1)
        val = values.unsqueeze(0).expand(B, -1, -1)
    else:
        s = slots.long()
        idx, val = indices[s], values[s]                    # [B, K, P]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    qg = torch.gather(q_dense, 1, safe.reshape(B, -1)).reshape(safe.shape)
    return torch.where(valid, qg * val.to(torch.float32), 0.0).sum(-1)


def _lib():
    lib = _build.load("csr_score")
    fn = lib.csr_score_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _launch(q_dense, indices, values, slots):
    dev = q_dense.device
    B, n = q_dense.shape
    C, P = indices.shape
    for name, t, dtypes in (("q_dense", q_dense, (torch.float32,)),
                            ("indices", indices, (torch.int32,)),
                            ("values", values, tuple(_VALUE_KIND))):
        if t.dtype not in dtypes or t.dim() != 2 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous 2-d {dtypes} tensor "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if values.shape != (C, P):
        raise ValueError(f"values {tuple(values.shape)} != indices {(C, P)}")
    if slots is not None and (slots.dtype != torch.int32 or slots.dim() != 2
                              or slots.shape[0] != B or slots.device != dev
                              or not slots.is_contiguous()):
        raise ValueError(f"slots: want contiguous int32[{B}, K] on {dev}, "
                         f"got {slots.dtype} {tuple(slots.shape)}")
    K = C if slots is None else slots.shape[1]
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return out
    q_in_smem = int(n * 4 <= _build.SMEM_PER_BLOCK)
    sms = _build.sm_count(dev)
    grid_x = max(1, min(-(-K // _WARPS_PER_BLOCK), sms // B))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().csr_score_launch(
        _VALUE_KIND[values.dtype], q_dense.data_ptr(), n, q_in_smem,
        None if slots is None else slots.data_ptr(), K, indices.data_ptr(),
        values.data_ptr(), P, B, grid_x, out.data_ptr(), stream)
    _build.check(err, "csr_score")
    csr_score.launches += 1
    return out


def csr_score(q_dense: Tensor, indices: Tensor, values: Tensor,
              slots: Optional[Tensor] = None, *,
              use_kernel: Optional[bool] = None) -> Tensor:
    """Exact scores: f32[B, K] with ``slots`` [B, K], else f32[B, C].

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin; True on CPU
    tensors raises.
    """
    if use_kernel is None:
        use_kernel = q_dense.is_cuda
    if use_kernel:
        if not q_dense.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        return _launch(q_dense, indices, values, slots)
    return csr_score_plain(q_dense, indices, values, slots)


csr_score.launches = 0
