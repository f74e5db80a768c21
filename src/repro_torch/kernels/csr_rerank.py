"""Kernel B's rerank form: Algorithm 7's exact rerank and top-k in one launch.

Replaces the rerank form of the Pallas TPU kernel ``csr_score`` of
``repro/kernels/csr_score.py`` with the work ``repro.core.engine.rerank_topk``
does around it (combine the sparse query's duplicates, match each candidate
row against it, gate, ``lax.top_k``, gather slots and ids).  The CUDA source
is ``csrc/csr_rerank.cu``; its header says what bounds the kernel on an H100
(the candidate rows' bytes) and how the design meets that (the sparse query
hashed in shared memory, no dense query; a lane group per row with two rows
in flight; selection by per-warp register sorts; each query's candidates
split over a thread-block cluster whose lists rank 0 merges).

:func:`csr_rerank_topk` launches the kernel for CUDA tensors and raises if
the build or the launch fails; for CPU tensors it runs the plain twin
:func:`csr_rerank_topk_plain`, the reference's steps in torch.  The kernel
sums each row in a shuffle tree, the twin in torch's order, so scores agree
to f32 rounding (bit for bit when every sum is exact) and ids and slots are
equal wherever no two scores fall within that rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.storage import vecstore

Tensor = torch.Tensor

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1}
#: Caps of the kernel's shared memory (``kMaxQuery``, the cluster size
#: times ``kMaxBlockPositions`` in its source): query coordinates per
#: query, and candidates per query.
MAX_QUERY_NNZ = 2_048
MAX_KPRIME = 8 * 4_096
_MAX_CLUSTER = 8
#: Fewest candidate positions a block of the cluster scores.
_MIN_BLOCK_POSITIONS = 64


def csr_rerank_topk_plain(q_idx: Tensor, q_val: Tensor, indices: Tensor,
                          values: Tensor, ids: Tensor, cand_scores: Tensor,
                          cand_slots: Tensor, k: int):
    """Plain-torch twin: the reference's ``rerank_topk`` step for step.

    Exact scores of each query's candidate rows by
    ``vecstore.exact_scores_sparse`` (duplicates combined, rows matched by
    searchsorted), candidates whose ``cand_scores`` entry is -inf gated to
    -inf, ``topk_desc`` (score desc, position asc), then the slot and id
    gathers.  Returns (ids int64[B, k], scores f32[B, k], slots int32[B, k]).
    """
    from repro_torch.kernels.sinnamon_score import topk_desc

    store = vecstore.VecStore(indices, values)
    slots = cand_slots.long()
    exact = torch.stack([
        vecstore.exact_scores_sparse(store, slots[b], q_idx[b], q_val[b])
        for b in range(cand_slots.shape[0])]) if cand_slots.shape[0] else \
        torch.zeros(cand_slots.shape, dtype=torch.float32,
                    device=cand_slots.device)
    exact = torch.where(torch.isneginf(cand_scores), -torch.inf, exact)
    top, pos = topk_desc(exact, k)
    out_slots = cand_slots.gather(-1, pos.long())
    return ids[out_slots.long()], top, out_slots


def _check(q_idx, q_val, indices, values, ids, cand_scores, cand_slots, k):
    """Raise ValueError on operands the kernel does not take; returns
    (B, Lq, P, K')."""
    dev = cand_slots.device
    for name, t, dtypes, dim in (
            ("q_idx", q_idx, (torch.int32,), 2),
            ("q_val", q_val, (torch.float32,), 2),
            ("indices", indices, (torch.int32,), 2),
            ("values", values, tuple(_VALUE_KIND), 2),
            ("ids", ids, (torch.int64,), 1),
            ("cand_scores", cand_scores, (torch.float32,), 2),
            ("cand_slots", cand_slots, (torch.int32,), 2)):
        if t.dtype not in dtypes or t.dim() != dim or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dim}-d {dtypes} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, Kp = cand_slots.shape
    Lq = q_idx.shape[1]
    C, P = indices.shape
    if q_val.shape != q_idx.shape or q_idx.shape[0] != B:
        raise ValueError(f"queries {tuple(q_idx.shape)} / "
                         f"{tuple(q_val.shape)} do not match {B} "
                         f"candidate lists")
    if values.shape != (C, P) or ids.shape != (C,):
        raise ValueError(f"values {tuple(values.shape)} and ids "
                         f"{tuple(ids.shape)} must match indices {(C, P)}")
    if cand_scores.shape != (B, Kp):
        raise ValueError(f"cand_scores {tuple(cand_scores.shape)} != "
                         f"cand_slots {(B, Kp)}")
    if not 0 <= k <= Kp:
        raise ValueError(f"k={k} must lie in [0, k'={Kp}]")
    if Kp > MAX_KPRIME or Lq > MAX_QUERY_NNZ:
        raise ValueError(f"k'={Kp} (at most {MAX_KPRIME}) or {Lq} query "
                         f"coordinates (at most {MAX_QUERY_NNZ}) exceed the "
                         f"kernel's shared memory")
    return B, Lq, P, Kp


def _lib():
    lib = _build.load("csr_rerank")
    fn = lib.csr_rerank_launch
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, i, p, p, i, i, p, p, i, i, p, p, p, i, i, i,
                       p, p, p, p]
        fn.restype = ctypes.c_int
        lib.csr_rerank_smem.argtypes = [i, i, i, i]
        lib.csr_rerank_smem.restype = ctypes.c_longlong
    return lib


def split(B: int, Kp: int, sms: int) -> int:
    """Blocks per query (the cluster size S): enough that B * S covers the
    SMs, at most 8, each block scoring at least 64 positions and at most
    ``MAX_KPRIME / 8``."""
    s = min(_MAX_CLUSTER, -(-sms // max(B, 1)),
            -(-Kp // _MIN_BLOCK_POSITIONS))
    return max(1, s, -(-Kp // (MAX_KPRIME // _MAX_CLUSTER)))


def lanes_per_row(P: int, vec: int) -> int:
    """log2 of the lanes that score one row: the fewest (a power of two,
    at most 32) that cover its P entries ``vec`` at a time."""
    g = 1
    while g < 32 and g * vec < P:
        g <<= 1
    return g.bit_length() - 1


def _launch(q_idx, q_val, indices, values, ids, cand_scores, cand_slots, k,
            B, Lq, P, Kp):
    dev = cand_slots.device
    out_ids = torch.empty((B, k), dtype=torch.int64, device=dev)
    out_scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_slots = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return out_ids, out_scores, out_slots
    aligned = (indices.data_ptr() % 16 == 0 and values.data_ptr()
               % (16 if values.dtype == torch.float32 else 8) == 0)
    vec = 8 if aligned and P % 8 == 0 else 4 if aligned and P % 4 == 0 \
        else 1
    S = split(B, Kp, _build.sm_count(dev))
    err = _lib().csr_rerank_launch(
        _VALUE_KIND[values.dtype], vec, q_idx.data_ptr(), q_val.data_ptr(),
        B, Lq, indices.data_ptr(), values.data_ptr(), P,
        lanes_per_row(P, vec), ids.data_ptr(), cand_scores.data_ptr(),
        cand_slots.data_ptr(), Kp, k, S, out_ids.data_ptr(),
        out_scores.data_ptr(), out_slots.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "csr_rerank_topk")
    csr_rerank_topk.launches += 1
    return out_ids, out_scores, out_slots


def csr_rerank_topk(q_idx: Tensor, q_val: Tensor, indices: Tensor,
                    values: Tensor, ids: Tensor, cand_scores: Tensor,
                    cand_slots: Tensor, k: int, *,
                    use_kernel: Optional[bool] = None):
    """Exact rerank of each query's K' candidates and their top-k.

    q_idx int32[B, Lq] (pad -1, duplicates add), q_val f32[B, Lq];
    indices int32[C, P] (pad -1) and values f32|bf16[C, P], the padded-CSR
    store; ids int64[C]; cand_scores f32[B, K'] (-inf gates a candidate
    out: it scores -inf and its row is not read); cand_slots int32[B, K'],
    each in [0, C).  Returns (ids int64[B, k], scores f32[B, k],
    slots int32[B, k]) in (score desc, position in the K' list asc) order.
    Caps: K' <= ``MAX_KPRIME`` (32,768) and Lq <= ``MAX_QUERY_NNZ``
    (2,048); operands beyond them, or not of these types, shapes and
    contiguity, raise ValueError on every device.

    ``use_kernel`` None launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors; False forces the twin; True on CPU
    tensors raises.
    """
    B, Lq, P, Kp = _check(q_idx, q_val, indices, values, ids, cand_scores,
                          cand_slots, k)
    if use_kernel is None:
        use_kernel = cand_slots.is_cuda
    if use_kernel:
        if not cand_slots.is_cuda:
            raise ValueError("the CUDA kernel needs CUDA tensors")
        return _launch(q_idx, q_val, indices, values, ids, cand_scores,
                       cand_slots, k, B, Lq, P, Kp)
    return csr_rerank_topk_plain(q_idx, q_val, indices, values, ids,
                                 cand_scores, cand_slots, k)


csr_rerank_topk.launches = 0
