"""Gradient compression for data parallelism across workers, as
``repro.optim.compress``: int8 quantisation with error feedback.  Each
worker keeps a residual; ``g + residual`` is quantised per tensor to int8
with one scale, and the quantisation error is the next residual.

:func:`compressed_psum` all-reduces the int8 payload over one named axis
of a ``DeviceMesh`` (the reference runs it inside ``shard_map``, which
supplies the axis; the port takes the mesh beside the axis name): the
scale is max-reduced first, so every worker dequantises alike, and the
int8 values are summed as int32, which is exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import rules as R

Tensor = torch.Tensor


def quantize_int8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(q int8, scale f32 0-d): scale = max(max|x| / 127, 1e-12),
    q = clip(round(x / scale), -127, 127), rounding half to even."""
    amax = torch.max(torch.abs(x)).to(torch.float32)
    scale = torch.maximum(torch.div(amax, torch.full_like(amax, 127.0)),
                          torch.full_like(amax, 1e-12))
    q = torch.clamp(torch.round(torch.div(x.to(torch.float32), scale)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: dict, residual: dict):
    """(grads, residual) -> (int8 dict, scales dict, new residual dict)."""
    q, s, res = {}, {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + residual[k]
        q[k], s[k] = quantize_int8(x)
        res[k] = x - dequantize(q[k], s[k])
    return q, s, res


def _all_reduce(t: Tensor, op: str, mesh, axis_name: str) -> Tensor:
    """``t`` reduced with ``op`` over the mesh axis ``axis_name``; ``t``
    itself over an axis of one device."""
    if R.axis_size(mesh, axis_name) == 1:
        return t
    from torch.distributed import _functional_collectives as funcol

    dim = R.axis_names(mesh).index(axis_name)
    return funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, dim)))


def compressed_psum(grads: dict, residual: dict, axis_name: str, mesh):
    """Error-feedback int8 all-reduce of this worker's gradients over the
    axis ``axis_name`` of ``mesh``: (mean gradients f32, new residual),
    dicts keyed as ``grads``.  Per tensor, as the reference: x = g + r;
    scale = max(max-reduced max|x| / 127, 1e-12); q = clip(round(x /
    scale), -127, 127) as int8; the new residual x - q·scale; the result
    (Σ q as int32) · scale / n over the axis's n workers."""
    mean, res = {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + residual[k]
        amax = _all_reduce(torch.max(torch.abs(x)).to(torch.float32),
                           "max", mesh, axis_name)
        scale = torch.maximum(torch.div(amax, torch.full_like(amax, 127.0)),
                              torch.full_like(amax, 1e-12))
        q = torch.clamp(torch.round(torch.div(x, scale)), -127,
                        127).to(torch.int8)
        res[k] = x - q.to(torch.float32) * scale
        total = _all_reduce(q.to(torch.int32), "sum", mesh, axis_name)
        n = _all_reduce(torch.ones((), dtype=torch.float32, device=x.device),
                        "sum", mesh, axis_name)
        mean[k] = torch.div(total.to(torch.float32) * scale, n)
    return mean, res
