"""Gradient compression for data parallelism across workers, as
``repro.optim.compress``: int8 quantisation with error feedback.  Each
worker keeps a residual; ``g + residual`` is quantised per tensor to int8
with one scale, and the quantisation error is the next residual.

``compressed_psum`` (the all-reduce of the int8 payload across workers)
needs a collective over the mesh, which waits for the mesh tooling's
second half (ROADMAP.md, Queue 1 item 12b).
"""

from __future__ import annotations

from typing import Tuple

import torch

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


def compressed_psum(grads: dict, residual: dict, axis_name: str):
    raise NotImplementedError(
        "compressed_psum needs a collective across workers on a mesh; it "
        "is not ported yet (ROADMAP.md, Queue 1 item 12b: the mesh "
        "tooling's second half)")
