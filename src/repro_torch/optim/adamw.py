"""AdamW + cosine schedule + global-norm clipping, as
``repro.optim.adamw``: f32 moments whatever the parameters' dtype, the
reference's float program step for step.

Everything works on a dict of tensors keyed by the reference's leaf paths
(a model's ``leaves()``).  The update is
in place: at DLRM-rm2's width one leaf is 6.66 GB, and its gradient, m and
v as large again, so an out-of-place step would need a 6.66 GB temporary
for every intermediate.  Each leaf is walked in chunks of
:data:`CHUNK` elements, so the temporaries stay at a chunk's size; every
element still gets the reference's expression in the reference's order:

    m2 = b1·m + (1 - b1)·g
    v2 = b2·v + ((1 - b2)·g)·g
    p2 = p - lr·(m2 / b1c / (sqrt(v2 / b2c) + eps) + wd·p)

with ``b1c = 1 - b1**step`` and ``b2c`` computed in f32, and the scalars
that vary by step (lr, b1c, b2c, the clip scale) held as f32 tensors on the
parameters' device: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal instead, which is not the reference's rounding.  As in the
reference, weight and moment decay touch every row, so the gradient stays
dense.

On a mesh (leaves that are DTensors, ``repro_torch.launch.dryrun``) the
update is elementwise, so each device updates its own block: a gradient is
first placed like its parameter (which reduces its partial sums), then
every chunk runs on the local blocks.  The global norm is the one
reduction: each device sums the squares of its blocks (a block held by r
replicas counts 1/r, an exact power-of-two scale), then one all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor

#: Elements of a leaf updated at once (64 MiB of f32).
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: dict
    v: dict
    step: Tensor          # int32, 0-d


def init(params: dict) -> OptState:
    """Zero f32 moments for each leaf of ``params``, step 0."""
    z = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return OptState(m=z, v={k: t.clone() for k, t in z.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warm-up to ``cfg.lr``, then cosine decay to
    ``min_lr_ratio·lr`` at ``decay_steps``: an f32 0-d tensor."""
    f32 = dict(dtype=torch.float32, device=step.device)
    step = step.to(torch.float32)
    warm = torch.minimum(step / torch.tensor(max(cfg.warmup_steps, 1),
                                             **f32),
                         torch.tensor(1.0, **f32))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / torch.tensor(max(cfg.decay_steps
                                          - cfg.warmup_steps, 1), **f32),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _is_dtensor(t) -> bool:
    return hasattr(t, "_local_tensor")


def _local(t):
    """This device's block of a DTensor; a plain tensor as it is."""
    return t._local_tensor if _is_dtensor(t) else t


def _replicas(t) -> int:
    """Devices holding each block of a DTensor (its replicated mesh
    dimensions)."""
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_replicate():
            n *= t.device_mesh.size(i)
    return n


def _chunks(*ts: Tensor):
    """Aligned views of the same-shaped tensors ``ts``, at most about
    :data:`CHUNK` elements each, covering them: runs of the flattened
    tensors where all are contiguous, else blocks of rows (first axis)."""
    t = ts[0]
    if t.numel() <= CHUNK or t.dim() == 0:
        yield ts
        return
    if all(x.is_contiguous() for x in ts):
        flat = [x.view(-1) for x in ts]
        for lo in range(0, t.numel(), CHUNK):
            yield tuple(x[lo:lo + CHUNK] for x in flat)
        return
    per = max(1, CHUNK // max(1, t.numel() // t.shape[0]))
    for lo in range(0, t.shape[0], per):
        yield tuple(x.narrow(0, lo, min(per, t.shape[0] - lo)) for x in ts)


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's sum of
    squares, in f32."""
    sq, mesh = None, None
    for g in tree.values():
        reps = 1
        if _is_dtensor(g):
            mesh, reps = g.device_mesh, _replicas(g)
            g = g._local_tensor
        s = None
        for c, in _chunks(g):
            c = c.to(torch.float32)
            part = torch.sum(c * c)
            s = part if s is None else s + part
        if reps > 1:
            s = s / reps
        sq = s if sq is None else sq + s
    if sq is None:
        return torch.zeros((), dtype=torch.float32)
    if mesh is not None:
        import torch.distributed as dist
        from torch.distributed import _functional_collectives as funcol

        sq = funcol.wait_tensor(funcol.all_reduce(sq, "sum",
                                                  dist.group.WORLD))
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient in place by min(1, max_norm / max(‖g‖, 1e-12));
    returns (grads, ‖g‖)."""
    gn = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gn), torch.div(
        torch.full_like(gn, max_norm),
        torch.maximum(gn, torch.full_like(gn, 1e-12))))
    for g in grads.values():
        _local(g).mul_(scale.to(g.dtype))
    return grads, gn


def _update_chunk(p: Tensor, g: Tensor, m: Tensor, v: Tensor, cfg, lr,
                  b1c, b2c) -> None:
    t = torch.mul(g, 1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)                          # m2
    torch.mul(g, 1 - cfg.b2, out=t).mul_(g)
    v.mul_(cfg.b2).add_(t)                          # v2
    delta = torch.div(m, b1c)                       # mh
    torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)  # sqrt(vh) + eps
    delta.div_(t)
    pf = p if p.dtype == torch.float32 else p.to(torch.float32)
    torch.mul(pf, cfg.weight_decay, out=t)
    delta.add_(t).mul_(lr)
    if pf is p:
        p.sub_(delta)
    else:
        p.copy_(pf - delta)


@torch.no_grad()
def update(grads: dict, opt: OptState, params: dict, cfg: AdamWConfig):
    """One AdamW step in place: ``params``, ``opt.m`` and ``opt.v`` are
    written where they lie (the gradients too, by the clip).  Returns
    (params, the new OptState, {"grad_norm", "lr"})."""
    grads = {k: g if g.dtype == torch.float32 else g.to(torch.float32)
             for k, g in grads.items()}
    grads = {k: g.redistribute(params[k].device_mesh, params[k].placements)
             if _is_dtensor(g) else g for k, g in grads.items()}
    if cfg.clip_norm > 0:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    step = opt.step + 1
    lr = schedule(cfg, step)
    s = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=s.device), s)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=s.device), s)
    scalars = (_local(lr), _local(b1c), _local(b2c))
    for k, p in params.items():
        for chunk in _chunks(*map(_local, (p, grads[k], opt.m[k],
                                           opt.v[k]))):
            _update_chunk(*chunk, cfg, *scalars)
    return params, OptState(opt.m, opt.v, step), {"grad_norm": gn,
                                                  "lr": lr}
