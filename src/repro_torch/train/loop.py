"""The generic train step, as ``repro.train.loop``: gradients (with
microbatch accumulation in f32), global-norm clipping and AdamW.

``params`` is a model with ``leaves()`` (``repro_torch.models.transformer``
and ``repro_torch.models.recsys``): the dict of its tensors keyed by the
reference's leaf paths that the optimiser and the train-state checkpoints
(``repro_torch.convert.train_state_to_numpy``) read.  Gradients come from
``loss.backward()`` into each parameter's ``.grad``; the step updates the
parameters and the moments in place and frees the gradients.

With ``compress_axis`` (a mesh axis, with its ``mesh``) and a state that
carries an error-feedback residual (``init_state(...,
use_compression=True)``), the gradients are averaged over that axis by
``optim.compress.compressed_psum`` before the update, and the new
residual goes into the returned state, as the reference does inside
``shard_map``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim import adamw, compress


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    ef_residual: Any = None    # error-feedback state (grad compression)


def init_state(params, use_compression: bool = False) -> TrainState:
    leaves = params.leaves()
    res = ({k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in leaves.items()} if use_compression else None)
    return TrainState(params=params, opt=adamw.init(leaves), ef_residual=res)


def split_batch(batch, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a batch (a tensor, or a tuple or
    NamedTuple of them): rows [i·B/n, (i+1)·B/n) of each."""
    if isinstance(batch, torch.Tensor):
        return batch.reshape((n, batch.shape[0] // n)
                             + tuple(batch.shape[1:]))[i]
    parts = [split_batch(v, n, i) for v in batch]
    return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)


def make_train_step(
    loss_fn: Callable,                 # (params, batch) -> (loss, metrics)
    opt_cfg: adamw.AdamWConfig,
    *,
    microbatches: int = 1,
    compress_axis: Optional[str] = None,
    mesh=None,
):
    """Build ``train_step(state, batch) -> (state, metrics)``; metrics are
    ``loss_fn``'s (with one microbatch), ``loss``, ``grad_norm`` and
    ``lr``, 0-d tensors.  With ``microbatches`` > 1 the batch is split
    along its first axis, the f32 gradients are summed over the
    microbatches in order and divided by their count, as the reference's
    ``lax.scan`` does, and so is the loss.  ``compress_axis`` names the
    axis of ``mesh`` over which each worker's gradients are averaged with
    int8 error feedback (see the module's docstring)."""
    if compress_axis is not None and mesh is None:
        raise ValueError("compress_axis needs the mesh it names an axis of")

    def grads_of(params, batch):
        for t in params.parameters():
            t.grad = None
        loss, metrics = loss_fn(params, batch)
        loss.backward()
        return loss.detach(), metrics, params.leaves(grad=True)

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        acc, loss_acc = None, None
        for i in range(microbatches):
            loss, _, grads = grads_of(params,
                                      split_batch(batch, microbatches, i))
            if acc is None:
                acc = {k: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device)
                       for k, g in grads.items()}
                loss_acc = torch.zeros((), dtype=torch.float32,
                                       device=loss.device)
            for k, g in grads.items():
                acc[k].add_(g)
            loss_acc = loss_acc + loss
        n = torch.tensor(float(microbatches), device=loss_acc.device)
        for g in acc.values():
            g.div_(n)
        return loss_acc / n, {}, acc

    def train_step(state: TrainState, batch):
        loss, metrics, grads = accumulate(state.params, batch)
        residual = state.ef_residual
        if compress_axis is not None and residual is not None:
            grads, residual = compress.compressed_psum(
                grads, residual, compress_axis, mesh)
        _, opt, opt_metrics = adamw.update(
            grads, state.opt, state.params.leaves(), opt_cfg)
        del grads
        for t in state.params.parameters():
            t.grad = None
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(state.params, opt, residual), metrics

    return train_step
