"""Training launcher with checkpoint auto-resume, as
``repro.launch.train``: the LM, GNN and recsys families' smoke configs, end
to end.

    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \
        --steps 50 [--ckpt-dir /tmp/ck] [--ckpt-every 25] [--resume] \
        [--microbatches 2] [--device cuda|cpu]

Prints the reference's lines (``[arch] step N loss=... |g|=...`` at the
first step and every 10th, ``resumed from step N``).  Batches are the
reference's draws: ``repro_torch.data.loaders.lm_batch(0, step,
4·microbatches, 64, cfg.vocab)`` for the LM family (loss ``lm_loss``),
``recsys_batch(0, step, 8·microbatches, cfg)`` for the recsys family, and
for the GNN family one graph, ``random_geometric_graph(0, 64, 256,
cfg.f_in, cfg.n_out)``, every step (loss ``loss_fn``, one microbatch); the
f32 weights are drawn from seed 0 on ``--device`` (None: the CUDA card).
Checkpoints are train states in the reference's layout
(``repro_torch.convert.train_state_to_numpy``), so either launcher resumes
the other's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.engine import resolve_device
from repro_torch.data import graph as graphdata
from repro_torch.data import loaders
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.train import loop


def build(arch: str, microbatches: int, device=None):
    """(params, loss_fn, batch_at, microbatches) of ``arch``'s smoke
    config on ``device``."""
    mod = registry.get(arch)
    if mod.FAMILY not in ("lm", "recsys", "gnn"):
        raise ValueError(f"{arch}: use repro_torch.launch.serve for "
                         f"retrieval")
    dev = resolve_device(device)
    cfg = mod.smoke_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    if mod.FAMILY == "lm":
        params = tr.init_params(gen, cfg, device=dev)

        def loss_fn(p, b):
            return tr.lm_loss(p, b[0], b[1], cfg)

        def batch_at(step):
            return loaders.lm_batch(0, step, 4 * microbatches, 64, cfg.vocab,
                                    device=dev)
    elif mod.FAMILY == "recsys":
        params = recsys.init_params(gen, cfg, device=dev)

        def loss_fn(p, b):
            return recsys.loss(p, b, cfg), {}

        def batch_at(step):
            return loaders.recsys_batch(0, step, 8 * microbatches, cfg,
                                        device=dev)
    else:
        params = gnn.init_params(gen, cfg, device=dev)
        g = graphdata.to_device(graphdata.random_geometric_graph(
            0, 64, 256, cfg.f_in, cfg.n_out), dev)

        def loss_fn(p, b):
            return gnn.loss_fn(p, b, cfg)

        def batch_at(step):
            return g
        microbatches = 1

    return params, loss_fn, batch_at, microbatches


def save(ckpt_dir: str, step: int, state) -> str:
    arrays, dtypes = convert.train_state_to_numpy(state)
    return ckpt.save(ckpt_dir, step, arrays, dtypes=dtypes)


def restore(ckpt_dir: str, state):
    """(state loaded in place from the newest checkpoint, its step)."""
    arrays, step, _ = ckpt.restore(ckpt_dir,
                                   convert.train_state_expect(state))
    return convert.train_state_from_numpy(arrays, state), step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    params, loss_fn, batch_at, mb = build(args.arch, args.microbatches,
                                          args.device)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                decay_steps=args.steps)
    step_fn = loop.make_train_step(loss_fn, opt_cfg, microbatches=mb)
    state = loop.init_state(params)
    start = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state, start = restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    for step in range(start, args.steps):
        state, metrics = step_fn(state, batch_at(step))
        if (step + 1) % 10 == 0 or step == start:
            print(f"[{args.arch}] step {step+1:4d} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"|g|={float(metrics['grad_norm']):.3f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(args.ckpt_dir, step + 1, state)


if __name__ == "__main__":
    main()
