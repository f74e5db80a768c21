"""Synthetic LM and recsys batches, deterministic in (seed, step): the
numpy Philox draws of ``repro.data.loaders``, copied, so every token and
field equals the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.recsys import RecsysBatch, RecsysConfig


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None):
    """(tokens, labels), int32 [batch, seq] each on ``device`` (None: the
    CUDA card): Zipfian token ids, labels the tokens shifted by one."""
    gen = np.random.Generator(np.random.Philox(key=(seed << 20) ^ step))
    # Zipfian tokens — realistic softmax/embedding access pattern.
    ranks = gen.zipf(1.3, size=(batch, seq + 1))
    toks = np.minimum(ranks - 1, vocab - 1).astype(np.int32)
    dev = resolve_device(device)
    return (torch.from_numpy(np.ascontiguousarray(toks[:, :-1])).to(dev),
            torch.from_numpy(np.ascontiguousarray(toks[:, 1:])).to(dev))


def recsys_batch(seed: int, step: int, batch: int, cfg: RecsysConfig,
                 device=None) -> RecsysBatch:
    """One batch of ``batch`` samples as tensors on ``device`` (None: the
    CUDA card)."""
    gen = np.random.Generator(np.random.Philox(key=(seed << 20) ^ step))
    dense = gen.normal(0, 1, (batch, cfg.n_dense)).astype(np.float32)
    sparse = gen.integers(0, cfg.vocab_per_field,
                          (batch, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
    drop = gen.random((batch, cfg.n_sparse, cfg.multi_hot)) < 0.2
    sparse = np.where(drop, -1, sparse)
    hist = gen.integers(0, cfg.n_items, (batch, cfg.seq_len)).astype(np.int32)
    lengths = gen.integers(1, cfg.seq_len + 1, batch)
    mask = np.arange(cfg.seq_len)[None, :] >= lengths[:, None]
    hist = np.where(mask, -1, hist)
    target = gen.integers(0, cfg.n_items, batch).astype(np.int32)
    labels = gen.integers(0, 2, batch).astype(np.float32)
    dev = resolve_device(device)
    return RecsysBatch(*(torch.from_numpy(a).to(dev) for a in
                         (dense, sparse, hist, target, labels)))
