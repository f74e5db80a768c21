"""RecSys models in PyTorch: DLRM (dlrm-rm2) serving.

Counterpart of ``repro.models.recsys`` for the DLRM model's **serving**
forward: ``score`` (the CTR logit), ``user_repr`` / ``item_embeddings``
(the MIPS retrieval factorisation) and ``retrieval_scores``, plus ``loss``
on the same forward.  The 26 field lookups are one launch of kernel D
(:func:`stacked_embedding_bag` → ``kernels.ops.embed_bag``), which computes
what the reference's jnp ``embedding_bag`` computes, reads the request's
indices as they are and writes each bag straight into the [B, F+1, D]
buffer the interaction reads; the MLPs and the interaction stay on
``torch.matmul``, as the reference leaves them to XLA.

The parameters do not require gradients: training (and its gradient
through the bags) is a later slice, as are DIN, SASRec and MIND, which
raise ``NotImplementedError``.  Mesh sharding (``abstract_params``,
``logical_axes``) waits for the sharding slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NOT_PORTED = ("model {!r} is not ported yet (ROADMAP.md, Queue 1 #12); "
               "repro_torch serves dlrm only")


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                    # dlrm | din | sasrec | mind
    embed_dim: int = 64
    n_items: int = 1_000_000      # item vocabulary (retrieval candidates)
    # dlrm
    n_dense: int = 13
    n_sparse: int = 26
    vocab_per_field: int = 1_000_000
    multi_hot: int = 4            # lookups per sparse field (embedding bag)
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)
    # din
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    # sasrec
    n_blocks: int = 2
    n_heads: int = 1
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    dtype: str = "float32"


class RecsysBatch(NamedTuple):
    dense: Tensor     # f32[B, n_dense]            (dlrm; zeros otherwise)
    sparse: Tensor    # int32[B, n_sparse, hot]    (dlrm; pad = -1)
    hist: Tensor      # int32[B, seq_len]          (din/sasrec/mind; pad = -1)
    target: Tensor    # int32[B]                   target item
    labels: Tensor    # f32[B]                     click labels


# ---------------------------------------------------------------------------
# Embedding bags (kernel D)
# ---------------------------------------------------------------------------

def embedding_bag(table: Tensor, idx: Tensor, mode: str = "sum", *,
                  use_kernel: Optional[bool] = None) -> Tensor:
    """[..., hot] indices (pad=-1) into [V, D] table → [..., D], in the
    table's dtype.  ``mean`` divides the bag's sum by its count of valid
    slots (at least 1), as the reference does."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    flat = idx.reshape(-1, idx.shape[-1]).to(torch.int32).contiguous()
    out = ops.embed_bag(table.contiguous(), flat, use_kernel=use_kernel)
    if mode == "mean":
        out = out / (flat >= 0).sum(-1, keepdim=True).clamp_min(1)
    return out.reshape(*idx.shape[:-1], table.shape[1]).to(table.dtype)


def stacked_bag_operands(tables: Tensor, idx: Tensor):
    """Stacked tables [F, V, D] and indices [B, F, hot] → the one-launch
    operands of kernel D: the tables viewed as [F·V, D] and int32[B·F, hot]
    indices offset by f·V (pads stay -1)."""
    F, V, D = tables.shape
    B, F_idx, hot = idx.shape
    if F_idx != F:
        raise ValueError(f"indices cover {F_idx} fields, tables {F}")
    if F * V >= 2**31:
        raise ValueError(f"{F}×{V} rows overflow int32 indices")
    flat = tables.view(F * V, D)
    offs = (torch.arange(F, dtype=torch.int32, device=idx.device)
            * V)[None, :, None]
    fidx = torch.where(idx >= 0, idx.to(torch.int32) + offs, -1)
    return flat, fidx.reshape(B * F, hot).contiguous()


def stacked_embedding_bag(tables: Tensor, idx: Tensor, *,
                          out: Optional[Tensor] = None,
                          use_kernel: Optional[bool] = None) -> Tensor:
    """Sum bags of every field at once: tables [F, V, D] (contiguous),
    idx [B, F, hot] (pad -1) → [B, F, D] in the tables' dtype, written into
    ``out`` (a [B, F, D] view in that dtype) when given.  Takes the place
    of the reference's ``jax.vmap(embedding_bag, (0, 1), 1)``.

    ``use_kernel`` None or True: one launch of kernel D's stacked form over
    B·F bags, which reads ``idx`` as it is and writes f32 bags straight
    into ``out`` (bf16 tables: through an f32 tensor); on CPU tensors its
    twin.  False: the flat twin over :func:`stacked_bag_operands`.
    """
    if use_kernel is False:
        flat, fidx = stacked_bag_operands(tables, idx)
        bags = ops.embed_bag(flat, fidx, use_kernel=False).view(
            idx.shape[0], tables.shape[0], tables.shape[2]).to(tables.dtype)
        return bags if out is None else out.copy_(bags)
    idx = idx.to(torch.int32).contiguous()
    if out is not None and out.dtype == torch.float32:
        return ops.embed_bag(tables, idx, out=out, use_kernel=use_kernel)
    bags = ops.embed_bag(tables, idx, use_kernel=use_kernel)
    return bags.to(tables.dtype) if out is None else out.copy_(bags)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091) — rm2 config
# ---------------------------------------------------------------------------

def _linears(dims, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(
        nn.utils.skip_init(nn.Linear, a, b, dtype=dtype, device=device)
        for a, b in zip(dims[:-1], dims[1:]))


def _mlp(layers: nn.ModuleList, x: Tensor, final_act: bool = False,
         out: Optional[Tensor] = None):
    """The MLP; with ``out``, the final ReLU writes into it (``relu`` is
    ``clamp_min(·, 0)`` in torch, so the bits are the same)."""
    n = len(layers)
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < n - 1 or (final_act and out is None):
            x = torch.relu(x)
        elif final_act:
            x = torch.clamp_min(x, 0, out=out)
    return x


def _bce(logit: Tensor, label: Tensor) -> Tensor:
    return torch.mean(torch.clamp_min(logit, 0) - logit * label
                      + torch.log1p(torch.exp(-torch.abs(logit))))


class DLRM(nn.Module):
    """DLRM with stacked field tables [n_sparse, V, D] and bottom / top
    MLPs of ``nn.Linear``.

    ``generator`` (a ``torch.Generator`` on ``device``; None: seed 0) draws
    the weights with the reference's law: normal / √fan_in, zero biases.
    The tables are drawn on ``device`` one field at a time, so no host
    array of their size exists.  ``draw=False`` leaves them uninitialised
    (:func:`repro_torch.convert.recsys_params_from_numpy` fills them).
    ``device`` None means the CUDA card.
    """

    def __init__(self, cfg: RecsysConfig, generator=None, device=None, *,
                 draw: bool = True):
        super().__init__()
        if cfg.model != "dlrm":
            raise NotImplementedError(_NOT_PORTED.format(cfg.model))
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        self.cfg = cfg
        D = cfg.embed_dim
        self.tables = nn.Parameter(torch.empty(
            (cfg.n_sparse, cfg.vocab_per_field, D), dtype=dtype, device=dev))
        n_f = cfg.n_sparse + 1
        self.bot = _linears((cfg.n_dense,) + tuple(cfg.bot_mlp), dtype, dev)
        self.top = _linears((cfg.bot_mlp[-1] + n_f * (n_f - 1) // 2,)
                            + tuple(cfg.top_mlp), dtype, dev)
        iu, ju = torch.triu_indices(n_f, n_f, 1, device=dev)
        self.register_buffer("iu", iu, persistent=False)
        self.register_buffer("ju", ju, persistent=False)
        self.requires_grad_(False)
        if draw:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            self._draw(generator)

    @torch.no_grad()
    def _draw(self, gen: torch.Generator) -> None:
        dev = self.tables.device
        V, D = self.tables.shape[1:]
        for f in range(self.tables.shape[0]):
            self.tables[f].copy_(torch.randn((V, D), generator=gen,
                                             device=dev) / math.sqrt(D))
        for lin in (*self.bot, *self.top):
            out_f, in_f = lin.weight.shape
            lin.weight.copy_(torch.randn((out_f, in_f), generator=gen,
                                         device=dev) / math.sqrt(in_f))
            lin.bias.zero_()

    def interaction_input(self, dense: Tensor, sparse: Tensor, *,
                          use_kernel: Optional[bool] = None) -> Tensor:
        """vecs [B, n_sparse + 1, D]: the bottom MLP's output x0 in row 0,
        the field bags in rows 1.. .  Kernel path (``use_kernel`` None or
        True): the buffer is allocated once, the bottom MLP's last ReLU
        writes x0 into row 0 and kernel D the bags into the rest, so
        nothing is concatenated.  ``use_kernel=False``: the twin program,
        x0 and the twin's bags concatenated."""
        tables = self.tables
        dense = dense.to(tables.dtype)
        if use_kernel is False:
            x0 = _mlp(self.bot, dense, final_act=True)
            emb = stacked_embedding_bag(tables, sparse, use_kernel=False)
            return torch.cat([x0[:, None, :], emb], dim=1)
        F, _, D = tables.shape
        vecs = torch.empty((dense.shape[0], F + 1, D), dtype=tables.dtype,
                           device=tables.device)
        _mlp(self.bot, dense, final_act=True, out=vecs[:, 0])
        stacked_embedding_bag(tables, sparse, out=vecs[:, 1:],
                              use_kernel=use_kernel)
        return vecs

    def features(self, dense: Tensor, sparse: Tensor, *,
                 use_kernel: Optional[bool] = None):
        """(x0 [B, D] bottom-MLP output, emb [B, n_sparse, D] field bags):
        views of :meth:`interaction_input`'s rows."""
        vecs = self.interaction_input(dense, sparse, use_kernel=use_kernel)
        return vecs[:, 0], vecs[:, 1:]

    def forward(self, dense: Tensor, sparse: Tensor, *,
                use_kernel: Optional[bool] = None) -> Tensor:
        """CTR logits [B]: the top MLP over x0 and the strict upper
        triangle (row-major) of the Gram matrix of [x0; emb]."""
        vecs = self.interaction_input(dense, sparse, use_kernel=use_kernel)
        gram = torch.bmm(vecs, vecs.transpose(1, 2))
        inter = gram[:, self.iu, self.ju]                    # [B, F(F+1)/2]
        return _mlp(self.top, torch.cat([vecs[:, 0], inter], dim=-1))[:, 0]


# ---------------------------------------------------------------------------
# The reference's entry points (model="dlrm")
# ---------------------------------------------------------------------------

def _dlrm(cfg: RecsysConfig) -> None:
    if cfg.model != "dlrm":
        raise NotImplementedError(_NOT_PORTED.format(cfg.model))


def init_params(generator, cfg: RecsysConfig, dtype: Optional[str] = None,
                device=None) -> DLRM:
    """The model's parameters: a :class:`DLRM` drawn from ``generator``,
    in ``dtype`` (a ``RecsysConfig.dtype`` name; None: ``cfg.dtype``)."""
    _dlrm(cfg)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return DLRM(cfg, generator=generator, device=device)


def score(params: DLRM, batch: RecsysBatch, cfg: RecsysConfig, *,
          use_kernel: Optional[bool] = None) -> Tensor:
    """Pointwise serving logit [B] (CTR)."""
    _dlrm(cfg)
    return params(batch.dense, batch.sparse, use_kernel=use_kernel)


def loss(params: DLRM, batch: RecsysBatch, cfg: RecsysConfig, *,
         use_kernel: Optional[bool] = None) -> Tensor:
    """Binary cross-entropy of :func:`score` against the click labels."""
    return _bce(score(params, batch, cfg, use_kernel=use_kernel),
                batch.labels)


def user_repr(params: DLRM, batch: RecsysBatch, cfg: RecsysConfig, *,
              use_kernel: Optional[bool] = None) -> Tensor:
    """[B, D] MIPS query vector: x0 + the mean of the field bags (the
    two-tower factorisation)."""
    _dlrm(cfg)
    x0, emb = params.features(batch.dense, batch.sparse,
                              use_kernel=use_kernel)
    return x0 + emb.mean(dim=1)


def item_embeddings(params: DLRM, cfg: RecsysConfig) -> Tensor:
    """[n_items, D] retrieval candidate matrix (a view of field 0)."""
    _dlrm(cfg)
    return params.tables[0, :cfg.n_items]


def retrieval_scores(params: DLRM, batch: RecsysBatch, cfg: RecsysConfig, *,
                     use_kernel: Optional[bool] = None) -> Tensor:
    """retrieval_cand shape: [B, n_items] scores of the users against the
    full candidate set (the dense batched-dot MIPS path)."""
    u = user_repr(params, batch, cfg, use_kernel=use_kernel)
    return torch.matmul(u, item_embeddings(params, cfg).t())


def sparsify_items(items: Tensor, t: int):
    """The item catalog as sparse vectors for the Sinnamon index: each
    item's t largest-|value| coordinates, in ascending coordinate order,
    as ``examples/recsys_retrieval.py`` builds them.  Returns
    (idx int32[V, t], val f32[V, t])."""
    top = torch.topk(items.abs(), t, dim=1).indices
    idx = torch.sort(top, dim=1).values
    return idx.to(torch.int32), items.gather(1, idx).to(torch.float32)
