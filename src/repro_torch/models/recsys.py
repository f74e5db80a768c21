"""RecSys models in PyTorch: dlrm-rm2, din, sasrec, mind.

Counterpart of ``repro.models.recsys``.  Every model is an ``nn.Module``
whose parameters train, and the reference's entry points cover all four:

    init_params(generator, cfg)              — the model, drawn with the
                                               reference's law
    loss(params, batch, cfg)                 — training objective
    score(params, batch, cfg)                — pointwise serving (CTR /
                                               next-item)
    user_repr(params, batch, cfg) / item_embeddings(params, cfg)
                                             — the MIPS retrieval
                                               factorisation
    retrieval_scores(params, batch, cfg)     — users against every item

``loss`` builds the autograd graph; the serving entry points run under
``torch.no_grad()``.  Each model's :meth:`leaves` names its tensors by the
reference's leaf paths (``table``, ``attn/w0``, ``blocks/wq``, DLRM's
``bot/w0`` [in, out] as the transposed ``nn.Linear.weight``), which is how
the optimiser, the train-state checkpoints and ``repro_torch.convert`` see
them.

DLRM's 26 field lookups are one launch of kernel D
(:func:`stacked_embedding_bag` → ``kernels.ops.embed_bag``), which reads the
request's indices as they are and writes each bag straight into the
[B, F+1, D] buffer the interaction reads.  In training the buffer comes from
:class:`InteractionInput`, whose backward is kernel D's backward kernel.
DIN, SASRec and MIND gather with ``F.embedding`` (a plain torch gather),
as the reference leaves its gathers to XLA.  The MLPs, attention and
interaction stay on ``torch.matmul``.

The mesh tooling is the reference's: ``abstract_params`` (the model on
``meta``), ``logical_axes`` and ``batch_logical_axes``, and the ``mesh`` /
``rules`` arguments of the entry points, with which they run on DTensors
(``repro_torch.launch.dryrun``) and pin the reference's placements at its
points.  On a mesh of more than one device each device sums DLRM's bags
over the table rows it holds (kernel D, or its twin, on its local block)
and the partial bags are reduced over the row shards; the Gram pairs are
picked on each device's batch rows.  With ``mesh`` None or of one device
nothing changes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn.functional import embedding

from repro_torch.core.engine import resolve_device
from repro_torch.distributed import rules as R
from repro_torch.distributed.rules import L
from repro_torch.kernels import ops
from repro_torch.models import tree_leaves

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def batch_logical_axes() -> RecsysBatch:
    return RecsysBatch(dense=L("batch", None), sparse=L("batch", None, None),
                       hist=L("batch", None), target=L("batch"),
                       labels=L("batch"))


def _mlp_axes(dims) -> dict:
    out = {}
    for i in range(len(dims) - 1):
        out[f"w{i}"] = L(None, None)
        out[f"b{i}"] = L(None)
    return out


def logical_axes(cfg: "RecsysConfig") -> dict:
    """The reference's logical axes of every leaf (nested dict of ``L``)."""
    if cfg.model == "dlrm":
        return {"tables": L("fields", "table_rows", None),
                "bot": _mlp_axes((cfg.n_dense,) + tuple(cfg.bot_mlp)),
                "top": _mlp_axes((0,) + tuple(cfg.top_mlp))}
    if cfg.model == "din":
        return {"table": L("table_rows", None),
                "attn": _mlp_axes((0,) + tuple(cfg.attn_mlp) + (1,)),
                "mlp": _mlp_axes((0,) + tuple(cfg.mlp) + (1,))}
    if cfg.model == "sasrec":
        blk = {"wq": L(None, None, None), "wk": L(None, None, None),
               "wv": L(None, None, None), "ln1": L(None, None),
               "ln2": L(None, None), "f1": L(None, None, None),
               "f2": L(None, None, None)}
        return {"table": L("table_rows", None), "pos": L(None, None),
                "blocks": blk, "ln_f": L(None)}
    if cfg.model == "mind":
        return {"table": L("table_rows", None), "bilinear": L(None, None),
                "b_init": L(None, None)}
    raise ValueError(f"unknown recsys model {cfg.model!r}")


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
    twin.  False: the flat twin over :func:`stacked_bag_operands`.  Both
    are differentiable in ``tables`` (``ops.embed_bag``), with ``out``
    None where autograd records.
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
# Shared pieces
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


def _mlp_params(dims, dtype, device) -> nn.ParameterDict:
    """``w{i}`` [in, out] and ``b{i}`` [out], the reference's layout."""
    out = nn.ParameterDict()
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = nn.Parameter(torch.empty((a, b), dtype=dtype,
                                                device=device))
        out[f"b{i}"] = nn.Parameter(torch.empty((b,), dtype=dtype,
                                                device=device))
    return out


def _draw_mlp(p: nn.ParameterDict, gen: torch.Generator) -> None:
    """normal / √fan_in weights, zero biases (the reference's law)."""
    for i in range(len(p) // 2):
        w = p[f"w{i}"]
        w.copy_(_normal(w.shape, gen, w.device) / math.sqrt(w.shape[0]))
        p[f"b{i}"].zero_()


def _dense_mlp(p: nn.ParameterDict, x: Tensor, n: int,
               final_act: bool = False) -> Tensor:
    """The reference's ``_mlp``: ``x @ w{i} + b{i}``, ReLU between."""
    for i in range(n):
        x = torch.matmul(x, p[f"w{i}"]) + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def _normal(shape, gen: torch.Generator, device) -> Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _rows(table: Tensor, n: int) -> Tensor:
    """The first ``n`` rows of ``table`` (the table itself when it has no
    more: a DTensor sharded by rows then stays as it is placed)."""
    return table if table.shape[0] == n else table[:n]


def _mesh_bags(tables: Tensor, sparse: Tensor,
               use_kernel: Optional[bool] = None) -> Tensor:
    """f32 bags [B, F, D] of DTensor tables [F, V, D] sharded by rows, placed
    like ``sparse``: each device sums, on its own block, the slots that fall
    in the rows it holds (kernel D's stacked form, or its twin on CPU or
    fake tensors, every other slot a pad), and the partial bags are summed
    over the row shards.  Where a mesh dimension splits both the rows and
    the batch (``pod``), the indices are all-gathered over it and the bags
    reduce-scattered back; where it splits the rows alone (``model``), the
    bags are all-reduced.  The local tables' gradient is partial over the
    mesh dimensions that split the batch but not the rows."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh, pl, spl = tables.device_mesh, tables.placements, sparse.placements
    rdims = [i for i, p in enumerate(pl) if p == Shard(1)]
    gdims = [i for i in rdims if spl[i].is_shard()]
    loc = tables.to_local(grad_placements=tuple(
        Partial() if p.is_replicate() and spl[i].is_shard() else p
        for i, p in enumerate(pl)))
    Vl = loc.shape[1]
    blk = 0             # the block's index, major to minor in mesh order
    for i in rdims:
        blk = blk * mesh.size(i) + mesh.get_local_rank(i)
    idx = sparse.to_local().to(torch.int32)
    for i in gdims:
        idx = funcol.wait_tensor(funcol.all_gather_tensor(idx, 0, (mesh, i)))
    mine = idx - blk * Vl
    mine = torch.where((idx >= 0) & (mine >= 0) & (mine < Vl), mine, -1)
    bags = ops.embed_bag(loc.contiguous(), mine.contiguous(),
                         use_kernel=use_kernel)                 # f32
    for i in reversed(gdims):
        bags = _ReduceScatter.apply(bags, mesh, i)
    for i in rdims:
        if i not in gdims:
            bags = _AllReduce.apply(bags, mesh, i)
    B, F, D = sparse.shape[0], tables.shape[0], tables.shape[2]
    return DTensor.from_local(bags, mesh, spl, run_check=False,
                              shape=torch.Size((B, F, D)),
                              stride=(F * D, D, 1))


class _ReduceScatter(torch.autograd.Function):
    """Sum over mesh dimension ``dim`` and keep this rank's block of rows;
    the backward all-gathers the rows' gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        from torch.distributed import _functional_collectives as funcol

        ctx.group = (mesh, dim)
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            x.contiguous(), "sum", 0, (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_gather_tensor(
            g.contiguous(), 0, ctx.group)), None, None


class _AllReduce(torch.autograd.Function):
    """Sum of partial values over mesh dimension ``dim``, replicated on it;
    the backward passes the (replicated) gradient to every partial."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _row_blocks(table: Tensor) -> Tensor:
    """A DTensor table whose rows split over several mesh dimensions (the
    ``table_rows`` rule's ``(pod, model)``) gathered to its split over the
    last of them: DTensor's row-sharded gather handles one such
    dimension.  A plain tensor as it is."""
    pl = getattr(table, "placements", None)
    if pl is None:
        return table
    from torch.distributed.tensor import Replicate, Shard

    dims = [i for i, p in enumerate(pl) if p == Shard(0)]
    if len(dims) < 2:
        return table
    return table.redistribute(table.device_mesh, tuple(
        Replicate() if p == Shard(0) and i != dims[-1] else p
        for i, p in enumerate(pl)))


def _take(table: Tensor, idx: Tensor) -> Tensor:
    """``jnp.take(table, idx, axis=0)``: rows of ``table`` at ``idx``.
    ``F.embedding`` and not ``table[idx]``: both gather the same rows, but
    the indexing's backward (``index_put_`` with accumulate) adds the
    gradients of one row one after another, and every pad of a history
    (about half its slots) gathers row 0, while the embedding's backward
    sums a row's run of sorted slots in parallel segments."""
    return R.settled(embedding(idx.long(), _row_blocks(table)))


def _gather(table: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``table`` at ``idx`` (pad -1): zeros at the pads."""
    valid = idx >= 0
    rows = _take(table, torch.where(valid, idx, 0))
    return torch.where(valid[..., None], rows, 0)


def _mul_u32(x: Tensor, c: int) -> Tensor:
    """(x · c) mod 2³² for int64 ``x`` in [0, 2³²): uint32 wrapping
    arithmetic in int64, in two 16-bit halves of ``c`` so that no product
    leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _u32(x: Tensor) -> Tensor:
    """int32 ``x`` as the reference's ``astype(uint32)`` (-1 → 2³² - 1),
    held in int64."""
    return x.long() & 0xFFFFFFFF


class _Recsys(nn.Module):
    """What the four models share: their config, a device, the draw from a
    ``torch.Generator`` (None: seed 0) and :meth:`leaves`."""

    MODEL = ""

    def __init__(self, cfg: RecsysConfig, device=None):
        super().__init__()
        if cfg.model != self.MODEL:
            raise ValueError(f"config {cfg.name!r} is a {cfg.model!r} "
                             f"model, not {self.MODEL!r}")
        self.cfg = cfg
        self._device = resolve_device(device)
        self._dtype = _DTYPES[cfg.dtype]

    def _param(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape, dtype=self._dtype,
                                        device=self._device))

    def _init(self, generator, draw: bool) -> None:
        if draw:
            if generator is None:
                generator = torch.Generator(
                    device=self._device).manual_seed(0)
            with torch.no_grad():
                self._draw(generator)

    def leaves(self, grad: bool = False) -> dict:
        """{reference leaf path: tensor} in the reference's tree order
        (``.grad`` of each, zeros where it has none, when ``grad``)."""
        return tree_leaves(self, grad)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091) — rm2 config
# ---------------------------------------------------------------------------

class InteractionInput(torch.autograd.Function):
    """The training form of DLRM's [B, F+1, D] interaction buffer.

    Forward: allocate the buffer, copy x0 into row 0 and launch kernel D's
    stacked form into rows 1.. (its twin on CPU tensors).  Backward: row 0
    of the upstream gradient is x0's; kernel D's backward kernel reads rows
    1.. where they lie (a view of row stride (F+1)·D) and writes the dense
    gradient of the tables.  The serving form writes x0 with the bottom
    MLP's last ReLU instead, which autograd cannot record.
    """

    @staticmethod
    def forward(ctx, x0, tables, sparse, use_kernel):
        n_f, V, D = tables.shape
        vecs = torch.empty((x0.shape[0], n_f + 1, D), dtype=tables.dtype,
                           device=tables.device)
        vecs[:, 0].copy_(x0)
        stacked_embedding_bag(tables, sparse, out=vecs[:, 1:],
                              use_kernel=use_kernel)
        ctx.save_for_backward(sparse)
        ctx.meta = (V, tables.dtype, use_kernel)
        return vecs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        sparse, = ctx.saved_tensors
        V, dtype, use_kernel = ctx.meta
        g_tables = None
        if ctx.needs_input_grad[1]:
            g_tables = ops.embed_bag_backward(
                grad[:, 1:], sparse, V, use_kernel=use_kernel).to(dtype)
        return grad[:, 0], g_tables, None, None


class DLRM(_Recsys):
    """DLRM with stacked field tables [n_sparse, V, D] and bottom / top
    MLPs of ``nn.Linear``.

    ``generator`` (a ``torch.Generator`` on ``device``; None: seed 0) draws
    the weights with the reference's law: normal / √fan_in, zero biases.
    The tables are drawn on ``device`` one field at a time, so no host
    array of their size exists.  ``draw=False`` leaves them uninitialised
    (:func:`repro_torch.convert.recsys_params_from_numpy` fills them).
    ``device`` None means the CUDA card.
    """

    MODEL = "dlrm"

    def __init__(self, cfg: RecsysConfig, generator=None, device=None, *,
                 draw: bool = True):
        super().__init__(cfg, device)
        dev, dtype = self._device, self._dtype
        D = cfg.embed_dim
        self.tables = self._param(cfg.n_sparse, cfg.vocab_per_field, D)
        n_f = cfg.n_sparse + 1
        self.bot = _linears((cfg.n_dense,) + tuple(cfg.bot_mlp), dtype, dev)
        self.top = _linears((cfg.bot_mlp[-1] + n_f * (n_f - 1) // 2,)
                            + tuple(cfg.top_mlp), dtype, dev)
        iu, ju = torch.triu_indices(n_f, n_f, 1, device=dev)
        self.register_buffer("iu", iu, persistent=False)
        self.register_buffer("ju", ju, persistent=False)
        self._init(generator, draw)

    def _draw(self, gen: torch.Generator) -> None:
        dev = self.tables.device
        V, D = self.tables.shape[1:]
        for f in range(self.tables.shape[0]):
            self.tables[f].copy_(_normal((V, D), gen, dev) / math.sqrt(D))
        for lin in (*self.bot, *self.top):
            out_f, in_f = lin.weight.shape
            lin.weight.copy_(_normal((out_f, in_f), gen, dev)
                             / math.sqrt(in_f))
            lin.bias.zero_()

    def leaves(self, grad: bool = False) -> dict:
        """{leaf path: tensor}: ``tables``, and ``bot/w{i}`` [in, out] /
        ``bot/b{i}`` (and ``top/...``) as views of the ``nn.Linear``
        weights (transposed) and biases."""
        pick = (lambda p: p.grad if p.grad is not None
                else torch.zeros_like(p)) if grad else (lambda p: p)
        out = {}
        for name in ("bot", "top"):
            layers = getattr(self, name)
            out.update({f"{name}/b{i}": pick(lin.bias)
                        for i, lin in enumerate(layers)})
            out.update({f"{name}/w{i}": pick(lin.weight).t()
                        for i, lin in enumerate(layers)})
        out["tables"] = pick(self.tables)
        return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))

    def interaction_input(self, dense: Tensor, sparse: Tensor, *,
                          use_kernel: Optional[bool] = None, mesh=None,
                          rules=None) -> Tensor:
        """vecs [B, n_sparse + 1, D]: the bottom MLP's output x0 in row 0,
        the field bags in rows 1.. .  Kernel path (``use_kernel`` None or
        True): the buffer is allocated once and kernel D writes the bags
        into rows 1..; without gradients the bottom MLP's last ReLU writes
        x0 into row 0, with them :class:`InteractionInput` copies it there.
        Nothing is concatenated.  ``use_kernel=False``: the twin program,
        x0 and the twin's bags concatenated."""
        tables = self.tables
        dense = dense.to(tables.dtype)
        if R.mesh_size(mesh) > 1:
            x0 = _mlp(self.bot, dense, final_act=True)
            emb = R.constrain(_mesh_bags(tables, sparse, use_kernel), mesh,
                              ("batch", None, None), rules)
            return torch.cat([x0[:, None, :], emb.to(tables.dtype)], dim=1)
        if use_kernel is False:
            x0 = _mlp(self.bot, dense, final_act=True)
            emb = stacked_embedding_bag(tables, sparse, use_kernel=False)
            return torch.cat([x0[:, None, :], emb], dim=1)
        if torch.is_grad_enabled():
            x0 = _mlp(self.bot, dense, final_act=True)
            return InteractionInput.apply(
                x0, tables, sparse.to(torch.int32).contiguous(), use_kernel)
        F, _, D = tables.shape
        vecs = torch.empty((dense.shape[0], F + 1, D), dtype=tables.dtype,
                           device=tables.device)
        _mlp(self.bot, dense, final_act=True, out=vecs[:, 0])
        stacked_embedding_bag(tables, sparse, out=vecs[:, 1:],
                              use_kernel=use_kernel)
        return vecs

    def features(self, dense: Tensor, sparse: Tensor, *,
                 use_kernel: Optional[bool] = None, mesh=None, rules=None):
        """(x0 [B, D] bottom-MLP output, emb [B, n_sparse, D] field bags):
        views of :meth:`interaction_input`'s rows."""
        vecs = self.interaction_input(dense, sparse, use_kernel=use_kernel,
                                      mesh=mesh, rules=rules)
        return vecs[:, 0], vecs[:, 1:]

    def head(self, vecs: Tensor, mesh=None, rules=None) -> Tensor:
        """CTR logits [B] from the interaction buffer: the top MLP over x0
        and the strict upper triangle (row-major) of the Gram matrix of
        [x0; emb]."""
        gram = torch.bmm(vecs, vecs.transpose(1, 2))
        if R.mesh_size(mesh) == 1:
            inter = gram[:, self.iu, self.ju]                # [B, F(F+1)/2]
        else:
            # each device picks the pairs of its own batch rows (DTensor's
            # index ops and their backwards vary between versions)
            from torch.distributed.tensor import DTensor

            gram = R.constrain(gram, mesh, ("batch", None, None), rules)
            n = gram.shape[1]
            iu, ju = torch.triu_indices(n, n, 1, device=gram.device)
            pairs = gram.to_local()[:, iu, ju]
            B, P = gram.shape[0], iu.shape[0]
            inter = DTensor.from_local(pairs, mesh, gram.placements,
                                       run_check=False,
                                       shape=torch.Size((B, P)),
                                       stride=(P, 1))
        return _mlp(self.top, torch.cat([vecs[:, 0], inter], dim=-1))[:, 0]

    def forward(self, dense: Tensor, sparse: Tensor, *,
                use_kernel: Optional[bool] = None, mesh=None,
                rules=None) -> Tensor:
        """CTR logits [B] (:meth:`head` of :meth:`interaction_input`)."""
        return self.head(self.interaction_input(
            dense, sparse, use_kernel=use_kernel, mesh=mesh, rules=rules),
            mesh, rules)

    def score(self, batch: RecsysBatch, use_kernel=None, mesh=None,
              rules=None) -> Tensor:
        return self(batch.dense, batch.sparse, use_kernel=use_kernel,
                    mesh=mesh, rules=rules)

    def loss(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        return _bce(self.score(batch, use_kernel, mesh, rules), batch.labels)

    def user(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        """x0 + the mean of the field bags (the two-tower factorisation)."""
        x0, emb = self.features(batch.dense, batch.sparse,
                                use_kernel=use_kernel, mesh=mesh,
                                rules=rules)
        return x0 + emb.mean(dim=1)

    def items(self) -> Tensor:
        return _rows(self.tables[0], self.cfg.n_items)


# ---------------------------------------------------------------------------
# DIN (arXiv:1706.06978)
# ---------------------------------------------------------------------------

class DIN(_Recsys):
    """Target attention over the user's history: ``table`` [n_items, D],
    ``attn`` (4D → attn_mlp → 1) and ``mlp`` (2D → mlp → 1) of
    ``w{i}`` [in, out] / ``b{i}``."""

    MODEL = "din"

    def __init__(self, cfg: RecsysConfig, generator=None, device=None, *,
                 draw: bool = True):
        super().__init__(cfg, device)
        D = cfg.embed_dim
        self.table = self._param(cfg.n_items, D)
        self.attn = _mlp_params((4 * D,) + tuple(cfg.attn_mlp) + (1,),
                                self._dtype, self._device)
        self.mlp = _mlp_params((2 * D,) + tuple(cfg.mlp) + (1,),
                               self._dtype, self._device)
        self._init(generator, draw)

    def _draw(self, gen: torch.Generator) -> None:
        D = self.cfg.embed_dim
        self.table.copy_(_normal(self.table.shape, gen, self._device)
                         / math.sqrt(D))
        _draw_mlp(self.attn, gen)
        _draw_mlp(self.mlp, gen)

    def _user(self, batch: RecsysBatch):
        """Target-attention pooled user interest vector, and the target's
        embedding."""
        valid = batch.hist >= 0
        eh = _gather(self.table, batch.hist)                  # [B, S, D]
        et = _take(self.table, batch.target)                  # [B, D]
        etb = et[:, None, :].expand(eh.shape)
        a_in = torch.cat([eh, etb, eh * etb, eh - etb], dim=-1)
        logits = _dense_mlp(self.attn, a_in,
                            len(self.cfg.attn_mlp) + 1)[..., 0]
        logits = torch.where(valid, logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bs,bsd->bd", w, eh), et

    def score(self, batch: RecsysBatch, use_kernel=None, mesh=None,
              rules=None) -> Tensor:
        u, et = self._user(batch)
        x = torch.cat([u, et], dim=-1)
        return _dense_mlp(self.mlp, x, len(self.cfg.mlp) + 1)[:, 0]

    def loss(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        return _bce(self.score(batch), batch.labels)

    def user(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        """The mean embedding of the valid history."""
        eh = _gather(self.table, batch.hist)
        n = (batch.hist >= 0).sum(-1, keepdim=True).clamp_min(1)
        return eh.sum(1) / n

    def items(self) -> Tensor:
        return _rows(self.table, self.cfg.n_items)


# ---------------------------------------------------------------------------
# SASRec (arXiv:1808.09781)
# ---------------------------------------------------------------------------

_BLOCK_LEAVES = ("wq", "wk", "wv", "ln1", "ln2", "f1", "f2")


def _ln(x: Tensor, s: Tensor, eps: float = 1e-6) -> Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s


class SASRec(_Recsys):
    """Causal self-attention over the history: ``table``, ``pos``
    [seq_len, D], ``blocks`` (each leaf stacked on a leading n_blocks axis,
    as the reference's ``lax.scan`` reads them) and ``ln_f``."""

    MODEL = "sasrec"

    def __init__(self, cfg: RecsysConfig, generator=None, device=None, *,
                 draw: bool = True):
        super().__init__(cfg, device)
        D, nb = cfg.embed_dim, cfg.n_blocks
        self.table = self._param(cfg.n_items, D)
        self.pos = self._param(cfg.seq_len, D)
        self.blocks = nn.ParameterDict(
            {k: self._param(nb, D) if k.startswith("ln")
             else self._param(nb, D, D) for k in _BLOCK_LEAVES})
        self.ln_f = self._param(D)
        self._init(generator, draw)

    def _draw(self, gen: torch.Generator) -> None:
        D, dev = self.cfg.embed_dim, self._device
        self.table.copy_(_normal(self.table.shape, gen, dev) / math.sqrt(D))
        self.pos.copy_(_normal(self.pos.shape, gen, dev) * 0.02)
        for k, p in self.blocks.items():
            if k.startswith("ln"):
                p.fill_(1.0)
            else:
                p.copy_(_normal(p.shape, gen, dev) * (1 / math.sqrt(D)))
        self.ln_f.fill_(1.0)

    def hidden(self, hist: Tensor) -> Tensor:
        """[B, S, D] states after the blocks and the final norm, zero at the
        history's pads."""
        valid = hist >= 0
        x = _gather(self.table, hist) + self.pos[None]
        S = hist.shape[1]
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                       device=hist.device))
        mask = causal[None] & valid[:, None, :]
        for i in range(self.cfg.n_blocks):
            bp = {k: v[i] for k, v in self.blocks.items()}
            h = _ln(x, bp["ln1"])
            q, k, v = h @ bp["wq"], h @ bp["wk"], h @ bp["wv"]
            s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(q.shape[-1])
            s = torch.where(mask, s, -1e30)
            x = x + torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)
            h = _ln(x, bp["ln2"])
            x = x + torch.relu(h @ bp["f1"]) @ bp["f2"]
        return _ln(x, self.ln_f) * valid[..., None]

    def user(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        return self.hidden(batch.hist)[:, -1, :]

    def loss(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        """Next-item BCE with one uniform negative per position (the
        paper's): positions 0..S-2 predict the items at 1..S-1."""
        hist = batch.hist
        h = self.hidden(hist)[:, :-1, :]
        pos_items = hist[:, 1:]
        valid = pos_items >= 0
        pe = _take(self.table, torch.where(valid, pos_items, 0))
        neg = (_mul_u32(_u32(pos_items), 2654435761) + 12345) & 0xFFFFFFFF
        ne = _take(self.table, neg % self.cfg.n_items)
        lp = torch.einsum("bsd,bsd->bs", h, pe)
        ln_ = torch.einsum("bsd,bsd->bs", h, ne)
        per = torch.log1p(torch.exp(-lp)) + torch.log1p(torch.exp(ln_))
        return (torch.sum(torch.where(valid, per, 0))
                / valid.sum().clamp_min(1))

    def items(self) -> Tensor:
        return _rows(self.table, self.cfg.n_items)


# ---------------------------------------------------------------------------
# MIND (arXiv:1904.08030) — multi-interest dynamic routing
# ---------------------------------------------------------------------------

def _squash(x: Tensor) -> Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1 + n2)) * x / torch.sqrt(n2 + 1e-9)


class MIND(_Recsys):
    """B2I dynamic routing into ``n_interests`` capsules: ``table``,
    ``bilinear`` [D, D] (the shared S matrix) and ``b_init``
    [n_interests, seq_len] routing logits."""

    MODEL = "mind"
    N_NEG = 64                     # uniform negatives a sample (the loss)

    def __init__(self, cfg: RecsysConfig, generator=None, device=None, *,
                 draw: bool = True):
        super().__init__(cfg, device)
        D = cfg.embed_dim
        self.table = self._param(cfg.n_items, D)
        self.bilinear = self._param(D, D)
        self.b_init = self._param(cfg.n_interests, cfg.seq_len)
        self._init(generator, draw)

    def _draw(self, gen: torch.Generator) -> None:
        D, dev = self.cfg.embed_dim, self._device
        self.table.copy_(_normal(self.table.shape, gen, dev) / math.sqrt(D))
        self.bilinear.copy_(_normal((D, D), gen, dev) / math.sqrt(D))
        self.b_init.copy_(_normal(self.b_init.shape, gen, dev))

    def interests(self, hist: Tensor) -> Tensor:
        """[B, K, D] interest capsules.  The routing softmax runs over the
        interests and the history's pads are masked after it."""
        valid = hist >= 0
        e = _gather(self.table, hist)                         # [B, S, D]
        el = e @ self.bilinear
        b = self.b_init[None].expand((e.shape[0],) + self.b_init.shape)
        caps = None
        for _ in range(self.cfg.capsule_iters):
            w = torch.softmax(b, dim=1)
            w = torch.where(valid[:, None, :], w, 0)
            caps = _squash(torch.einsum("bks,bsd->bkd", w, el))
            b = b + torch.einsum("bkd,bsd->bks", caps, el)
        return caps

    def loss(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        """Label-aware attention + sampled softmax against uniform
        negatives."""
        caps = self.interests(batch.hist)
        et = _take(self.table, batch.target)
        att = torch.softmax(torch.einsum("bkd,bd->bk", caps, et) * 2.0,
                            dim=-1)
        u = torch.einsum("bk,bkd->bd", att, caps)
        k = torch.arange(1, self.N_NEG + 1, device=caps.device)
        t1 = (_u32(batch.target)[:, None] + 1) & 0xFFFFFFFF
        neg = _mul_u32((t1 * k) & 0xFFFFFFFF, 2654435761)
        en = _take(self.table, neg % self.cfg.n_items)        # [B, n, D]
        lp = torch.einsum("bd,bd->b", u, et)
        ln_ = torch.einsum("bd,bnd->bn", u, en)
        logits = torch.cat([lp[:, None], ln_], dim=1)
        return torch.mean(torch.logsumexp(logits, dim=-1) - lp)

    def user(self, batch: RecsysBatch, use_kernel=None, mesh=None,
             rules=None) -> Tensor:
        """The strongest interest (the first on ties)."""
        caps = self.interests(batch.hist)
        norms = torch.sqrt(torch.sum(caps * caps, dim=-1))
        best = torch.argmax(norms, dim=-1)
        return caps[torch.arange(caps.shape[0], device=caps.device), best]

    def items(self) -> Tensor:
        return _rows(self.table, self.cfg.n_items)


# ---------------------------------------------------------------------------
# Dispatch table: the reference's entry points
# ---------------------------------------------------------------------------

MODELS = {"dlrm": DLRM, "din": DIN, "sasrec": SASRec, "mind": MIND}


def _check(params: _Recsys, cfg: RecsysConfig) -> _Recsys:
    if cfg.model not in MODELS:
        raise ValueError(f"unknown recsys model {cfg.model!r}")
    if params.cfg.model != cfg.model:
        raise ValueError(f"a {params.cfg.model!r} model cannot run config "
                         f"{cfg.name!r} of a {cfg.model!r} model")
    return params


def init_params(generator, cfg: RecsysConfig, dtype: Optional[str] = None,
                device=None) -> _Recsys:
    """The model's parameters: the ``cfg.model`` module drawn from
    ``generator``, in ``dtype`` (a ``RecsysConfig.dtype`` name; None:
    ``cfg.dtype``)."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown recsys model {cfg.model!r}")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return MODELS[cfg.model](cfg, generator=generator, device=device)


def abstract_params(cfg: RecsysConfig, dtype: Optional[str] = None):
    """The model on ``meta``: the reference's shapes and dtypes, nothing
    allocated (the dry-run path)."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown recsys model {cfg.model!r}")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return MODELS[cfg.model](cfg, device="meta", draw=False)


def _score(params, batch, cfg, use_kernel=None, mesh=None,
           rules=None) -> Tensor:
    m = _check(params, cfg)
    if cfg.model in ("dlrm", "din"):
        return m.score(batch, use_kernel, mesh, rules)
    u = m.user(batch)
    target = batch.target.long()
    et = _take(m.items(), target) if R.mesh_size(mesh) > 1 \
        else m.items()[target]
    return torch.einsum("bd,bd->b", u, et)


@torch.no_grad()
def score(params: _Recsys, batch: RecsysBatch, cfg: RecsysConfig, *,
          use_kernel: Optional[bool] = None, mesh=None,
          rules=None) -> Tensor:
    """Pointwise serving logit [B] (CTR for dlrm/din; u·target for the
    sequence models)."""
    return _score(params, batch, cfg, use_kernel, mesh, rules)


def loss(params: _Recsys, batch: RecsysBatch, cfg: RecsysConfig, *,
         use_kernel: Optional[bool] = None, mesh=None,
         rules=None) -> Tensor:
    """The training objective (a 0-d tensor with its autograd graph):
    BCE of the CTR logit for dlrm/din, SASRec's next-item BCE, MIND's
    sampled softmax."""
    return _check(params, cfg).loss(batch, use_kernel, mesh, rules)


@torch.no_grad()
def user_repr(params: _Recsys, batch: RecsysBatch, cfg: RecsysConfig, *,
              use_kernel: Optional[bool] = None, mesh=None,
              rules=None) -> Tensor:
    """[B, D] MIPS query vector for retrieval."""
    return _check(params, cfg).user(batch, use_kernel, mesh, rules)


@torch.no_grad()
def item_embeddings(params: _Recsys, cfg: RecsysConfig) -> Tensor:
    """[n_items, D] retrieval candidate matrix (a view of the item table;
    DLRM's field 0), detached from autograd."""
    return _check(params, cfg).items().detach()


@torch.no_grad()
def retrieval_scores(params: _Recsys, batch: RecsysBatch, cfg: RecsysConfig,
                     *, use_kernel: Optional[bool] = None, mesh=None,
                     rules=None) -> Tensor:
    """retrieval_cand shape: [B, n_items] scores of the users against the
    full candidate set (the dense batched-dot MIPS path)."""
    u = user_repr(params, batch, cfg, use_kernel=use_kernel, mesh=mesh,
                  rules=rules)
    items = R.constrain(item_embeddings(params, cfg), mesh,
                        ("candidates", None), rules)
    s = torch.matmul(u, items.t())
    return R.constrain(s, mesh, ("batch", "candidates"), rules)


def sparsify_items(items: Tensor, t: int):
    """The item catalog as sparse vectors for the Sinnamon index: each
    item's t largest-|value| coordinates, in ascending coordinate order,
    as ``examples/recsys_retrieval.py`` builds them.  Returns
    (idx int32[V, t], val f32[V, t])."""
    top = torch.topk(items.abs(), t, dim=1).indices
    idx = torch.sort(top, dim=1).values
    return idx.to(torch.int32), items.gather(1, idx).to(torch.float32)
