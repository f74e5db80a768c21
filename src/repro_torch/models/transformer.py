"""Decoder-only LM family in PyTorch, as ``repro.models.transformer``: dense
(deepseek-67b, stablelm-12b, gemma3-27b with 5:1 local:global attention)
and MoE (llama4-scout 16e top-1, moonshot 64e top-6), with GQA, RoPE,
rematerialised layers, cross-entropy and a KV-cache decode path.

The parameters are a :class:`TransformerLM` holding the reference's stacked
leaves (``[L, ...]`` under ``layers/``); :meth:`TransformerLM.leaves` names
them by the reference's leaf paths, which is how the optimiser, the
train-state checkpoints and ``repro_torch.convert`` see them.  The entry
points are the reference's:

    init_params(generator, cfg)          — the model, the reference's law
    forward(params, tokens, cfg)         — final hidden, aux[, KV cache]
    lm_loss(params, tokens, labels, cfg) — training objective
    prefill(params, tokens, cfg)         — last-position logits + cache
    init_cache(cfg, batch, max_seq)      — an empty heads-major cache
    decode_step(params, cache, tokens, pos, cfg)

A Python loop runs the layers (the reference scans them), each with its
window; the weights are cast to the activation dtype at each use, as the
reference's ``.astype(h.dtype)``.  ``prefill`` and ``decode_step`` run
under ``torch.no_grad()`` and write the cache in place.

The mesh tooling is the reference's: ``abstract_params`` / ``abstract_cache``
(the model and cache on ``meta``: shapes and dtypes, no storage),
``logical_axes`` / ``cache_logical_axes``, and the ``mesh`` / ``rules``
arguments, with which the entry points run on DTensors and pin the
reference's placements (``repro_torch.distributed.rules.constrain``) at the
reference's points; ``repro_torch.launch.dryrun`` places every LM cell that
way.  With ``mesh`` None or of one device they compute exactly what they
compute without one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.functional import embedding
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.distributed import rules as R
from repro_torch.distributed.rules import L
from repro_torch.models import layers, tree_leaves

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 500_000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    group_size: int = 4096
    # local:global interleave (gemma3): ratio local layers per global layer
    local_window: int = 0
    local_global_ratio: int = 0
    # numerics / scheduling (attn_q_chunk changes no row's arithmetic; see
    # layers.blockwise_attention)
    dtype: str = "bfloat16"
    attn_chunk: int = 512
    attn_q_chunk: int = 512
    remat: bool = True

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6·N·D accounting)."""
        c = self
        attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
        if c.moe:
            mlp = 3 * c.d_model * c.d_ff * c.n_experts + c.d_model * c.n_experts
        else:
            mlp = 3 * c.d_model * c.d_ff
        per_layer = attn + mlp + 2 * c.d_model
        return (c.n_layers * per_layer + 2 * c.vocab * c.d_model + c.d_model)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        c = self
        attn = c.d_model * c.head_dim * (c.n_heads * 2 + c.n_kv_heads * 2)
        mlp = 3 * c.d_model * c.d_ff * c.moe_top_k + c.d_model * c.n_experts
        per_layer = attn + mlp + 2 * c.d_model
        return (c.n_layers * per_layer + 2 * c.vocab * c.d_model + c.d_model)


def layer_is_global(cfg: LMConfig) -> np.ndarray:
    """bool[n_layers]; gemma3 pattern = ratio local layers then one global."""
    if cfg.local_global_ratio <= 0:
        return np.ones(cfg.n_layers, bool)
    period = cfg.local_global_ratio + 1
    return np.array([(i % period) == cfg.local_global_ratio
                     for i in range(cfg.n_layers)])


def _windows(cfg: LMConfig) -> list:
    """Each layer's attention window (0: unlimited)."""
    return [0 if g else cfg.local_window for g in layer_is_global(cfg)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: LMConfig) -> dict:
    """{leaf: (per-layer shape, init scale or None for ones)} of the
    stacked layer leaves, in the reference's draw order."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s = 1.0 / math.sqrt(d)
    out = {"ln1": ((d,), None), "ln2": ((d,), None),
           "wq": ((d, H, hd), s), "wk": ((d, KV, hd), s),
           "wv": ((d, KV, hd), s),
           "wo": ((H, hd, d), s / math.sqrt(2 * cfg.n_layers))}
    f = cfg.d_ff
    if cfg.moe:
        E = cfg.n_experts
        out.update({"router": ((d, E), s), "wi": ((E, d, f), s),
                    "wg": ((E, d, f), s), "wo_mlp": ((E, f, d), 1 / math.sqrt(f))})
    else:
        out.update({"wi": ((d, f), s), "wg": ((d, f), s),
                    "wo_mlp": ((f, d), 1 / math.sqrt(f))})
    return out


class TransformerLM(nn.Module):
    """The LM's parameters: ``embed`` [V, d], ``layers`` (each leaf stacked
    over the L layers), ``ln_f`` [d] and ``unembed`` [d, V], in ``dtype``
    on ``device`` (None: the CUDA card).

    ``generator`` (a ``torch.Generator`` on ``device``; None: seed 0) draws
    them with the reference's law: N(0, 1)·scale in f32, cast to ``dtype``,
    norms at 1.  A stacked leaf is drawn one layer slice at a time, so no f32
    array of a whole leaf exists.  ``draw=False`` leaves them uninitialised
    (``repro_torch.convert.lm_params_from_numpy`` fills them).
    """

    def __init__(self, cfg: LMConfig, generator=None, dtype=torch.float32,
                 device=None, *, draw: bool = True):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.embed = param(V, d)
        self.layers = nn.ParameterDict(
            {k: param(L, *shape) for k, (shape, _) in
             _layer_shapes(cfg).items()})
        self.ln_f = param(d)
        self.unembed = param(d, V)
        if draw:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                self._draw(generator)

    def _draw(self, gen: torch.Generator) -> None:
        def nrm(t: Tensor, scale: float) -> None:
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                    * scale)

        nrm(self.embed, 1.0)
        for k, (_, scale) in _layer_shapes(self.cfg).items():
            for t in self.layers[k]:
                if scale is None:
                    t.fill_(1.0)
                else:
                    nrm(t, scale)
        self.ln_f.fill_(1.0)
        nrm(self.unembed, 1.0 / math.sqrt(self.cfg.d_model))

    def leaves(self, grad: bool = False) -> dict:
        """{reference leaf path: tensor} in the reference's tree order
        (``.grad`` of each, zeros where it has none, when ``grad``)."""
        return tree_leaves(self, grad)

    def layer_weights(self) -> list:
        """Per layer, {leaf: its slice}: views of the stacked leaves whose
        gradients stack back in one copy (``unbind``'s backward)."""
        names = list(self.layers.keys())
        per = zip(*(self.layers[k].unbind(0) for k in names))
        return [dict(zip(names, ts)) for ts in per]


def init_params(generator, cfg: LMConfig, dtype=torch.float32,
                device=None) -> TransformerLM:
    """The model drawn from ``generator`` (None: seed 0) in ``dtype``."""
    return TransformerLM(cfg, generator, dtype, device)


def abstract_params(cfg: LMConfig, dtype=torch.float32) -> TransformerLM:
    """The model on ``meta``: the reference's shapes and dtypes, nothing
    allocated (the dry-run path)."""
    return TransformerLM(cfg, dtype=dtype, device="meta", draw=False)


def logical_axes(cfg: LMConfig) -> dict:
    """The reference's logical axes of every leaf, as a nested dict of
    :class:`~repro_torch.distributed.rules.L`."""
    lp = {
        "ln1": L(None, "embed"),
        "ln2": L(None, "embed"),
        "wq": L(None, "fsdp", "heads", None),
        "wk": L(None, "fsdp", "kv_heads", None),
        "wv": L(None, "fsdp", "kv_heads", None),
        "wo": L(None, "heads", None, "fsdp"),
    }
    if cfg.moe:
        lp.update({
            "router": L(None, "fsdp", None),
            "wi": L(None, "expert", "fsdp", "mlp"),
            "wg": L(None, "expert", "fsdp", "mlp"),
            "wo_mlp": L(None, "expert", "mlp", "fsdp"),
        })
    else:
        lp.update({
            "wi": L(None, "fsdp", "mlp"),
            "wg": L(None, "fsdp", "mlp"),
            "wo_mlp": L(None, "mlp", "fsdp"),
        })
    return {
        "embed": L("vocab", "fsdp"),
        "layers": lp,
        "ln_f": L("embed"),
        "unembed": L("fsdp", "vocab"),
    }


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------

def _qkv(lp: dict, x: Tensor, rot, cfg: LMConfig, mesh=None, rules=None):
    """q [B, S, H, hd] and the new k, v [B, S, KV, hd], RoPE'd by ``rot``
    (``layers.rope_tables`` of the positions), in x's dtype.  On a mesh
    each projection's heads are placed by their logical axis before the
    heads are split out (a head count that does not divide stays whole)."""
    B, S, d = x.shape
    # seq-full at the block's entry (the residual is seq-sharded)
    h = R.constrain(layers.rms_norm(x, lp["ln1"]), mesh,
                    ("batch", None, "embed"), rules)
    dt = h.dtype

    def proj(w, heads):
        flat = w.reshape(d, -1)
        if R.mesh_size(mesh) > 1:
            if not R.spec_for(mesh, (w.shape[1],), (heads,), rules):
                heads = None
            flat = R.gathered(flat, mesh, ("fsdp", heads), rules)
        out = torch.matmul(h, flat.to(dt))
        out = R.constrain(out, mesh, ("batch", None, heads), rules)
        return out.view(B, S, w.shape[1], w.shape[2])

    q = proj(lp["wq"], "heads")
    k, v = proj(lp["wk"], "kv_heads"), proj(lp["wv"], "kv_heads")
    return layers.apply_rope(q, *rot), layers.apply_rope(k, *rot), v


def _out_proj(lp: dict, attn: Tensor, mesh=None, rules=None) -> Tensor:
    B, S, H, hd = attn.shape
    wo = lp["wo"].reshape(H * hd, -1).to(attn.dtype)
    if R.mesh_size(mesh) > 1:
        heads = "heads" if R.spec_for(mesh, (H,), ("heads",), rules) \
            else None
        wo = R.gathered(wo, mesh, (heads, "fsdp"), rules)
    return torch.matmul(attn.reshape(B, S, H * hd), wo)


def _mlp_block(lp: dict, x: Tensor, cfg: LMConfig, moe_stats=None,
               mesh=None, rules=None):
    # seq-full at the block's entry, as the attention's
    h = R.constrain(layers.rms_norm(x, lp["ln2"]), mesh,
                    ("batch", None, "embed"), rules)
    if cfg.moe:
        return layers.moe_layer(
            h, lp["router"], lp["wi"], lp["wg"], lp["wo_mlp"],
            top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
            group_size=cfg.group_size, stats=moe_stats, mesh=mesh,
            rules=rules)
    return layers.swiglu_mlp(h, lp["wi"], lp["wg"], lp["wo_mlp"], mesh,
                             rules), None


_RESIDUAL = ("batch", "act_seq", "embed")


def _layer(x: Tensor, lp: dict, rot, window: int, cfg: LMConfig,
           moe_stats=None, mesh=None, rules=None):
    """One block: (x out, aux or None, (k, v) of the block)."""
    q, k, v = _qkv(lp, x, rot, cfg, mesh, rules)
    q = R.constrain(q, mesh, ("batch", None, "heads", None), rules)
    attn = layers.blockwise_attention(q, k, v, causal=True, window=window,
                                      chunk=cfg.attn_chunk, mesh=mesh,
                                      rules=rules)
    del q
    # seq-full at the block edge
    x = x + R.constrain(_out_proj(lp, attn, mesh, rules), mesh,
                        ("batch", None, "embed"),
                        rules)
    del attn
    mlp, aux = _mlp_block(lp, x, cfg, moe_stats, mesh, rules)
    return R.constrain(x + mlp, mesh, _RESIDUAL, rules), aux, (k, v)


def _remat_layer(x, rot, window, cfg, mesh, rules, names, *weights):
    out, aux, _ = _layer(x, dict(zip(names, weights)), rot, window, cfg,
                         mesh=mesh, rules=rules)
    return out, aux


def forward(params: TransformerLM, tokens: Tensor, cfg: LMConfig,
            collect_kv: bool = False, moe_stats: Optional[list] = None,
            *, mesh=None, rules=None):
    """tokens [B, S] -> (final hidden [B, S, d], aux_loss[, kv cache]).

    ``collect_kv=True`` also returns the per-layer K/V as a decode-ready
    heads-major cache {"k", "v"} of [L, B, KV, S, hd] (the prefill serving
    path), written layer by layer into one buffer.  With ``cfg.remat`` and
    gradients on, each layer is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  ``moe_stats``, a list,
    collects each MoE layer's routing counts (``layers.moe_layer``).
    """
    B, S = tokens.shape
    dt = cfg.tdtype
    embed = R.gathered(params.embed, mesh, ("vocab", "fsdp"), rules)
    x = embedding(tokens.long(), embed).to(dt)
    x = R.constrain(x, mesh, _RESIDUAL, rules)
    # one row of positions: the RoPE tables broadcast over the batch
    rot = layers.rope_tables(torch.arange(S, device=x.device)[None],
                             cfg.head_dim, cfg.rope_theta)
    cache = None
    if collect_kv:
        shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
        cache = {"k": _new_cache(x, shape, dt, mesh, rules),
                 "v": _new_cache(x, shape, dt, mesh, rules)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for li, (lp, window) in enumerate(zip(params.layer_weights(),
                                          _windows(cfg))):
        if remat and moe_stats is None and not collect_kv:
            names = list(lp)
            x, a = checkpoint(_remat_layer, x, rot, window, cfg, mesh, rules,
                              names, *lp.values(), use_reentrant=False)
        else:
            x, a, (k, v) = _layer(x, lp, rot, window, cfg, moe_stats, mesh,
                                  rules)
            if collect_kv:
                cache["k"][li] = R.constrain(k.transpose(1, 2), mesh,
                                             _CACHE_AXES[1:], rules)
                cache["v"][li] = R.constrain(v.transpose(1, 2), mesh,
                                             _CACHE_AXES[1:], rules)
            del k, v
        if a is not None:
            aux = aux + a
    x = layers.rms_norm(x, params.ln_f)
    if collect_kv:
        return x, aux / cfg.n_layers, cache
    return x, aux / cfg.n_layers


class _VocabParallelXent(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` in f32 from
    vocab-sharded DTensor logits [B, S, V] (Megatron's vocab-parallel
    cross-entropy, which the reference's GSPMD lowering is): each device
    reduces its own vocab block, and the per-token max, sum of exponentials
    and gold logit are all-reduced over the vocab's mesh dimensions.  The
    backward is local: (softmax - one-hot) · g."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, pl = logits.device_mesh, logits.placements
        dims = [i for i, p in enumerate(pl) if p == Shard(2)]
        tok_pl = tuple(Replicate() if p == Shard(2) else p for p in pl)

        def reduce(t, op):
            for i in dims:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
            return t

        local = logits._local_tensor
        vb = local.shape[-1]
        lo = 0
        for i in dims:
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        lab = labels.redistribute(mesh, tok_pl)._local_tensor.long() - lo * vb
        inside = (lab >= 0) & (lab < vb)
        lab = lab.clamp(0, vb - 1)
        lf = local.float()
        mx = reduce(lf.amax(dim=-1), "max")
        e = torch.exp(lf - mx[..., None])
        se = reduce(e.sum(dim=-1), "sum")
        gold = torch.gather(local, -1, lab[..., None])[..., 0].float()
        gold = reduce(torch.where(inside, gold, 0.0), "sum")
        ctx.save_for_backward(e, se, lab, inside)
        ctx.meta = (logits.dtype, mesh, pl, tok_pl, logits.shape,
                    logits.stride())
        B, S, _ = logits.shape
        return DTensor.from_local(mx + torch.log(se) - gold, mesh, tok_pl,
                                  run_check=False, shape=(B, S),
                                  stride=(S, 1))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        e, se, lab, inside = ctx.saved_tensors
        dtype, mesh, pl, tok_pl, shape, stride = ctx.meta
        gl = g.redistribute(mesh, tok_pl)._local_tensor \
            if isinstance(g, DTensor) else g
        d = e / se[..., None]
        d.scatter_add_(-1, lab[..., None],
                       -inside[..., None].to(d.dtype))
        d = (d * gl[..., None]).to(dtype)
        return DTensor.from_local(d, mesh, pl, run_check=False, shape=shape,
                                  stride=stride), None


def lm_loss(params: TransformerLM, tokens: Tensor, labels: Tensor,
            cfg: LMConfig, *, mesh=None, rules=None):
    """Softmax cross-entropy: logits in the activation dtype, their
    logsumexp and the gold logit in f32; ``xent + 0.01·aux`` and
    {"xent", "aux"}.  On a mesh the logits are vocab-sharded."""
    hidden, aux = forward(params, tokens, cfg, mesh=mesh, rules=rules)
    hidden = R.constrain(hidden, mesh, ("batch", None, "embed"), rules)
    unembed = R.gathered(params.unembed.to(hidden.dtype), mesh,
                         ("fsdp", "vocab"), rules)
    logits = torch.matmul(hidden, unembed)
    logits = R.constrain(logits, mesh, ("batch", None, "vocab"), rules)
    if R.mesh_size(mesh) == 1:
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1,
                            labels.long()[..., None])[..., 0].float()
        per = lse - gold
    else:
        per = _VocabParallelXent.apply(logits, labels)
    total = torch.sum(per)
    xent = total / labels.numel()
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


def logits_f32(params: TransformerLM, hidden: Tensor, mesh=None,
               rules=None) -> Tensor:
    """f32 logits of hidden states [..., d] (the serving head)."""
    unembed = R.gathered(params.unembed.float(), mesh, ("fsdp", "vocab"),
                         rules)
    return torch.matmul(hidden.float(), unembed)


@torch.no_grad()
def prefill(params: TransformerLM, tokens: Tensor, cfg: LMConfig,
            moe_stats: Optional[list] = None, *, mesh=None, rules=None):
    """Inference prefill: f32 next-token logits of the last position [B, V]
    and the KV cache."""
    hidden, _, cache = forward(params, tokens, cfg, collect_kv=True,
                               moe_stats=moe_stats, mesh=mesh, rules=rules)
    logits = logits_f32(params, hidden[:, -1], mesh, rules)
    return R.constrain(logits, mesh, ("batch", "vocab"), rules), cache


# ---------------------------------------------------------------------------
# Decode (serving) path
# ---------------------------------------------------------------------------

_CACHE_AXES = (None, "batch", "kv_heads", "kv_seq", None)


def _new_cache(x: Tensor, shape, dtype, mesh, rules) -> Tensor:
    """An empty cache leaf: on a mesh a DTensor placed by
    :func:`cache_logical_axes`, else a plain tensor on x's device."""
    if R.mesh_size(mesh) == 1:
        return torch.empty(shape, dtype=dtype, device=x.device)
    from torch.distributed.tensor import empty as dt_empty

    return dt_empty(shape, dtype=dtype, device_mesh=mesh,
                    placements=R.sharding_for(mesh, shape, _CACHE_AXES,
                                              rules))


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """KV cache, heads-major: {"k", "v"} of zeros [L, B, KV, S, hd] in
    ``dtype`` (None: the activation dtype) on ``device`` (None: the
    card)."""
    dtype = dtype or cfg.tdtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def abstract_cache(cfg: LMConfig, batch: int, max_seq: int,
                   dtype=None) -> dict:
    """:func:`init_cache`'s leaves on ``meta``: shapes and dtypes, no
    storage."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta")


def cache_logical_axes() -> dict:
    ax = L(*_CACHE_AXES)
    return {"k": ax, "v": ax}


def _write_slot(c: Tensor, new: Tensor, slot: int, mesh) -> None:
    """c[:, :, slot] = new [B, KV, hd].  On a mesh (the sequence axis may be
    sharded) as the reference's dynamic_update_slice: the layer's cache
    with the slot replaced, copied back in place."""
    if R.mesh_size(mesh) == 1:
        c[:, :, slot] = new
        return
    at = torch.arange(c.shape[2], device=c.device) == slot
    c.copy_(torch.where(at[None, None, :, None], new[:, :, None], c))


@torch.no_grad()
def decode_step(params: TransformerLM, cache: dict, tokens: Tensor, pos,
                cfg: LMConfig, moe_stats: Optional[list] = None, *,
                mesh=None, rules=None):
    """One decoding step: (f32 logits [B, V], the cache).

    tokens: [B, 1] current token; pos: its position, a host integer (the
    cache holds ``pos`` valid entries; the new K/V is written at index pos,
    in place).  As the reference's ``dynamic_update_slice``, a write at
    ``pos >= S`` lands on the last slot S - 1, while attention still reads
    ``kv_len = pos + 1`` entries (all S of them).
    """
    pos = int(pos)
    B = tokens.shape[0]
    dt = cfg.tdtype
    embed = R.gathered(params.embed, mesh, ("vocab", "fsdp"), rules)
    x = embedding(tokens.long(), embed).to(dt)                 # [B, 1, d]
    x = R.constrain(x, mesh, ("batch", None, "embed"), rules)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    rot = layers.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    slot = min(max(pos, 0), cache["k"].shape[3] - 1)
    cax = _CACHE_AXES[1:]
    for li, (lp, window) in enumerate(zip(params.layer_weights(),
                                          _windows(cfg))):
        q, knew, vnew = _qkv(lp, x, rot, cfg, mesh, rules)
        kc, vc = cache["k"][li], cache["v"][li]                # [B, KV, S, hd]
        _write_slot(kc, knew[:, 0].to(kc.dtype), slot, mesh)
        _write_slot(vc, vnew[:, 0].to(vc.dtype), slot, mesh)
        kc = R.constrain(kc, mesh, cax, rules)
        vc = R.constrain(vc, mesh, cax, rules)
        attn = layers.decode_attention(q, kc, vc, window=window,
                                       q_offset=pos, kv_len=pos + 1,
                                       mesh=mesh, rules=rules)
        x = x + R.constrain(_out_proj(lp, attn, mesh, rules), mesh,
                            ("batch", None, "embed"), rules)
        mlp, _ = _mlp_block(lp, x, cfg, moe_stats, mesh, rules)
        x = x + mlp
    x = layers.rms_norm(x, params.ln_f)
    logits = logits_f32(params, x[:, 0], mesh, rules)
    return R.constrain(logits, mesh, ("batch", "vocab"), rules), cache
