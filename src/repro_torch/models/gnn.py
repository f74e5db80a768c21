"""EquiformerV2 (arXiv:2306.12059) in PyTorch, as ``repro.models.gnn``:
equivariant graph attention through eSCN SO(2) convolutions.

* Message passing is **edge-chunked** with a **streaming segment softmax**:
  a running (max M, denominator Z, numerator acc) per destination node and
  head, updated chunk by chunk, so no per-edge feature of the whole graph
  exists at once.  The chunk is the largest divisor of E at most
  ``cfg.edge_chunk`` (the reference's static shapes).
* Per-edge Wigner matrices come from the closed-form z-y-z factorisation
  of :mod:`repro_torch.models.sh`.
* Gathers are index selects; the segment max is ``scatter_reduce``
  (``amax``) and the segment sums are ``index_add_``.

The edge loop is one ``torch.autograd.Function`` (:class:`_EdgeLoop`): it
saves the layer's input, the final (M, Z) and its output, and its backward
recomputes each chunk's rotated messages and softmax weights from them, so
training never holds more than one chunk's edge tensors.
:func:`edge_attention_reference` is the same loop with autograd through
every chunk, the reference's form, kept to check it.  With ``cfg.remat``
each layer is recomputed in its backward, and inside it each degree's
normalised, gated block is recomputed again, so a layer's backward holds
a few [N, K, C] tensors at a time.  The float program is the
reference's; the f32 sums run in another order.

Feature layout: [N, (l_max+1)², C] real spherical-harmonic coefficients,
degree-l block at rows l²..(l+1)², orders m = −l..l.  The parameters are
an :class:`EquiformerV2` holding the reference's stacked leaves ``[L, ...]``
under its names; ``leaves()`` keys them by the reference's paths.

The mesh tooling's shape work is the reference's: ``graph_logical_axes``,
``abstract_params`` (the model on ``meta``) and ``logical_axes``.  The
entry points take the reference's ``mesh`` / ``rules`` and constrain at its
points (identities on a one-device mesh).  On a mesh of more than one
device (DTensor parameters and batch, the reference's GSPMD-automatic
path) DTensor has no sharding strategy for the edge loop's scatter-amax
and ``index_add_``, so each device runs the loop on whole local tensors
and the node update runs on DTensors.  The schedule that splits the
nodes' channels and the edges over the mesh is
``models/gnn_sharded.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn.functional import silu
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.distributed import rules as R
from repro_torch.distributed.rules import L
from repro_torch.models import sh, tree_leaves

Tensor = torch.Tensor
NEG = -2.0 ** 30
#: elements of the edge loop backward's G·out product taken at once
_DELTA_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    c: int = 128                 # hidden channels (d_hidden)
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    cutoff: float = 5.0
    f_in: int = 100              # invariant input features
    n_out: int = 1               # classes (task=node_class) or 1 (energy)
    task: str = "node_class"     # node_class | energy_force
    edge_chunk: int = 8192
    dtype: str = "float32"
    remat: bool = True

    @property
    def k(self) -> int:
        return sh.num_coef(self.l_max)


class GraphBatch(NamedTuple):
    node_feat: Tensor    # f32[N, F]
    edge_src: Tensor     # int32[E]  (pad = -1)
    edge_dst: Tensor     # int32[E]  (pad = -1)
    edge_vec: Tensor     # f32[E, 3] relative position of src w.r.t. dst
    labels: Tensor       # int32[N] (node_class) / f32[G] energies
    forces: Tensor       # f32[N, 3] (energy_force) or zeros
    graph_id: Tensor     # int32[N]  molecule id for batched small graphs
    n_graphs: int = 1


def graph_logical_axes() -> GraphBatch:
    return GraphBatch(
        node_feat=L("nodes", None),      # "nodes" rule = replicated
        edge_src=L("edges"), edge_dst=L("edges"),
        edge_vec=L("edges", None),
        labels=L("nodes"), forces=L("nodes", None),
        graph_id=L("nodes"), n_graphs=None,
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _m_indices(l_max: int, m: int) -> np.ndarray:
    """Coefficient rows of order +m (or −m if m<0) for degrees l ≥ |m|."""
    return np.array([l * l + l + m for l in range(abs(m), l_max + 1)], np.int32)


def _layer_shapes(cfg: GNNConfig) -> dict:
    """{leaf path under ``layers/``: (per-layer shape, fan-in or None for
    ones)}."""
    C, lm = cfg.c, cfg.l_max
    n0 = lm + 1
    out = {"so2/w0": ((n0 * C, n0 * C), n0 * C)}
    for m in range(1, cfg.m_max + 1):
        nm = lm + 1 - m
        out[f"so2/w{m}r"] = ((nm * C, nm * C), nm * C)
        out[f"so2/w{m}i"] = ((nm * C, nm * C), nm * C)
    out.update({
        "rad1": ((cfg.n_rbf, C), cfg.n_rbf), "rad2": ((C, n0), C),
        "wa1": ((C, C), C), "wa2": ((C, cfg.n_heads), C),
        "w_out": ((n0, C, C), C), "gate": ((C, lm * C), C),
        "ln": ((n0, C), None)})
    return out


def _nest(names, tensors) -> dict:
    """{"so2/w0": t, "rad1": u} as {"so2": {"w0": t}, "rad1": u}."""
    out: dict = {}
    for name, t in zip(names, tensors):
        *parent, leaf = name.split("/")
        (out.setdefault(parent[0], {}) if parent else out)[leaf] = t
    return out


class EquiformerV2(nn.Module):
    """The model's parameters: ``embed_in`` [f_in, C], ``layers`` (each
    leaf stacked over the L layers: ``so2/{w0, w{m}r, w{m}i}``, ``rad1``,
    ``rad2``, ``wa1``, ``wa2``, ``w_out``, ``gate``, ``ln``), ``ro1`` [C,
    C], ``ro2`` [C, n_out] and ``force_w`` [C, 1], in ``dtype`` on
    ``device`` (None: the CUDA card).

    ``generator`` (a ``torch.Generator`` on ``device``; None: seed 0) draws
    them with the reference's law: N(0, 1) / √fan_in in f32, cast to
    ``dtype``; ``ln`` at 1.  ``draw=False`` leaves them uninitialised
    (``repro_torch.convert.gnn_params_from_numpy`` fills them).
    """

    def __init__(self, cfg: GNNConfig, generator=None, dtype=torch.float32,
                 device=None, *, draw: bool = True):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        C = cfg.c

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev))

        self.embed_in = param(cfg.f_in, C)
        self.layers = nn.Module()
        self.layers.so2 = nn.Module()
        for path, (shape, _) in _layer_shapes(cfg).items():
            *parent, leaf = path.split("/")
            holder = self.layers.so2 if parent else self.layers
            holder.register_parameter(leaf, param(cfg.n_layers, *shape))
        self.ro1 = param(C, C)
        self.ro2 = param(C, cfg.n_out)
        self.force_w = param(C, 1)
        if draw:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            with torch.no_grad():
                self._draw(generator)

    def _draw(self, gen: torch.Generator) -> None:
        def nrm(t: Tensor, fan_in: int) -> None:
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                    / math.sqrt(fan_in))

        cfg = self.cfg
        nrm(self.embed_in, cfg.f_in)
        leaves = self.leaves()
        for path, (_, fan_in) in _layer_shapes(cfg).items():
            t = leaves[f"layers/{path}"]
            if fan_in is None:
                t.fill_(1.0)
            else:
                nrm(t, fan_in)
        nrm(self.ro1, cfg.c)
        nrm(self.ro2, cfg.c)
        nrm(self.force_w, cfg.c)

    def leaves(self, grad: bool = False) -> dict:
        """{reference leaf path: tensor} in the reference's tree order
        (``.grad`` of each, zeros where it has none, when ``grad``)."""
        return tree_leaves(self, grad)

    def layer_weights(self) -> tuple:
        """(leaf paths under ``layers/``, per layer the tuple of their
        slices): views of the stacked leaves whose gradients stack back in
        one copy (``unbind``'s backward)."""
        named = {k.removeprefix("layers/"): t
                 for k, t in self.leaves().items()
                 if k.startswith("layers/")}
        names = list(named)
        return names, list(zip(*(named[k].unbind(0) for k in names)))


def abstract_params(cfg: GNNConfig, dtype=torch.float32) -> EquiformerV2:
    """The model on ``meta``: the reference's shapes and dtypes, nothing
    allocated."""
    return EquiformerV2(cfg, dtype=dtype, device="meta", draw=False)


def logical_axes(cfg: GNNConfig) -> dict:
    """The reference's logical axes of every leaf (nested dict of ``L``)."""
    so2 = {"w0": L(None, None, "mlp")}
    for m in range(1, cfg.m_max + 1):
        so2[f"w{m}r"] = L(None, None, "mlp")
        so2[f"w{m}i"] = L(None, None, "mlp")
    layers = {
        "so2": so2,
        "rad1": L(None, None, None), "rad2": L(None, None, None),
        "wa1": L(None, None, None), "wa2": L(None, None, None),
        "w_out": L(None, None, None, "mlp"),
        "gate": L(None, None, "mlp"),
        "ln": L(None, None, None),
    }
    return {"embed_in": L(None, None), "layers": layers,
            "ro1": L(None, None), "ro2": L(None, None),
            "force_w": L(None, None)}


def init_params(generator, cfg: GNNConfig, dtype=torch.float32,
                device=None) -> EquiformerV2:
    """The model drawn from ``generator`` (None: seed 0) in ``dtype``."""
    return EquiformerV2(cfg, generator, dtype, device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _m_rows(l_max: int, m: int, device: torch.device) -> Tensor:
    """``_m_indices(l_max, m)`` on ``device``, made once (a copy from the
    host at each call would wait for the device)."""
    return torch.from_numpy(_m_indices(l_max, m).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _coef_degree(l_max: int, device: torch.device) -> Tensor:
    """Each coefficient row's degree l, on ``device``, made once."""
    reps = [2 * l + 1 for l in range(l_max + 1)]
    return torch.from_numpy(np.repeat(np.arange(l_max + 1), reps)).to(device)


def _flat_cmajor(x: Tensor) -> Tensor:
    """[e, n_l, C] -> [e, C*n_l] with (channel-major, degree-minor) rows,
    the reference's layout of the SO(2) weights' rows."""
    e, nl, C = x.shape
    return x.transpose(1, 2).reshape(e, C * nl)


def _unflat_cmajor(x: Tensor, nl: int) -> Tensor:
    e = x.shape[0]
    return x.reshape(e, -1, nl).transpose(1, 2)          # [e, nl, C]


def so2_conv(fr: Tensor, lp_so2: dict, cfg: GNNConfig) -> Tensor:
    """eSCN SO(2) linear layer in the edge-aligned frame.  fr: [e, K, C]."""
    lm = cfg.l_max
    out = torch.zeros_like(fr)
    # m = 0
    i0 = _m_rows(lm, 0, fr.device)
    f0 = _flat_cmajor(fr[:, i0, :])
    out[:, i0, :] = _unflat_cmajor(f0 @ lp_so2["w0"].to(fr.dtype), lm + 1)
    # m = 1..m_max: rotation-equivariant 2×2 complex-style mixing
    for m in range(1, cfg.m_max + 1):
        ip = _m_rows(lm, m, fr.device)
        im = _m_rows(lm, -m, fr.device)
        cm = _flat_cmajor(fr[:, ip, :])
        sm = _flat_cmajor(fr[:, im, :])
        wr = lp_so2[f"w{m}r"].to(fr.dtype)
        wi = lp_so2[f"w{m}i"].to(fr.dtype)
        nm = lm + 1 - m
        out[:, ip, :] = _unflat_cmajor(cm @ wr - sm @ wi, nm)
        out[:, im, :] = _unflat_cmajor(cm @ wi + sm @ wr, nm)
    # orders |m| > m_max stay zero (eSCN truncation)
    return out


def _rbf(r: Tensor, cfg: GNNConfig) -> Tensor:
    mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=r.device)
    sig = cfg.cutoff / cfg.n_rbf
    return torch.exp(-((r[..., None] - mu) / sig) ** 2)


def _per_l_expand(per_l: Tensor, l_max: int) -> Tensor:
    """[..., l_max+1] per-degree values → [..., (l_max+1)²] per-coefficient."""
    return per_l[..., _coef_degree(l_max, per_l.device)]


def _edge_terms(fs: Tensor, vec: Tensor, valid: Tensor, lp: dict,
                cfg: GNNConfig):
    """(logits [e, H], ``NEG`` at pads; messages [e, K, H, C/H] in the
    global frame) of a chunk's edges from their sources' features fs [e,
    K, C] and their vectors vec [e, 3]."""
    e, K, C = fs.shape
    H = cfg.n_heads
    blocks = sh.wigner_blocks(cfg.l_max, vec)
    fr = sh.apply_blocks(blocks, fs)
    conv = so2_conv(fr, lp["so2"], cfg)                       # [e, K, C]
    r = torch.linalg.vector_norm(vec, dim=-1)
    gate = silu(_rbf(r, cfg) @ lp["rad1"]) @ lp["rad2"]       # [e, l+1]
    conv = conv * _per_l_expand(gate, cfg.l_max)[..., None]
    inv = conv[:, 0, :]                                       # [e, C] (l=0)
    logits = silu(inv @ lp["wa1"]) @ lp["wa2"]                # [e, H]
    logits = torch.where(valid[:, None], logits, NEG)
    msg = sh.apply_blocks(blocks, conv, transpose=True)       # back to global
    return logits, msg.reshape(e, K, H, C // H)


def _chunk_size(E: int, edge_chunk: int) -> int:
    chunk = min(edge_chunk, E)
    while E % chunk != 0:       # the reference's static shapes
        chunk -= 1
    return chunk


def _edge_chunks(g: GraphBatch, cfg: GNNConfig):
    """Per chunk: (valid, source rows, destination rows, vectors); pads
    (src < 0) gather and scatter at node 0."""
    E = g.edge_src.shape[0]
    chunk = _chunk_size(E, cfg.edge_chunk)
    for c0 in range(0, E, chunk):
        src = g.edge_src[c0:c0 + chunk]
        dst = g.edge_dst[c0:c0 + chunk]
        valid = src >= 0
        yield (valid, torch.where(valid, src, 0).long(),
               torch.where(valid, dst, 0).long(), g.edge_vec[c0:c0 + chunk])


def _softmax_state(f: Tensor, cfg: GNNConfig):
    """(M, Z, acc) before the first chunk."""
    N, K, C = f.shape
    H = cfg.n_heads
    M = torch.full((N, H), NEG, dtype=torch.float32, device=f.device)
    Z = torch.zeros((N, H), dtype=torch.float32, device=f.device)
    acc = torch.zeros((N, K, H, C // H), dtype=f.dtype, device=f.device)
    return M, Z, acc


def _new_max(M: Tensor, logits: Tensor, s_dst: Tensor) -> Tensor:
    """max(M, segment max of the chunk's logits); a node no edge of the
    chunk reaches keeps M (the reference's empty segment max is −inf)."""
    return M.scatter_reduce(0, s_dst[:, None].expand_as(logits), logits,
                            "amax", include_self=True)


class _EdgeLoop(torch.autograd.Function):
    """The streaming segment softmax over the edge chunks: the attention
    output [N, K, C] of one layer from its input f.

    Forward: the running (M, Z, acc) per destination node and head; acc
    and Z are rescaled and summed into in place (``mul_``, ``index_add_``),
    which the reference's ``Z·scale + segment_sum`` writes out of place: the
    same terms, summed in another order.  Backward: from the saved f, the
    final (M, Z) and the output, each chunk's logits and messages are
    recomputed and differentiated with its softmax weights
    a = exp(logit − M[dst]) / Z[dst]:

        d msg_e = a_e · G[dst_e],   d logit_e = a_e · (G[dst_e]·msg_e − δ[dst_e]),

    with G the output's gradient and δ[n] = G[n]·out[n] per head.
    """

    @staticmethod
    def forward(ctx, f, plan, *weights):
        g, cfg, names, mesh, rules = plan
        N, K, C = f.shape
        lp = _nest(names, weights)
        M, Z, acc = _softmax_state(f, cfg)
        for valid, s_src, s_dst, vec in _edge_chunks(g, cfg):
            fs = R.constrain(f[s_src], mesh, ("edges", None, "gnn_c"), rules)
            logits, msg = _edge_terms(fs, vec, valid, lp, cfg)
            M_new = _new_max(M, logits, s_dst)
            scale = torch.exp(torch.clamp_max(M - M_new, 0.0))
            p = torch.where(valid[:, None],
                            torch.exp(logits - M_new[s_dst]), 0.0)   # [e, H]
            Z.mul_(scale).index_add_(0, s_dst, p)
            acc.mul_(scale[:, None, :, None]).index_add_(
                0, s_dst, msg.mul_(p[:, None, :, None]))
            # node accumulators: node axis replicated, channels sharded
            acc = R.constrain(acc, mesh, (None, None, None, "gnn_c"), rules)
            M = M_new
            del logits, msg, p
        out = acc.div_(torch.clamp_min(Z, 1e-30)[:, None, :, None])
        out = out.view(N, K, C)
        ctx.save_for_backward(f, M, Z, out, *weights)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, d_out):
        f, M, Z, out, *weights = ctx.saved_tensors
        g, cfg, names, _, _ = ctx.plan
        N, K, C = f.shape
        H = cfg.n_heads
        G = d_out.reshape(N, K, H, C // H)
        z_inv = 1.0 / torch.clamp_min(Z, 1e-30)
        out = out.view(N, K, H, C // H)
        delta = torch.empty_like(Z)                               # [N, H]
        step = max(1, _DELTA_ELEMENTS // (K * C))
        for n0 in range(0, N, step):     # no [N, K, H, C/H] product at once
            delta[n0:n0 + step] = (G[n0:n0 + step]
                                   * out[n0:n0 + step]).sum(dim=(1, 3))
        ws = [w.detach().requires_grad_() for w in weights]
        lp = _nest(names, ws)
        df = torch.zeros_like(f)
        dws = [torch.zeros_like(w) for w in weights]
        for valid, s_src, s_dst, vec in _edge_chunks(g, cfg):
            with torch.enable_grad():
                fs = f.detach()[s_src].requires_grad_()
                logits, msg = _edge_terms(fs, vec, valid, lp, cfg)
            a = torch.where(valid[:, None],
                            torch.exp(logits.detach() - M[s_dst])
                            * z_inv[s_dst], 0.0)                    # [e, H]
            Gd = G[s_dst]                                         # [e, K, H, Ch]
            d_logits = a * ((Gd * msg.detach()).sum(dim=(1, 3))
                            - delta[s_dst])
            d_msg = Gd.mul_(a[:, None, :, None])
            grads = torch.autograd.grad((logits, msg), (fs, *ws),
                                        (d_logits, d_msg))
            df.index_add_(0, s_src, grads[0])
            for dw, gw in zip(dws, grads[1:]):
                dw.add_(gw)
            del logits, msg, Gd, d_msg, grads
        return (df, None, *dws)


def edge_attention(f: Tensor, lp: dict, g: GraphBatch,
                   cfg: GNNConfig, mesh=None, rules=None) -> Tensor:
    """The layer's attention output [N, K, C]: ``acc / max(Z, 1e-30)`` of
    the streaming segment softmax, through :class:`_EdgeLoop`."""
    names = [f"so2/{k}" for k in lp["so2"]] + ["rad1", "rad2", "wa1", "wa2"]
    ws = [*lp["so2"].values(), lp["rad1"], lp["rad2"], lp["wa1"], lp["wa2"]]
    if R.mesh_size(mesh) > 1 and _is_dtensor(f):
        return _edge_attention_replicated(f, ws, names, g, cfg, mesh, rules)
    return _EdgeLoop.apply(f, (g, cfg, names, mesh, rules), *ws)


def _is_dtensor(x) -> bool:
    return hasattr(x, "_local_tensor")


def _whole(x: Tensor, mesh) -> Tensor:
    """A DTensor made whole on every device (replicated), as its local
    tensor; its gradient, the same on every device, goes back to its
    placement.  A plain tensor as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local()


def _edge_attention_replicated(f, ws, names, g, cfg, mesh, rules):
    """:func:`edge_attention` of DTensors on a mesh of several devices:
    DTensor has no sharding strategy for the edge loop's scatter-amax and
    ``index_add_``, so each device runs the loop on whole local tensors
    (every device the same work, as GSPMD's replicated node tensors
    around the gather) and the output is placed back by ``rules``."""
    from torch.distributed.tensor import DTensor, Replicate

    gl = g._replace(**{k: _whole(getattr(g, k), mesh)
                       for k in ("edge_src", "edge_dst", "edge_vec")})
    out = _EdgeLoop.apply(_whole(f, mesh), (gl, cfg, names, None, None),
                          *(_whole(w, mesh) for w in ws))
    out = DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim,
                             run_check=False)
    return R.constrain(out, mesh, (None, None, "gnn_c"), rules)


def edge_attention_reference(f: Tensor, lp: dict, g: GraphBatch,
                             cfg: GNNConfig) -> Tensor:
    """:func:`edge_attention` in the reference's form, out of place, with
    autograd through every chunk (each chunk's edge tensors stay saved for
    the backward).  M carries no gradient: the softmax does not depend on
    it."""
    N, K, C = f.shape
    M, Z, acc = _softmax_state(f, cfg)
    for valid, s_src, s_dst, vec in _edge_chunks(g, cfg):
        logits, msg = _edge_terms(f[s_src], vec, valid, lp, cfg)
        M_new = _new_max(M, logits.detach(), s_dst)
        scale = torch.exp(torch.clamp_max(M - M_new, 0.0))
        p = torch.where(valid[:, None], torch.exp(logits - M_new[s_dst]),
                        0.0)
        Z = Z * scale + torch.zeros_like(Z).index_add(0, s_dst, p)
        acc = (acc * scale[:, None, :, None]
               + torch.zeros_like(acc).index_add(
                   0, s_dst, msg * p[:, None, :, None]))
        M = M_new
    return (acc / torch.clamp_min(Z, 1e-30)[:, None, :, None]).reshape(
        N, K, C)


def mp_layer(lp: dict, f: Tensor, g: GraphBatch, cfg: GNNConfig,
             mesh=None, rules=None) -> Tensor:
    """One message-passing block with streaming segment softmax."""
    N = f.shape[0]
    out = edge_attention(f, lp, g, cfg, mesh, rules)

    # per-degree output mixing + residual
    f = f + _per_l_linear(out, lp["w_out"], cfg)

    # equivariant layer norm (per-degree RMS) + gated nonlinearity
    blocks = _degrees(f, cfg)
    f0 = _rms_norm(blocks[0], lp["ln"][0])
    gates = torch.sigmoid(f0[:, 0, :] @ lp["gate"])          # [N, lm*C]
    gates = gates.reshape(N, cfg.l_max, cfg.c)
    parts = [silu(f0)]
    for l in range(1, cfg.l_max + 1):
        # degree l's rows times its gate, broadcast: the reference's
        # products, without its [N, K-1, C] copy of the gates.  With
        # gradients each degree is recomputed in the backward, so no
        # normalised copy of the whole [N, K, C] is kept for it.
        args = (blocks[l], lp["ln"][l], gates[:, l - 1, None, :])
        if torch.is_grad_enabled():
            parts.append(checkpoint(_gated_norm, *args, use_reentrant=False))
        else:
            parts.append(_gated_norm(*args))
    return R.constrain(torch.cat(parts, dim=1), mesh, (None, None, "gnn_c"),
                       rules)


def _rms_norm(blk: Tensor, scale: Tensor) -> Tensor:
    """One degree's block of the equivariant layer norm: blk over its RMS
    (over the block's rows and channels, per node), times ``scale``."""
    rms = torch.sqrt(torch.mean(blk.float() ** 2, dim=(1, 2), keepdim=True)
                     + 1e-6)
    return (blk / rms.to(blk.dtype)) * scale.to(blk.dtype)


def _gated_norm(blk: Tensor, scale: Tensor, gate: Tensor) -> Tensor:
    return _rms_norm(blk, scale) * gate


def _degrees(x: Tensor, cfg: GNNConfig) -> tuple:
    """x [N, K, C] as its per-degree blocks [N, 2l+1, C], views.  One split
    (not a slice a degree): its backward assembles the blocks' gradients
    into one [N, K, C] tensor, where each slice's would allocate its own."""
    return x.split([2 * l + 1 for l in range(cfg.l_max + 1)], dim=1)


def _per_l_linear(x: Tensor, w: Tensor, cfg: GNNConfig) -> Tensor:
    outs = [blk @ w[l].to(x.dtype) for l, blk in enumerate(_degrees(x, cfg))]
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _layer(f, g, cfg, mesh, rules, names, *weights):
    return mp_layer(_nest(names, weights), f, g, cfg, mesh, rules)


def forward(params: EquiformerV2, g: GraphBatch, cfg: GNNConfig, *,
            mesh=None, rules=None) -> Tensor:
    """Final node features [N, K, C].  With ``cfg.remat`` and gradients on,
    each layer is recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant)."""
    if cfg.dtype != "float32":
        raise ValueError(f"dtype {cfg.dtype!r}: the streaming softmax's "
                         f"accumulators are float32, as the reference's")
    N = g.node_feat.shape[0]
    f0 = g.node_feat.float() @ params.embed_in
    f = torch.cat([f0[:, None, :], f0.new_zeros(N, cfg.k - 1, cfg.c)],
                  dim=1)
    f = R.constrain(f, mesh, (None, None, "gnn_c"), rules)
    remat = cfg.remat and torch.is_grad_enabled()
    names, per_layer = params.layer_weights()
    for weights in per_layer:
        if remat:
            f = checkpoint(_layer, f, g, cfg, mesh, rules, names, *weights,
                           use_reentrant=False)
        else:
            f = _layer(f, g, cfg, mesh, rules, names, *weights)
    return f


def predict(params: EquiformerV2, g: GraphBatch, cfg: GNNConfig, *,
            mesh=None, rules=None):
    """Node logits [N, n_out] (node_class), or (energies [G], forces [N,
    3]) (energy_force)."""
    f = forward(params, g, cfg, mesh=mesh, rules=rules)
    # copies: a view kept for the backward would keep all of f alive
    inv = f[:, 0, :].clone()
    h = silu(inv @ params.ro1)
    out = h @ params.ro2                                        # [N, n_out]
    if cfg.task == "energy_force":
        energy = out.new_zeros(g.n_graphs).index_add(
            0, g.graph_id.long(), out[:, 0])
        forces = (f[:, 1:4, :].clone() @ params.force_w)[..., 0]  # [N, 3]
        return energy, forces
    return out                                                  # node logits


def loss_fn(params: EquiformerV2, g: GraphBatch, cfg: GNNConfig, *,
            mesh=None, rules=None):
    """(loss, metrics): energy MSE + 10 · force MSE with {"energy_mse",
    "force_mse"} (energy_force), or the mean cross-entropy over the
    labelled nodes (labels ≥ 0) with {"xent"} (node_class)."""
    if cfg.task == "energy_force":
        energy, forces = predict(params, g, cfg, mesh=mesh, rules=rules)
        le = torch.mean((energy - g.labels.float()) ** 2)
        lf = torch.mean((forces - g.forces) ** 2)
        return le + 10.0 * lf, {"energy_mse": le, "force_mse": lf}
    logits = predict(params, g, cfg, mesh=mesh, rules=rules)
    valid = g.labels >= 0
    labels = torch.where(valid, g.labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    xent = torch.sum(torch.where(valid, lse - gold, 0.0)) / torch.clamp_min(
        valid.sum(), 1)
    return xent, {"xent": xent}
