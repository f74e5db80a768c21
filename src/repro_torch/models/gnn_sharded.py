"""EquiformerV2 message passing on a mesh with explicit collectives, as
``repro.models.gnn_sharded``; the function computed is ``models/gnn.py``'s.

The one-device model holds every node's features on every device: at
``ogb_products`` (2,449,408 nodes × 49 coefficients × 128 channels, f32)
that is 61.5 GB.  This module is the reference's sharded schedule, written
as the code one rank runs, with its collectives on the ``DeviceMesh``
(``torch.distributed._functional_collectives``; an axis of one device
issues none):

* node tensors are replicated over the data axes (``("pod", "data")``
  where the mesh has ``pod``) and split by channel over ``model``: a
  layer's carry is this rank's node range × channel block [N/nd, K, C/nm],
  all-gathered over the data axes into [N, K, C/nm] at the layer's start;
* edges are split over the data axes, so gathers and scatters are local;
* the SO(2) product: each rank multiplies its channel block by its rows of
  the weights (the channel-major rows of ``gnn._flat_cmajor`` make them one
  contiguous block), then one all-reduce over ``model`` a chunk;
* pass 1 finds the per-destination maximum of the attention logits
  without gradients (only the l = 0 row of the SO(2) product feeds them),
  max-reduced over the data axes; pass 2 (:class:`_Aggregate`) sums the
  softmax numerator and denominator against it, and its backward walks
  the chunks again, as ``gnn._EdgeLoop``'s does; then one all-reduce of
  each over the data axes;
* the node update runs on the rank's node range: ``w_out`` (each rank's
  rows of it, reduce-scattered over ``model`` by channel), the layer
  norm's sums of squares and the gate product (partial, all-reduced over
  ``model``).  Each layer is recomputed in the backward under
  ``cfg.remat``.

Where the reference's schedule computes another function than
``models/gnn.py`` once ``n_heads`` > 1 (ROADMAP.md Queue 3 item 4), this
module keeps to ``models/gnn.py``: local channel j takes the head of its
global channel (c_lo + j) // (C/H), and ``w_out`` mixes the normalised
aggregate at the nodes, not each edge's message before its head's weight.

Gradients.  A value held alike by several ranks carries, on each, a part
of its cotangent (``shard_map``'s rule), so every collective's backward is
its transpose: an all-reduce's is the same all-reduce, an all-gather's a
reduce-scatter, a reduce-scatter's an all-gather.  The loss is held by
every rank, so its gradient enters as 1 / world on each.  A parameter's
gradient is summed over the axes it is replicated on, the transpose of
its broadcast: every axis, and for the SO(2) weights (split over
``model``) the data axes.  Parameters are DTensors placed by
:func:`param_shardings`, or plain tensors held whole by every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.nn.functional import silu
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed import rules as R
from repro_torch.models import gnn, sh
from repro_torch.models.gnn import NEG, GNNConfig, GraphBatch

Tensor = torch.Tensor
MODEL = "model"


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def data_axes(mesh) -> tuple:
    """The axes edges and node ranges split over, major to minor."""
    return tuple(a for a in R.axis_names(mesh) if a in ("pod", "data"))


def _live(mesh, axes: Sequence[str]) -> list:
    """The mesh dimensions of ``axes`` that hold more than one device."""
    names = R.axis_names(mesh)
    return [names.index(a) for a in axes
            if a in names and R.axis_size(mesh, a) > 1]


def _reduce(t: Tensor, op: str, mesh, axes) -> Tensor:
    from torch.distributed import _functional_collectives as funcol

    for d in _live(mesh, axes):
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op,
                                                 (mesh, d)))
    return t


def _gather(t: Tensor, mesh, axes, dim: int) -> Tensor:
    """Every rank's block along ``dim``, blocks ordered major to minor
    over ``axes`` (the minor axis gathered first)."""
    from torch.distributed import _functional_collectives as funcol

    for d in reversed(_live(mesh, axes)):
        t = funcol.wait_tensor(funcol.all_gather_tensor(t.contiguous(), dim,
                                                        (mesh, d)))
    return t


def _scatter(t: Tensor, mesh, axes, dim: int) -> Tensor:
    """The sum over ``axes``, this rank's block along ``dim`` (the
    transpose of :func:`_gather`)."""
    from torch.distributed import _functional_collectives as funcol

    for d in _live(mesh, axes):
        t = funcol.wait_tensor(funcol.reduce_scatter_tensor(
            t.contiguous(), "sum", dim, (mesh, d)))
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce(x, "sum", mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def psum(x: Tensor, mesh, axes) -> Tensor:
    """Sum over ``axes``; the gradient is summed alike."""
    return _AllReduce.apply(x, mesh, tuple(axes)) if _live(mesh, axes) else x


def all_gather(x: Tensor, mesh, axes, dim: int = 0) -> Tensor:
    return (_AllGather.apply(x, mesh, tuple(axes), dim)
            if _live(mesh, axes) else x)


def reduce_scatter(x: Tensor, mesh, axes, dim: int = 0) -> Tensor:
    return (_ReduceScatter.apply(x, mesh, tuple(axes), dim)
            if _live(mesh, axes) else x)


class _Replicated(torch.autograd.Function):
    """The identity on a value every one of ``n`` ranks holds whole (the
    loss): each takes 1 / n of its gradient."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _LocalBlock(torch.autograd.Function):
    """A parameter's block on this rank (a DTensor's local tensor, or a
    plain tensor whole); the gradient is summed over ``axes``, the axes
    the parameter is replicated on, and placed like the parameter."""

    @staticmethod
    def forward(ctx, p, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.spec = ((p.device_mesh, p.placements, p.shape, p.stride())
                    if hasattr(p, "_local_tensor") else None)
        local = getattr(p, "_local_tensor", p)
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, "sum", ctx.mesh, ctx.axes)
        if ctx.spec is not None:
            from torch.distributed.tensor import DTensor

            m, pl, shape, stride = ctx.spec
            g = DTensor.from_local(g, m, pl, run_check=False, shape=shape,
                                   stride=stride)
        return g, None, None


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def param_pspecs(cfg: GNNConfig) -> dict:
    """{leaf path: spec} of the reference's ``_param_pspecs``: the SO(2)
    weights' rows over ``model``, every other leaf replicated."""
    out = {"embed_in": ()}
    for path in gnn._layer_shapes(cfg):
        out[f"layers/{path}"] = ((None, MODEL) if path.startswith("so2/")
                                 else ())
    out.update({"ro1": (), "ro2": (), "force_w": ()})
    return out


def param_shardings(cfg: GNNConfig, mesh) -> dict:
    """{leaf path: DTensor placements} of :func:`param_pspecs` on
    ``mesh``."""
    names = R.axis_names(mesh)
    return {k: R.placements_for(mesh, s if MODEL in names else ())
            for k, s in param_pspecs(cfg).items()}


class _Geometry:
    """This rank's share: nodes [n_lo, n_lo + Nl) of N, channels
    [c_lo, c_lo + Cl) of C, edges [e_lo, e_lo + El) of E (node ranges and
    edge blocks major to minor over the ``nd`` ranks of the data axes)."""

    def __init__(self, mesh, cfg: GNNConfig, N: int, E: int):
        self.mesh = mesh
        self.dax = data_axes(mesh)
        names = R.axis_names(mesh)
        self.nd = meshlib.n_shards(mesh, self.dax)
        self.nm = R.axis_size(mesh, MODEL) if MODEL in names else 1
        self.world = R.mesh_size(mesh)
        d_idx = meshlib.linear_index(mesh, self.dax) if self.dax else 0
        m_idx = (mesh.get_coordinate()[names.index(MODEL)]
                 if MODEL in names else 0)
        C, H = cfg.c, cfg.n_heads
        for what, n, k in (("channels", C, self.nm), ("nodes", N, self.nd),
                           ("edges", E, self.nd), ("channels", C, H)):
            if n % k:
                raise ValueError(f"{n} {what} do not split over {k}")
        self.C, self.Cl = C, C // self.nm
        self.c_lo = m_idx * self.Cl
        self.Nl, self.n_lo = N // self.nd, d_idx * (N // self.nd)
        self.El, self.e_lo = E // self.nd, d_idx * (E // self.nd)
        self.m_idx = m_idx
        self.all_axes = names


def _edge_block(t: Tensor, geo: _Geometry) -> Tensor:
    """This rank's edges: a DTensor's local block (split over the data
    axes), or rows [e_lo, e_lo + El) of a whole tensor."""
    loc = getattr(t, "_local_tensor", t)
    if loc.shape[0] == geo.El:
        return loc
    return loc[geo.e_lo:geo.e_lo + geo.El]


def local_params(params, cfg: GNNConfig, geo: _Geometry) -> dict:
    """{leaf path: this rank's block of the leaf}, differentiable: the
    SO(2) weights' row block of this rank's channels (a DTensor placed by
    :func:`param_shardings` holds just that), every other leaf whole."""
    want = param_shardings(cfg, geo.mesh)
    names = geo.all_axes
    out = {}
    for k, p in params.leaves().items():
        if hasattr(p, "_local_tensor"):            # a DTensor
            if tuple(p.placements) != tuple(want[k]):
                p = p.redistribute(p.device_mesh, want[k])
            axes = tuple(a for a, pl in zip(names, p.placements)
                         if pl.is_replicate())
            t = _LocalBlock.apply(p, geo.mesh, axes)
        else:
            t = _LocalBlock.apply(p, geo.mesh, names) \
                if _live(geo.mesh, names) else p
        if k.startswith("layers/so2/") and t.shape[1] == p.shape[1]:
            rows = t.shape[1] // geo.nm          # a whole tensor: its block
            t = t[:, geo.m_idx * rows:(geo.m_idx + 1) * rows]
        out[k] = t
    return out


# ---------------------------------------------------------------------------
# The edge path
# ---------------------------------------------------------------------------

def so2_conv_sharded(fr: Tensor, so2: dict, cfg: GNNConfig, mesh) -> Tensor:
    """The SO(2) product of a chunk with channels split: fr [e, K, Cl]
    in the edge frame, ``so2`` this rank's row blocks; every output row's
    partial products in one [e, rows·C] tensor, one all-reduce over
    ``model``; returns the full [e, K, C] (orders |m| > m_max zero)."""
    e, K, _ = fr.shape
    lm, C = cfg.l_max, cfg.c
    rows = [gnn._m_rows(lm, 0, fr.device)]
    parts = [gnn._flat_cmajor(fr[:, rows[0], :]) @ so2["w0"].to(fr.dtype)]
    for m in range(1, cfg.m_max + 1):
        ip = gnn._m_rows(lm, m, fr.device)
        im = gnn._m_rows(lm, -m, fr.device)
        cm = gnn._flat_cmajor(fr[:, ip, :])
        sm = gnn._flat_cmajor(fr[:, im, :])
        wr = so2[f"w{m}r"].to(fr.dtype)
        wi = so2[f"w{m}i"].to(fr.dtype)
        parts += [cm @ wr - sm @ wi, cm @ wi + sm @ wr]
        rows += [ip, im]
    y = psum(torch.cat(parts, dim=1), mesh, (MODEL,))
    out = fr.new_zeros(e, K, C)
    for r, piece in zip(rows, y.split([len(r) * C for r in rows], dim=1)):
        out[:, r, :] = gnn._unflat_cmajor(piece, len(r))
    return out


def _edge_gate(vec: Tensor, lp: dict, cfg: GNNConfig) -> Tensor:
    r = torch.linalg.vector_norm(vec, dim=-1)
    return silu(gnn._rbf(r, cfg) @ lp["rad1"]) @ lp["rad2"]    # [e, l+1]


def _logits_only(fs: Tensor, vec: Tensor, valid: Tensor, lp: dict,
                 cfg: GNNConfig, mesh) -> Tensor:
    """Pass 1: a chunk's attention logits [e, H] (``NEG`` at pads).  They
    read only the l = 0 row of the SO(2) product: the m = 0 row of each
    degree's rotation and the l = 0 columns of ``w0``."""
    lm = cfg.l_max
    blocks = sh.wigner_blocks(lm, vec)
    fr0 = torch.stack([torch.matmul(D[:, l, None, :], fs[:, sh.l_slice(l), :])
                       [:, 0, :] for l, D in enumerate(blocks)], dim=1)
    w0 = lp["so2"]["w0"].to(fs.dtype)
    inv = psum(gnn._flat_cmajor(fr0) @ w0[:, ::lm + 1], mesh, (MODEL,))
    inv = inv * _edge_gate(vec, lp, cfg)[:, :1]
    logits = silu(inv @ lp["wa1"]) @ lp["wa2"]
    return torch.where(valid[:, None], logits, NEG)


def _chunk_terms(fs: Tensor, vec: Tensor, valid: Tensor, lp: dict,
                 cfg: GNNConfig, mesh, c_lo: int):
    """Pass 2: a chunk's logits [e, H] (``NEG`` at pads) and messages
    [e, K, Cl] of this rank's channels, in the global frame."""
    Cl = fs.shape[2]
    blocks = sh.wigner_blocks(cfg.l_max, vec)
    fr = sh.apply_blocks(blocks, fs)
    conv = so2_conv_sharded(fr, lp["so2"], cfg, mesh)          # [e, K, C]
    conv = conv * gnn._per_l_expand(_edge_gate(vec, lp, cfg),
                                    cfg.l_max)[..., None]
    logits = silu(conv[:, 0, :] @ lp["wa1"]) @ lp["wa2"]
    logits = torch.where(valid[:, None], logits, NEG)
    msg = sh.apply_blocks(blocks, conv[:, :, c_lo:c_lo + Cl], transpose=True)
    return logits, msg


class _Aggregate(torch.autograd.Function):
    """Pass 2 over this rank's edge chunks: the softmax numerator
    Σ_e exp(logit_e − M[dst_e]) · msg_e  [N, K, Cl] (each local channel
    weighted by its head's term) and denominator [N, H], against the
    global maximum M.  Backward: each chunk's logits and messages are
    recomputed from the saved input and differentiated with

        d msg_e = p_e · d_num[dst_e],
        d logit_e = p_e · (Σ_{channels of its head} d_num[dst_e]·msg_e
                           + d_Z[dst_e]),

    summing into one d_f and one gradient a weight (the reference's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, f_loc, plan, *weights):
        chunks, cfg, names, mesh, M, hl, c_lo = plan
        N, K, Cl = f_loc.shape
        lp = gnn._nest(names, weights)
        num = torch.zeros((N, K, Cl), dtype=torch.float32,
                          device=f_loc.device)
        Z = torch.zeros((N, cfg.n_heads), dtype=torch.float32,
                        device=f_loc.device)
        for valid, s_src, s_dst, vec in chunks:
            logits, msg = _chunk_terms(f_loc[s_src], vec, valid, lp, cfg,
                                       mesh, c_lo)
            p = torch.where(valid[:, None], torch.exp(logits - M[s_dst]),
                            0.0)
            Z.index_add_(0, s_dst, p)
            num.index_add_(0, s_dst, msg.mul_(p[:, hl][:, None, :]))
            del logits, msg, p
        ctx.save_for_backward(f_loc, *weights)
        ctx.plan = plan
        return num, Z

    @staticmethod
    def backward(ctx, d_num, d_Z):
        f_loc, *weights = ctx.saved_tensors
        chunks, cfg, names, mesh, M, hl, c_lo = ctx.plan
        ws = [w.detach().requires_grad_() for w in weights]
        lp = gnn._nest(names, ws)
        df = torch.zeros_like(f_loc)
        dws = [torch.zeros_like(w) for w in weights]
        for valid, s_src, s_dst, vec in chunks:
            with torch.enable_grad():
                fs = f_loc.detach()[s_src].requires_grad_()
                logits, msg = _chunk_terms(fs, vec, valid, lp, cfg, mesh,
                                           c_lo)
            p = torch.where(valid[:, None],
                            torch.exp(logits.detach() - M[s_dst]), 0.0)
            Gd = d_num[s_dst]                                   # [e, K, Cl]
            dp = d_Z[s_dst].index_add(1, hl, (Gd * msg.detach()).sum(dim=1))
            d_msg = Gd.mul_(p[:, hl][:, None, :])
            grads = torch.autograd.grad((logits, msg), (fs, *ws),
                                        (p * dp, d_msg))
            df.index_add_(0, s_src, grads[0])
            for dw, gw in zip(dws, grads[1:]):
                dw.add_(gw)
            del logits, msg, Gd, d_msg, grads
        return (df, None, *dws)


def _edge_chunks(g: GraphBatch, cfg: GNNConfig, geo: _Geometry) -> list:
    """This rank's edge chunks: (valid, source rows, destination rows,
    vectors) each; pads (src < 0) gather and scatter at node 0.  Every
    rank has as many chunks (the edges split evenly), so every rank
    issues the same collectives."""
    src, dst = _edge_block(g.edge_src, geo), _edge_block(g.edge_dst, geo)
    vec = _edge_block(g.edge_vec, geo)
    chunk = gnn._chunk_size(geo.El, cfg.edge_chunk)
    out = []
    for c0 in range(0, geo.El, chunk):
        s, d = src[c0:c0 + chunk], dst[c0:c0 + chunk]
        valid = s >= 0
        out.append((valid, torch.where(valid, s, 0).long(),
                    torch.where(valid, d, 0).long(), vec[c0:c0 + chunk]))
    return out


# ---------------------------------------------------------------------------
# Layers and the model
# ---------------------------------------------------------------------------

_EDGE_LEAVES = ("rad1", "rad2", "wa1", "wa2")


def mp_layer_local(lp: dict, f_slice: Tensor, chunks: list, cfg: GNNConfig,
                   geo: _Geometry) -> Tensor:
    """One message-passing layer on this rank: f_slice [N/nd, K, Cl] (its
    node range × channel block) to the layer's output, same layout."""
    mesh, Cl, C, lm = geo.mesh, geo.Cl, geo.C, cfg.l_max
    f_loc = all_gather(f_slice, mesh, geo.dax)                  # [N, K, Cl]
    N = f_loc.shape[0]
    hl = torch.div(torch.arange(geo.c_lo, geo.c_lo + Cl,
                                device=f_loc.device),
                   C // cfg.n_heads, rounding_mode="floor")
    # pass 1: the per-destination maximum; a softmax shift, whose gradient
    # is zero, so no gradient is kept
    with torch.no_grad():
        M = torch.full((N, cfg.n_heads), NEG, dtype=torch.float32,
                       device=f_loc.device)
        fd = f_loc.detach()
        for valid, s_src, s_dst, vec in chunks:
            M = gnn._new_max(M, _logits_only(fd[s_src], vec, valid, lp, cfg,
                                             mesh), s_dst)
        M = _reduce(M, "max", mesh, geo.dax)
    names = [f"so2/{k}" for k in lp["so2"]] + list(_EDGE_LEAVES)
    ws = [*lp["so2"].values(), *(lp[k] for k in _EDGE_LEAVES)]
    num, Z = _Aggregate.apply(
        f_loc, (chunks, cfg, names, mesh, M, hl, geo.c_lo), *ws)
    Z = psum(Z, mesh, geo.dax)
    num = psum(num, mesh, geo.dax)
    lo, Nl = geo.n_lo, geo.Nl
    out = (num[lo:lo + Nl]
           / torch.clamp_min(Z[lo:lo + Nl], 1e-30)[:, hl][:, None, :])
    out = out.to(f_slice.dtype)
    # per-degree output mixing at the nodes: this rank's rows of w_out,
    # summed over model and split back by channel
    cols = slice(geo.c_lo, geo.c_lo + Cl)
    mixed = torch.cat([blk @ lp["w_out"][l][cols].to(out.dtype)
                       for l, blk in enumerate(gnn._degrees(out, cfg))],
                      dim=1)                                    # [Nl, K, C]
    f = f_slice + reduce_scatter(mixed, mesh, (MODEL,), dim=2)
    # equivariant layer norm: per-degree RMS over (m, all C)
    normed = []
    for l, blk in enumerate(gnn._degrees(f, cfg)):
        ss = psum(torch.sum(blk.float() ** 2, dim=(1, 2)), mesh, (MODEL,))
        rms = torch.sqrt(ss / ((2 * l + 1) * C) + 1e-6)
        normed.append((blk / rms[:, None, None].to(blk.dtype))
                      * lp["ln"][l][cols].to(blk.dtype))
    # gated nonlinearity: the gate product over all C, partial + all-reduce
    g_full = psum(normed[0][:, 0, :] @ lp["gate"][cols], mesh, (MODEL,))
    gates = torch.sigmoid(g_full).reshape(Nl, lm, C)[:, :, cols]
    parts = [silu(normed[0])]
    parts += [normed[l] * gates[:, l - 1, None, :] for l in range(1, lm + 1)]
    return torch.cat(parts, dim=1)


def _layer(f, chunks, cfg, geo, names, *weights):
    return mp_layer_local(gnn._nest(names, weights), f, chunks, cfg, geo)


def _setup(params, g: GraphBatch, cfg: GNNConfig, mesh):
    if cfg.dtype != "float32":
        raise ValueError(f"dtype {cfg.dtype!r}: the softmax's accumulators "
                         "are float32, as the reference's")
    N = g.node_feat.shape[0]
    geo = _Geometry(mesh, cfg, N, g.edge_src.shape[0])
    return geo, local_params(params, cfg, geo)


def forward_sharded(params, g: GraphBatch, cfg: GNNConfig, mesh) -> Tensor:
    """This rank's block of the final node features: [N/nd, K, C/nm], its
    node range (major to minor over the data axes) × channel block.
    ``params`` an ``EquiformerV2`` whose leaves are DTensors placed by
    :func:`param_shardings` or whole tensors; ``g``'s node tensors whole
    (or replicated DTensors), its edges whole or split over the data axes.
    With ``cfg.remat`` and gradients on, each layer is recomputed in the
    backward."""
    return _forward(*_setup(params, g, cfg, mesh), g, cfg)


def _forward(geo: _Geometry, lp: dict, g: GraphBatch, cfg: GNNConfig):
    feat = getattr(g.node_feat, "_local_tensor", g.node_feat)
    feat = feat[geo.n_lo:geo.n_lo + geo.Nl].float()
    cols = slice(geo.c_lo, geo.c_lo + geo.Cl)
    emb = feat @ lp["embed_in"][:, cols]                          # [Nl, Cl]
    f = torch.cat([emb[:, None, :],
                   emb.new_zeros(geo.Nl, cfg.k - 1, geo.Cl)], dim=1)
    chunks = _edge_chunks(g, cfg, geo)
    names = [k.removeprefix("layers/") for k in lp if k.startswith("layers/")]
    per_layer = zip(*(lp[f"layers/{k}"].unbind(0) for k in names))
    remat = cfg.remat and torch.is_grad_enabled()
    for weights in per_layer:
        if remat:
            f = checkpoint(_layer, f, chunks, cfg, geo, names, *weights,
                           use_reentrant=False)
        else:
            f = _layer(f, chunks, cfg, geo, names, *weights)
    return f


def loss_fn_sharded(params, g: GraphBatch, cfg: GNNConfig, mesh):
    """(loss, metrics) of ``models/gnn.py``'s ``loss_fn`` from the sharded
    forward, the same value on every rank: the readout's products partial
    over ``model``, the per-node terms summed over the data axes."""
    geo, lp = _setup(params, g, cfg, mesh)
    f = _forward(geo, lp, g, cfg)
    dax, cols = geo.dax, slice(geo.c_lo, geo.c_lo + geo.Cl)
    rows = slice(geo.n_lo, geo.n_lo + geo.Nl)
    loc = lambda t: getattr(t, "_local_tensor", t)[rows]       # noqa: E731
    h = silu(psum(f[:, 0, :].float() @ lp["ro1"][cols], mesh, (MODEL,)))
    out = h @ lp["ro2"]                                         # [Nl, n_out]
    if cfg.task == "energy_force":
        gid = loc(g.graph_id).long()
        energy = psum(out.new_zeros(g.n_graphs).index_add(0, gid, out[:, 0]),
                      mesh, dax)
        forces = psum((f[:, 1:4, :].float() @ lp["force_w"][cols])[..., 0],
                      mesh, (MODEL,))                           # [Nl, 3]
        labels = getattr(g.labels, "_local_tensor", g.labels).float()
        le = torch.mean((energy - labels) ** 2)
        n = g.node_feat.shape[0] * 3
        lf = psum(torch.sum((forces - loc(g.forces)) ** 2), mesh, dax) / n
        loss = le + 10.0 * lf
        metrics = {"energy_mse": le, "force_mse": lf}
    else:
        labels = loc(g.labels)
        valid = labels >= 0
        lab = torch.where(valid, labels, 0).long()
        lse = torch.logsumexp(out, dim=-1)
        gold = torch.gather(out, -1, lab[:, None])[:, 0]
        total = psum(torch.sum(torch.where(valid, lse - gold, 0.0)), mesh,
                     dax)
        count = _reduce(valid.sum(), "sum", mesh, dax)
        loss = total / torch.clamp_min(count, 1)
        metrics = {"xent": loss}
    if geo.world > 1:
        loss = _Replicated.apply(loss, geo.world)
    return loss, metrics
