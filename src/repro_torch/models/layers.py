"""Shared transformer layers, as ``repro.models.layers``: RMSNorm, RoPE,
blockwise (flash-style) attention with GQA and sliding windows, decode
attention over a heads-major cache, the SwiGLU MLP and a GShard-style
top-k MoE layer with capacity dispatch.

Every function keeps the reference's float program: norms, RoPE and
attention compute in f32 and cast back to the activation dtype, matrix
products of activations run in the activation dtype with the weights cast
to it at each use.  Two places compute the same function another way:

* :func:`blockwise_attention` keeps the reference's running (max,
  denominator, accumulator) over KV chunks of the reference's sizes, but
  takes all query rows against one KV chunk at a time (the reference scans
  query chunks, then KV chunks) and skips the rows a chunk is wholly
  masked for; each row still sees the chunks in the reference's order with
  the reference's arithmetic.  Its backward is the flash-attention one,
  recomputing each chunk's scores from the saved (max, denominator).
* :func:`moe_layer` dispatches with index gathers in place of the dense
  ``[G, g, E, cap]`` one-hot einsums: the same slots, drops and gates.

On a mesh (``mesh`` / ``rules``: a ``DeviceMesh`` of more than one device,
the activations and weights DTensors) the functions pin the reference's
placements with ``rules.constrain`` at the reference's points, in the
port's layouts: placements follow the dimension, not its position.  With
``mesh`` None or of one device every constraint returns its input and the
functions compute exactly what they compute without one.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import rules as R

Tensor = torch.Tensor

NEG_BIG = -2.0 ** 30  # finite mask sentinel (NaN-safe running-max math)

#: Bytes of f32 scores one pass of :func:`blockwise_attention` holds; the
#: query rows of a KV chunk are taken in passes of at most this many.
SCORE_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# Norms & positional encoding
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope(x: Tensor, positions: Tensor, theta: float = 10_000.0) -> Tensor:
    """Rotary embedding in the split-halves layout.  x: [..., S, H, D]
    (D even), positions: [..., S]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def rope_tables(positions: Tensor, d: int, theta: float):
    """f32 (cos, sin) [..., S, 1, D/2] of :func:`rope`: the same for every
    head and layer at these positions, so a model computes them once."""
    ar = torch.arange(0, d // 2, dtype=torch.float32,
                      device=positions.device)
    freqs = torch.pow(theta, -ar / (d // 2))
    ang = positions[..., :, None].float() * freqs                # [..., S, D/2]
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def _int(v) -> Optional[int]:
    return None if v is None else int(v)


def _repeat_kv(x: Tensor, H: int) -> Tensor:
    """[B, S, KV, D] -> [B, S, H, D] by broadcasting each KV head G times
    (the reference's helper; the port's attention works on the grouped
    layout instead and never repeats the cache)."""
    B, S, KV, D = x.shape
    return x[:, :, :, None, :].expand(B, S, KV, H // KV, D).reshape(B, S, H, D)


def _mask(q_pos: Tensor, k_pos: Tensor, causal: bool, window, kv_len):
    """bool[Sq, Sk]: the keys each query position attends to; a window of
    None or <= 0 is unlimited."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    window = _int(window)
    if window is not None and window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        m &= (k_pos < int(kv_len))[None, :]
    return m


def _key_bounds(Sq: int, q_offset: int, causal: bool, window, kv_len):
    """int64[Sq] lo and hi: query row r keeps the keys lo[r] <= k < hi[r]
    (the reference's ``_mask``); both are non-decreasing in r."""
    big = np.iinfo(np.int64).max // 4
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    window = _int(window)
    lo = qp - window + 1 if window is not None and window > 0 \
        else np.full(Sq, -big)
    hi = qp + 1 if causal else np.full(Sq, big)
    if kv_len is not None:
        hi = np.minimum(hi, int(kv_len))
    return lo, hi


def _row_span(flags: np.ndarray):
    """[first, last + 1) of the True entries (contiguous by monotonicity),
    or None."""
    nz = np.flatnonzero(flags)
    return None if nz.size == 0 else (int(nz[0]), int(nz[-1]) + 1)


def _attention_blocks(lo, hi, Sk: int, chunk: int, rows_cap: int):
    """The (KV chunk, query rows) pairs the mask leaves anything in, in the
    reference's KV order: tuples (k0, k1, a, b, partial) for rows [a, b)
    against keys [k0, k1), ``partial`` the sub-ranges of [a, b) whose rows
    the mask cuts inside the chunk (the other rows keep all of it)."""
    for k0 in range(0, Sk, chunk):
        k1 = k0 + chunk
        rows = _row_span(np.maximum(lo, k0) < np.minimum(hi, k1))
        if rows is None:
            continue
        full = _row_span((lo <= k0) & (hi >= k1))
        cuts = [rows] if full is None else \
            [r for r in ((rows[0], full[0]), (full[1], rows[1]))
             if r[0] < r[1]]
        for a in range(rows[0], rows[1], rows_cap):
            b = min(a + rows_cap, rows[1])
            partial = [(max(a, p0), min(b, p1)) for p0, p1 in cuts
                       if max(a, p0) < min(b, p1)]
            yield k0, k1, a, b, partial


# ---------------------------------------------------------------------------
# Blockwise attention (flash-style: O(rows · chunk) score memory)
# ---------------------------------------------------------------------------

def _grouped(x: Tensor, KV: int) -> Tensor:
    """[B, S, H, D] -> f32 [B, KV, S, G, D], contiguous."""
    B, S, H, D = x.shape
    return x.reshape(B, S, KV, H // KV, D).permute(0, 2, 1, 3, 4).to(
        torch.float32, memory_format=torch.contiguous_format)


def _kv_major(x: Tensor) -> Tensor:
    """[B, S, KV, D] -> f32 [B, KV, S, D], contiguous."""
    return x.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def _cut_mask(lo_t: Tensor, hi_t: Tensor, p0: int, p1: int, k0: int,
              k1: int) -> Tensor:
    """bool[p1 - p0, 1, k1 - k0]: the keys rows [p0, p1) keep in the
    chunk, shaped to broadcast over [B, KV, rows, G, chunk]."""
    k = torch.arange(k0, k1, device=lo_t.device)
    return ((k[None, :] >= lo_t[p0:p1, None])
            & (k[None, :] < hi_t[p0:p1, None]))[:, None, :]


class _BlockwiseAttention(torch.autograd.Function):
    """Forward: the running (m, l, acc) over KV chunks, all query rows of a
    chunk at once.  Backward: flash attention's, chunk by chunk, from the
    saved (m, l) and the f32 output."""

    @staticmethod
    def forward(ctx, q, k, v, plan):
        blocks, lo, hi, scale = plan
        B, Sq, H, D = q.shape
        KV = k.shape[2]
        G = H // KV
        qs = _grouped(q, KV) * scale                     # [B, KV, Sq, G, D]
        kf, vf = _kv_major(k), _kv_major(v)              # [B, KV, Sk, D]
        lo_t = torch.from_numpy(lo).to(q.device)
        hi_t = torch.from_numpy(hi).to(q.device)
        m = torch.full((B, KV, Sq, G), NEG_BIG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, Sq, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, Sq, G, D), dtype=torch.float32,
                          device=q.device)
        for k0, k1, a, b, partial in blocks:
            R, c = b - a, k1 - k0
            s = torch.matmul(qs[:, :, a:b].reshape(B, KV, R * G, D),
                             kf[:, :, k0:k1].transpose(-1, -2))
            s = s.view(B, KV, R, G, c)
            cuts = [(p0 - a, p1 - a, _cut_mask(lo_t, hi_t, p0, p1, k0, k1))
                    for p0, p1 in partial]
            for r0, r1, keep in cuts:
                s[:, :, r0:r1].masked_fill_(~keep, NEG_BIG)
            m_old = m[:, :, a:b]
            m_new = torch.maximum(m_old, s.amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()
            for r0, r1, keep in cuts:
                p[:, :, r0:r1].masked_fill_(~keep, 0.0)
            alpha = torch.exp(m_old - m_new)
            l_blk = l[:, :, a:b]
            l_blk.mul_(alpha).add_(p.sum(dim=-1))
            pv = torch.matmul(p.view(B, KV, R * G, c), vf[:, :, k0:k1])
            acc[:, :, a:b].mul_(alpha[..., None]).add_(
                pv.view(B, KV, R, G, D))
            m_old.copy_(m_new)
            del s, p, pv
        # Rows a KV chunk is wholly masked for are left out of its pass.
        # The reference's step leaves them bit for bit as they were: there
        # s is NEG_BIG everywhere, so m_new = max(m, NEG_BIG) = m (m starts
        # at NEG_BIG), p = 0 by the mask's where, alpha = exp(m - m) = 1
        # (exp(0), also while m is still NEG_BIG), l·1 + 0 = l and
        # acc·1 + 0 = acc.
        out = acc.div_(torch.clamp_min(l, 1e-30)[..., None])
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.plan = plan
        return out.to(q.dtype).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, D)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, m, l = ctx.saved_tensors
        blocks, lo, hi, scale = ctx.plan
        B, Sq, H, D = q.shape
        KV = k.shape[2]
        G = H // KV
        qs = _grouped(q, KV) * scale
        kf, vf = _kv_major(k), _kv_major(v)
        do = _grouped(d_out, KV)                          # [B, KV, Sq, G, D]
        lo_t = torch.from_numpy(lo).to(q.device)
        hi_t = torch.from_numpy(hi).to(q.device)
        linv = 1.0 / torch.clamp_min(l, 1e-30)
        di = (do * out).sum(dim=-1)                       # [B, KV, Sq, G]
        dqs = torch.zeros_like(qs)
        dkf, dvf = torch.zeros_like(kf), torch.zeros_like(vf)
        for k0, k1, a, b, partial in blocks:
            R, c = b - a, k1 - k0
            q_blk = qs[:, :, a:b].reshape(B, KV, R * G, D)
            do_blk = do[:, :, a:b].reshape(B, KV, R * G, D)
            s = torch.matmul(q_blk, kf[:, :, k0:k1].transpose(-1, -2))
            s = s.view(B, KV, R, G, c)
            p = s.sub_(m[:, :, a:b, :, None]).exp_()
            for p0, p1 in partial:
                keep = _cut_mask(lo_t, hi_t, p0, p1, k0, k1)
                p[:, :, p0 - a:p1 - a].masked_fill_(~keep, 0.0)
            p.mul_(linv[:, :, a:b, :, None])
            p2 = p.view(B, KV, R * G, c)
            dvf[:, :, k0:k1] += torch.matmul(p2.transpose(-1, -2), do_blk)
            dp = torch.matmul(do_blk, vf[:, :, k0:k1].transpose(-1, -2))
            ds = p.mul_(dp.view(B, KV, R, G, c).sub_(
                di[:, :, a:b, :, None])).view(B, KV, R * G, c)
            dqs[:, :, a:b] += torch.matmul(ds, kf[:, :, k0:k1]).view(
                B, KV, R, G, D)
            dkf[:, :, k0:k1] += torch.matmul(ds.transpose(-1, -2), q_blk)
            del s, p, p2, dp, ds
        dq = dqs.mul_(scale).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, D)
        return (dq.to(q.dtype), dkf.transpose(1, 2).to(k.dtype),
                dvf.transpose(1, 2).to(v.dtype), None)


def blockwise_attention(
    q: Tensor,                 # [B, Sq, H, D]
    k: Tensor,                 # [B, Sk, KV, D]
    v: Tensor,                 # [B, Sk, KV, D]
    *,
    causal: bool = True,
    window=None,               # tokens of lookback (None/0 = unlimited)
    q_offset: int = 0,         # absolute position of q[0]
    kv_len=None,               # valid cache length (decode), else Sk
    chunk: int = 512,
    mesh=None, rules=None,
) -> Tensor:
    """Numerically-stable chunked attention with GQA; returns [B, Sq, H, D]
    in q's dtype.

    q is scaled in f32 and k, v cast to f32; every query row keeps a running
    (max, denominator, accumulator) over the KV chunks in order, masked
    scores are ``NEG_BIG`` and the output is ``acc / max(l, 1e-30)``.  The
    chunk is the largest divisor of Sk at most ``chunk``, the reference's.
    The reference's ``q_chunk`` only groups rows and changes no row's
    arithmetic; here the rows of a chunk are taken in passes of at most
    :data:`SCORE_BYTES` of scores.  ``window``, ``q_offset`` and ``kv_len``
    are host integers (a 0-d tensor is read once).

    On a mesh of more than one device the KV heads are repeated to the
    query heads (the reference's per-chunk ``_repeat_kv``; each score is
    the same product) so that q, k, v carry the reference's ("batch", None,
    "heads", None) placement, and each device runs the attention on its
    own block of batch rows and heads (attention mixes neither): its
    scores are its block of the reference's placement, and the score
    budget counts that block.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    while Sk % chunk != 0:   # the reference's static shapes
        chunk -= 1
    if R.mesh_size(mesh) > 1:
        heads = ("batch", None, "heads", None)
        q = R.constrain(q, mesh, heads, rules)
        k = R.constrain(_repeat_kv(k, H), mesh, heads, rules)
        v = R.constrain(_repeat_kv(v, H), mesh, heads, rules)
    lo, hi = _key_bounds(Sq, int(q_offset), causal, window, kv_len)
    Bl, _, Hl, _ = R.local_shape_of(q)
    rows_cap = max(1, SCORE_BYTES // (4 * Bl * Hl * chunk))
    blocks = list(_attention_blocks(lo, hi, Sk, chunk, rows_cap))
    plan = (blocks, lo, hi, 1.0 / math.sqrt(D))
    if R.mesh_size(mesh) == 1:
        return _BlockwiseAttention.apply(q, k, v, plan)
    from torch.distributed.tensor import DTensor

    out = _BlockwiseAttention.apply(q.to_local(), k.to_local(),
                                    v.to_local(), plan).contiguous()
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def decode_attention(
    q: Tensor,                 # [B, Sq, H, D]
    k: Tensor,                 # [B, KV, Sk, D]  (cache layout: heads major)
    v: Tensor,
    *,
    window=None,
    kv_len=None,               # valid cache entries (<= Sk)
    q_offset: int = 0,         # position of the query token
    mesh=None, rules=None,
) -> Tensor:
    """Attention of a few positions against a KV cache: a grouped softmax
    in f32 (the cache is never repeated).  Only the keys some row keeps are
    read and cast to f32: the reference's masked scores are ``NEG_BIG``,
    whose ``exp`` is exactly 0, so the keys left out add nothing."""
    B, Sq, H, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    if R.mesh_size(mesh) > 1:
        from torch.distributed.tensor import DTensor, Shard

        # the query heads split like the cache's KV heads (or stay whole)
        heads = "kv_heads" if R.spec_for(mesh, (KV,), ("kv_heads",),
                                         rules) else None
        q = R.constrain(q, mesh, ("batch", None, heads, None), rules)
        if Shard(2) not in k.placements:
            # every device holds whole key rows of its batch rows and
            # heads: the attention runs on its blocks (it mixes neither)
            out = decode_attention(q.to_local(), k.to_local(), v.to_local(),
                                   window=window, kv_len=kv_len,
                                   q_offset=q_offset)
            return DTensor.from_local(out.contiguous(), q.device_mesh,
                                      q.placements, run_check=False,
                                      shape=q.shape, stride=q.stride())
    lo, hi = _key_bounds(Sq, int(q_offset), True, window, kv_len)
    k_lo, k_hi = max(0, int(lo.min())), min(Sk, int(hi.max()))
    if k_lo >= k_hi:
        return torch.zeros_like(q)
    scale = 1.0 / math.sqrt(D)
    qg = (q.float() * scale).reshape(B, Sq, KV, G, D).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, KV, Sq * G, D)
    if (k_lo, k_hi) != (0, Sk):
        k, v = k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi]
    kf = k.float()                                        # [B, KV, n, D]
    sharded = R.mesh_size(mesh) > 1
    if sharded:     # the plain products: each DTensor op's placements
        s = torch.matmul(qg, kf.transpose(-1, -2))        # are then cheap
    else:           # keys as the rows: cuBLAS takes [n, D] x [D, Sq·G]
        s = torch.matmul(kf, qg.transpose(-1, -2)).transpose(-1, -2)
    s = s.reshape(B, KV, Sq, G, -1)
    del kf
    if (lo <= k_lo).all() and (hi >= k_hi).all():     # every row keeps all
        p = torch.softmax(s, dim=-1)
    else:
        q_pos = torch.arange(Sq, device=q.device) + int(q_offset)
        keep = _mask(q_pos, torch.arange(k_lo, k_hi, device=q.device), True,
                     window, kv_len)[None, None, :, None, :]
        s = torch.where(keep, s, NEG_BIG)
        p = torch.where(keep, torch.softmax(s, dim=-1), 0.0)
    mm = torch.matmul if sharded else _long_matmul
    out = mm(p.view(B, KV, Sq * G, -1), v.float())
    out = out.view(B, KV, Sq, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _long_matmul(p: Tensor, v: Tensor, piece: int = 1024) -> Tensor:
    """p [..., M, n] @ v [..., n, D] for a few rows M and a long n: the sum
    over n in pieces of ``piece``, each piece's product batched, then the
    pieces summed.  (cuBLAS runs the product whole as one GEMV whose long
    reduction keeps few blocks busy: ≈1.06 ms a layer at n = 32,768 on an
    H100, where reading v once takes 0.05 ms.)"""
    n = p.shape[-1]
    m = n // piece * piece
    out = None
    if m:
        pp = p[..., :m].unflatten(-1, (m // piece, piece)).transpose(-3, -2)
        vv = v[..., :m, :].unflatten(-2, (m // piece, piece))
        out = torch.matmul(pp, vv).sum(dim=-3)
    if m < n:
        rest = torch.matmul(p[..., m:], v[..., m:, :])
        out = rest if out is None else out + rest
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_mlp(x: Tensor, wi: Tensor, wg: Tensor, wo: Tensor,
               mesh=None, rules=None) -> Tensor:
    dt = x.dtype
    wi = R.gathered(wi.to(dt), mesh, ("fsdp", "mlp"), rules)
    wg = R.gathered(wg.to(dt), mesh, ("fsdp", "mlp"), rules)
    wo = R.gathered(wo.to(dt), mesh, ("mlp", "fsdp"), rules)
    g = F.silu(torch.matmul(x, wg))
    h = torch.matmul(x, wi) * g
    del g
    # dims marked None are replicated: the batch must be named
    h = R.constrain(h, mesh, ("batch",) + (None,) * (h.ndim - 2) + ("mlp",),
                    rules)
    out = torch.matmul(h, wo)
    # seq-full at the block edge (the layer-end constraint re-shards it)
    return R.constrain(out, mesh, ("batch",) + (None,) * (out.ndim - 1),
                       rules)


# ---------------------------------------------------------------------------
# GShard-style top-k MoE with capacity dispatch
# ---------------------------------------------------------------------------

def sorted_top_k(x: Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    to the lower index (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(g: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert and group: the reference's Python float
    expression."""
    cap = int(math.ceil(g * top_k / n_experts * capacity_factor / 4.0) * 4)
    return min(cap, g)


def moe_layer(
    x: Tensor,                 # [B, S, d]
    router: Tensor,            # [d, E]
    wi: Tensor, wg: Tensor,    # [E, d, f]
    wo: Tensor,                # [E, f, d]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 4096,
    stats: Optional[list] = None,
    mesh=None, rules=None,
):
    """Returns (y [B, S, d], aux_loss scalar).

    Tokens form G groups of g; each group routes its tokens to their top-k
    experts (f32 softmax, ties to the lower expert) with gates renormalised
    over the k.  Choice r of every token takes its slot after all tokens'
    choices < r, tokens in order; a choice past the expert's ``cap`` slots
    is dropped.  The kept tokens are gathered into [E, G·cap, d], the
    experts run as one batched SwiGLU, and each token sums its kept
    outputs weighted by its gates rounded to the activation dtype.  With
    ``stats`` (a list), appends {"received": int64[E] choices each expert
    kept, "dropped": int64[G] choices each group dropped}, as device
    tensors (no sync).
    """
    B, S, d = x.shape
    E = router.shape[-1]
    T = B * S
    g = min(group_size, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    G = T // g
    dt = x.dtype
    sharded = R.mesh_size(mesh) > 1
    # The reference places the tokens ("group", "act_seq", None); on a mesh
    # the port routes each device's own groups with their tokens whole, the
    # bookkeeping on the local blocks (groups route independently).
    xt = R.constrain(x.reshape(G, g, d), mesh, ("group", None, None), rules)

    router = R.gathered(router.float(), mesh, ("fsdp", None), rules)
    logits = torch.matmul(xt.float(), router)                 # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    xt_l, probs_l = (xt.to_local(), probs.to_local()) if sharded \
        else (xt, probs)
    Gl = xt_l.shape[0]
    cap = moe_capacity(g, top_k, E, capacity_factor)
    top_e, gates, keep, slot, slot_tok, count = _route(probs_l, top_k, cap)
    xpad = torch.cat([xt_l, xt_l.new_zeros((Gl, 1, d))], dim=1)  # [G, g+1, d]
    gidx = torch.arange(Gl, device=xt_l.device)[None, :, None]
    disp = xpad[gidx, slot_tok].view(E, Gl * cap, d)          # [E, G·cap, d]
    # the reference's ("group", "expert", None, None) [G, E, cap, d], laid
    # out expert-major with G·cap group-major (split as G splits)
    grp = "group" if sharded and R.spec_for(mesh, (G,), ("group",),
                                            rules) else None
    if sharded:
        disp = _from_local(disp, xt, 1, (E, G * cap, d))
    disp = R.constrain(disp, mesh, ("expert", grp, None), rules)

    wi = R.gathered(wi.to(dt), mesh, ("expert", "fsdp", "mlp"), rules)
    wg = R.gathered(wg.to(dt), mesh, ("expert", "fsdp", "mlp"), rules)
    wo = R.gathered(wo.to(dt), mesh, ("expert", "mlp", "fsdp"), rules)
    h = torch.bmm(disp, wi)
    u = torch.bmm(disp, wg)
    h = F.silu(u) * h
    del u
    eo = torch.bmm(h, wo)
    del h
    eo = R.constrain(eo, mesh, ("expert", grp, None), rules)
    if sharded:     # every expert's rows of this device's groups
        eo = R.constrain(eo, mesh, (None, grp, None), rules).to_local()
    eo = eo.view(E * Gl * cap, d)
    # each token's k expert outputs, weighted by its gates in the activation
    # dtype (0 for a dropped choice, which reads slot 0 of expert 0's block)
    rows = eo[torch.where(keep, slot, 0)]                     # [G, g, k, d]
    w = torch.where(keep, gates, 0.0).to(dt)
    y = torch.matmul(w[..., None, :], rows)[..., 0, :]

    # Switch-style load-balance auxiliary loss.
    first = F.one_hot(top_e[..., 0], E).float()
    if sharded:
        y = _from_local(y, xt, 0, (G, g, d))
        first = _from_local(first, xt, 0, (G, g, E))
    frac_tokens = first.mean(dim=(0, 1))
    mean_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * mean_probs)
    if stats is not None:
        kept = torch.clamp_max(count[:, 0], cap)              # [G, E]
        stats.append({"received": kept.sum(0),
                      "dropped": g * top_k - kept.sum(1)})
    return y.reshape(B, S, d), aux


def _route(probs: Tensor, top_k: int, cap: int):
    """The dispatch bookkeeping of [G, g, E] router probabilities:
    (top_e, gates, keep [G, g, k], slot [G, g, k] into the flat
    [E, G, cap] blocks, slot_tok [E, G, cap] (g: the zero row), count
    [G, 1, E])."""
    G, g, E = probs.shape
    dev = probs.device
    top_p, top_e = sorted_top_k(probs, top_k)           # [G, g, k]
    gates = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    count = torch.zeros((G, 1, E), dtype=torch.long, device=dev)
    pos = torch.empty((G, g, top_k), dtype=torch.long, device=dev)
    for r in range(top_k):
        oh = F.one_hot(top_e[..., r], E)                      # [G, g, E]
        pos[..., r] = ((torch.cumsum(oh, dim=1) - oh + count) * oh).sum(-1)
        count = count + oh.sum(dim=1, keepdim=True)
    keep = pos < cap                                          # [G, g, k]

    # slot -> token (g: the zero row) of each expert and group
    gi = torch.arange(G, device=dev)[:, None, None].expand_as(pos)
    ti = torch.arange(g, device=dev)[None, :, None].expand_as(pos)
    slot = (top_e * G + gi) * cap + pos                       # [E, G, cap] flat
    # a dropped choice writes the spare last entry: no host sync for a
    # boolean index
    slot_tok = torch.full((E * G * cap + 1,), g, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(0, torch.where(keep, slot, E * G * cap).flatten(),
                      ti.flatten())
    return top_e, gates, keep, slot, slot_tok[:-1].view(E, G, cap), count


def _from_local(t: Tensor, like, dim: int, shape) -> Tensor:
    """A DTensor of global ``shape`` from this device's block ``t``, whose
    dimension ``dim`` is split like ``like``'s dimension 0 (the groups)
    and which is replicated elsewhere (differentiable)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = tuple(Shard(dim) if p == Shard(0) else Replicate()
               for p in like.placements)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t, like.device_mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))
