"""The port's transformer layers (``repro_torch.models.layers``) against
``repro.models.layers``, from the same seeded numpy inputs, in f32 and
bf16.

Tolerances, as a fraction of the largest |value| of the reference's
output: f32 2e-6 (f32 sums and ``exp`` / ``rsqrt`` of another library, in
another order; the differences seen are ≈1e-7); bf16 outputs 2**-7 (the
f32 results differ at ≈1e-7 and may round to neighbouring bf16 values, one
bf16 step being 2**-8 of a value).  The MoE layer's bf16 output is a sum of
k expert outputs each rounded to bf16: 2**-6.  In bf16 the reference's
gradients of k and v are bf16 sums (over its query chunks and over the G
heads of a group, in their cotangents' dtype) where the port sums in f32
and rounds once: 2**-5.  Masks, routing (the experts each token keeps) and
drop counts are compared exactly.

Attention covers GQA, causal windows of 0 and > 0, non-causal, ``kv_len``
and ``q_offset``, chunk sizes that do not divide S, and passes of a few
rows (``SCORE_BYTES`` cut), which give one pass's result; its gradients are held to ``jax.grad`` at the same tolerances.  The MoE layer
covers top-1 and top-3, with and without capacity overflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs diff {err:.3g} > " \
        f"{tol:g} x {scale:.3g}"


def _pair(a, dtype):
    """numpy f32 ``a`` as (torch tensor, jax array), both cast to dtype."""
    tdt, jdt = DT[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


# -- norms, RoPE, masks ----------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DT))
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 9, 4, 16))).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    tx, jx = _pair(x, dtype)
    got = tl.rms_norm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    _close(got, jl.rms_norm(jx, scale), TOL[dtype], "rms_norm")
    pos = np.broadcast_to(np.arange(5, 14), (2, 9)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        got = tl.rope(tx, torch.from_numpy(np.ascontiguousarray(pos)), theta)
        assert got.dtype == tx.dtype
        _close(got, jl.rope(jx, pos, theta), TOL[dtype], f"rope {theta}")


@pytest.mark.parametrize("causal,window,kv_len",
                         [(True, None, None), (True, 0, None), (True, 5, None),
                          (True, 3, 11), (False, None, 7), (False, 4, None)])
def test_mask_and_repeat_kv(causal, window, kv_len):
    q_pos, k_pos = np.arange(6, 14), np.arange(16)
    want = jl._mask(q_pos, k_pos, causal,
                    None if window is None else jnp.asarray(window), kv_len)
    got = tl._mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal,
                   window, kv_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo, hi = tl._key_bounds(8, 6, causal, window, kv_len)
    ks = k_pos[None, :]
    np.testing.assert_array_equal((ks >= lo[:, None]) & (ks < hi[:, None]),
                                  np.asarray(want))
    x = np.random.default_rng(1).normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(tl._repeat_kv(torch.from_numpy(x), 6),
                                  np.asarray(jl._repeat_kv(x, 6)))


# -- blockwise attention ------------------------------------------------------------

ATTN = {   # (B, Sq, Sk, H, KV, D, causal, window, q_offset, kv_len, chunk)
    "gqa_causal": (2, 40, 40, 8, 2, 16, True, 0, 0, None, 16),
    "window": (2, 40, 40, 4, 2, 16, True, 7, 0, None, 16),
    "window_wide": (1, 48, 48, 4, 4, 8, True, 20, 0, None, 12),
    "kv_len_offset": (1, 12, 30, 4, 1, 8, True, None, 18, 25, 7),
    "window_offset_kv_len": (1, 5, 50, 4, 4, 8, True, 10, 45, 48, 9),
    "non_causal_odd_chunk": (2, 33, 33, 6, 3, 8, False, None, 0, None, 10),
    "chunk_past_s": (1, 24, 24, 4, 2, 8, True, 0, 0, None, 512),
}


def _attn_inputs(case, dtype, seed=0):
    B, Sq, Sk, H, KV, D = ATTN[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    return [_pair(a, dtype) for a in (q, k, v)]


def _attn_kwargs(case):
    causal, window, q_offset, kv_len, chunk = ATTN[case][6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len, chunk=chunk)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("case", list(ATTN))
def test_blockwise_attention_matches_reference(case, dtype):
    (tq, jq), (tk, jk), (tv, jv) = _attn_inputs(case, dtype)
    kw = _attn_kwargs(case)
    want = jl.blockwise_attention(jq, jk, jv, q_chunk=8, **kw)
    got = tl.blockwise_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype], case)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("case", ["gqa_causal", "window",
                                  "window_offset_kv_len",
                                  "non_causal_odd_chunk"])
def test_blockwise_attention_gradients_match_jax_grad(case, dtype):
    (tq, jq), (tk, jk), (tv, jv) = _attn_inputs(case, dtype, seed=1)
    kw = _attn_kwargs(case)
    rng = np.random.default_rng(2)
    ct = rng.normal(size=tq.shape).astype(np.float32)
    tct, jct = _pair(ct, dtype)

    def f(q, k, v):
        out = jl.blockwise_attention(q, k, v, q_chunk=8, **kw)
        return jnp.sum(out.astype(jnp.float32) * jct.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tl.blockwise_attention(*ins, **kw)
    (out.float() * tct.float()).sum().backward()
    for name, t, w in zip("qkv", ins, want):
        assert t.grad.dtype == t.dtype
        tol = TOL[dtype] if name == "q" or dtype == "float32" else 2.0 ** -5
        _close(t.grad, w, tol, f"{case} d{name}")


def test_row_passes_and_skips_match_one_pass(monkeypatch):
    """Query rows cut into passes of a few rows (``SCORE_BYTES``), with the
    wholly masked chunk-row pairs skipped, give one pass's result (each
    row's arithmetic is the same; the matrix products' blocking may
    differ with the rows they hold)."""
    (tq, _), (tk, _), (tv, _) = _attn_inputs("window_wide", "float32")
    kw = _attn_kwargs("window_wide")
    whole = tl.blockwise_attention(tq, tk, tv, **kw)
    B, _, H, _ = tq.shape
    monkeypatch.setattr(tl, "SCORE_BYTES", 4 * B * H * 12 * 5)   # 5 rows
    blocks = list(tl._attention_blocks(*tl._key_bounds(48, 0, True, 20, None),
                                       48, 12, 5))
    assert max(b - a for _, _, a, b, _ in blocks) == 5
    # the causal window leaves some chunk-row pairs wholly masked
    assert sum(b - a for _, _, a, b, _ in blocks) < 48 * 4
    cut = tl.blockwise_attention(tq, tk, tv, **kw)
    _close(cut, whole.numpy(), TOL["float32"], "passes of 5 rows")


# -- decode attention ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("window,pos", [(0, 20), (6, 20), (0, 39), (0, 50),
                                        (6, 50), (0, 0)])
def test_decode_attention_matches_reference(window, pos, dtype):
    B, H, KV, D, S = 2, 8, 2, 16, 40
    rng = np.random.default_rng(3)
    tq, jq = _pair(rng.normal(size=(B, 1, H, D)).astype(np.float32), dtype)
    tk, jk = _pair(rng.normal(size=(B, KV, S, D)).astype(np.float32), dtype)
    tv, jv = _pair(rng.normal(size=(B, KV, S, D)).astype(np.float32), dtype)
    want = jl.decode_attention(jq, jk, jv, window=window, kv_len=pos + 1,
                               q_offset=pos)
    got = tl.decode_attention(tq, tk, tv, window=window, kv_len=pos + 1,
                              q_offset=pos)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype], f"window {window} pos {pos}")


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_of_several_positions(window, dtype):
    """Three query positions at once: rows keep different key ranges, so
    the mask's where runs."""
    B, Sq, H, KV, D, S, q0 = 2, 3, 4, 2, 8, 20, 10
    rng = np.random.default_rng(9)
    tq, jq = _pair(rng.normal(size=(B, Sq, H, D)).astype(np.float32), dtype)
    tk, jk = _pair(rng.normal(size=(B, KV, S, D)).astype(np.float32), dtype)
    tv, jv = _pair(rng.normal(size=(B, KV, S, D)).astype(np.float32), dtype)
    want = jl.decode_attention(jq, jk, jv, window=window, kv_len=q0 + Sq,
                               q_offset=q0)
    got = tl.decode_attention(tq, tk, tv, window=window, kv_len=q0 + Sq,
                              q_offset=q0)
    _close(got, want, TOL[dtype], f"window {window}")


@pytest.mark.parametrize("window", [0, 700])
def test_decode_attention_over_a_long_cache(window):
    """A cache long enough that ``p @ v`` runs in pieces of 1,024 keys plus
    a remainder."""
    B, H, KV, D, S, pos = 1, 4, 2, 8, 2600, 2599
    rng = np.random.default_rng(8)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    want = jl.decode_attention(q, k, v, window=window, kv_len=pos + 1,
                               q_offset=pos)
    got = tl.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window, kv_len=pos + 1, q_offset=pos)
    _close(got, want, TOL["float32"], f"window {window}")


# -- MLP and MoE --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DT))
def test_swiglu_mlp_matches_reference(dtype):
    rng = np.random.default_rng(4)
    tx, jx = _pair(rng.normal(size=(2, 7, 24)).astype(np.float32), dtype)
    w = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for s in ((24, 40), (24, 40), (40, 24))]
    got = tl.swiglu_mlp(tx, *(torch.from_numpy(a) for a in w))
    assert got.dtype == tx.dtype
    _close(got, jl.swiglu_mlp(jx, *w), TOL[dtype], "swiglu")


def test_sorted_top_k_breaks_ties_like_lax_top_k():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, -1.0, 2.0, 2.0, 0.5]], np.float32)
    for k in (1, 2, 3, 5):
        tv, ti = tl.sorted_top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(x, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


MOE = {    # (B, S, d, E, f, top_k, capacity_factor, group_size)
    "top1": (2, 16, 8, 4, 6, 1, 4.0, 8),             # cap = g: no drop
    "top1_overflow": (2, 16, 8, 4, 6, 1, 0.5, 16),
    "top3": (2, 16, 8, 8, 6, 3, 4.0, 32),            # cap = g: no drop
    "top3_overflow": (1, 32, 8, 8, 6, 3, 0.5, 16),
}


def _moe_inputs(case, dtype, seed=5):
    B, S, d, E, f = MOE[case][:5]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[-2])
          for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]
    return _pair(x, dtype), ws


def _moe_kwargs(case):
    top_k, cf, gs = MOE[case][5:]
    return dict(top_k=top_k, capacity_factor=cf, group_size=gs)


def _kept(fn, x, router, wi, wg, wo, E):
    """bool[T, E]: whether each token's choice of expert e survives, read
    through the layer itself: with every other expert's output weights at
    0, a token's output is non-zero iff its choice of e was kept."""
    out = []
    for e in range(E):
        sel = (np.arange(E) == e).astype(np.float32)[:, None, None]
        y, _ = fn(x, router, wi, wg, wo * sel)
        y = y.float().numpy() if isinstance(y, torch.Tensor) else y
        out.append(np.abs(np.asarray(y, np.float32)).reshape(
            -1, y.shape[-1]).max(-1) > 0)
    return np.stack(out, -1)


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("case", list(MOE))
def test_moe_layer_matches_reference_and_drops_the_same_tokens(case, dtype):
    (tx, jx), ws = _moe_inputs(case, dtype)
    kw = _moe_kwargs(case)
    E = ws[0].shape[1]
    want, jaux = jl.moe_layer(jx, *ws, **kw)
    stats = []
    got, taux = tl.moe_layer(tx, *(torch.from_numpy(w) for w in ws),
                             stats=stats, **kw)
    assert got.dtype == tx.dtype
    tol = TOL["float32"] if dtype == "float32" else 2.0 ** -6
    _close(got, want, tol, f"{case} y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    def jfn(x, r, wi, wg, wo):
        return jl.moe_layer(x, r, wi, wg, wo, **kw)

    def tfn(x, r, wi, wg, wo):
        y, a = tl.moe_layer(x, *(torch.from_numpy(np.asarray(w))
                                 for w in (r, wi, wg, wo)), **kw)
        return y, a

    kept_j = _kept(jfn, jx, *ws, E)
    kept_t = _kept(tfn, tx, *ws, E)
    np.testing.assert_array_equal(kept_t, kept_j)
    T, k = tx.shape[0] * tx.shape[1], kw["top_k"]
    g = min(kw["group_size"], T)
    np.testing.assert_array_equal(stats[0]["received"].numpy(),
                                  kept_j.sum(0))
    dropped = g * k - kept_j.reshape(T // g, g, E).sum((1, 2))
    np.testing.assert_array_equal(stats[0]["dropped"].numpy(), dropped)
    assert (dropped.sum() > 0) == case.endswith("overflow")


@pytest.mark.parametrize("case", list(MOE))
def test_moe_layer_gradients_match_jax_grad(case):
    (tx, jx), ws = _moe_inputs(case, "float32", seed=6)
    kw = _moe_kwargs(case)
    rng = np.random.default_rng(7)
    ct = rng.normal(size=tx.shape).astype(np.float32)

    def f(x, r, wi, wg, wo):
        y, aux = jl.moe_layer(x, r, wi, wg, wo, **kw)
        return jnp.sum(y * ct) + 3.0 * aux

    want = jax.grad(f, argnums=tuple(range(5)))(jx, *ws)
    ins = [tx.clone().requires_grad_()] + \
        [torch.from_numpy(w).requires_grad_() for w in ws]
    y, aux = tl.moe_layer(*ins, **kw)
    ((y * torch.from_numpy(ct)).sum() + 3.0 * aux).backward()
    for name, t, w in zip(("x", "router", "wi", "wg", "wo"), ins, want):
        _close(t.grad, w, 1e-5, f"{case} d{name}")


def test_moe_capacity_is_the_reference_expression():
    for g, k, E, cf in ((4096, 6, 64, 1.25), (4096, 1, 16, 1.25),
                        (32, 3, 8, 1.25), (2, 6, 64, 1.25), (16, 1, 4, 0.5),
                        (1, 6, 64, 1.25)):
        cap = int(np.ceil(g * k / E * cf / 4.0) * 4)
        assert tl.moe_capacity(g, k, E, cf) == min(cap, g)
    assert tl.moe_capacity(4096, 6, 64, 1.25) == 480
