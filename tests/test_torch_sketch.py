"""Sketch, bitmap and vector-store parity: ``repro_torch`` against ``repro``.

Mappings, quantized cells (f32, bf16, f8 — the f8 subnormal band
[2⁻⁹, 2⁻⁶) included) and bitmap words must be bit-equal to the JAX
reference; the exact rerank primitive agrees to rtol=1e-6 (f32 sums taken
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import bitindex as jbits  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.storage import vecstore as jvs  # noqa: E402
from repro_torch.core import bitindex as tbits  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.storage import vecstore as tvs  # noqa: E402

_BITS = {"f32": np.uint32, "bf16": np.uint16, "f8": np.uint8}


def _jbits(x, cell):
    return np.asarray(x).view(_BITS[cell])


def _tbits(x, cell):
    return tsk.cell_bits(x.contiguous()).numpy().view(_BITS[cell])


@pytest.mark.parametrize("seed,n,m,h", [(0, 500, 16, 2), (7, 30_000, 64, 1),
                                        (3, 1000, 24, 3)])
def test_mappings_identical(seed, n, m, h):
    np.testing.assert_array_equal(jsk.make_mappings(seed, n, m, h),
                                  tsk.make_mappings(seed, n, m, h))


def _values(rng):
    band = rng.uniform(2.0 ** -9, 2.0 ** -6, 400)     # f8 subnormal band
    tiny = rng.uniform(0, 2.0 ** -9, 50)
    mixed = rng.normal(0, 1, 500) * 10.0 ** rng.integers(-4, 3, 500)
    edges = np.array([0.0, -0.0, 2.0 ** -9, 2.0 ** -6, 2.0 ** -10, 448.0,
                      449.0, 500.0, 1e30, 3.4e38, 1e-6, 0.1, 1.0, 1.5,
                      2.0 ** -6 - 1e-7])
    x = np.concatenate([band, tiny, mixed, edges])
    return np.concatenate([x, -x]).astype(np.float32)


@pytest.mark.parametrize("cell", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("up", [True, False])
def test_quantize_directed_bit_equal(rng, cell, up):
    x = _values(rng)
    want = jsk.quantize_directed(jnp.asarray(x), cell, up)
    got = tsk.quantize_directed(torch.from_numpy(x), cell, up)
    np.testing.assert_array_equal(_tbits(got, cell), _jbits(want, cell))
    # the direction holds (Theorem 5.1's guarantee inside the range)
    gf = got.to(torch.float32).numpy()
    inside = np.abs(x) <= (448.0 if cell == "f8" else 3.3e38)
    assert (gf[inside] >= x[inside]).all() if up \
        else (gf[inside] <= x[inside]).all()


def test_f8_subnormal_band_lands_on_the_subnormal_grid(rng):
    """Values in [2⁻⁹, 2⁻⁶) round to multiples of 2⁻⁹ (not to ±2⁻⁶)."""
    x = rng.uniform(2.0 ** -9, 2.0 ** -6, 300).astype(np.float32)
    up = tsk.quantize_directed(torch.from_numpy(x), "f8", True)
    dn = tsk.quantize_directed(torch.from_numpy(x), "f8", False)
    uf, df = up.to(torch.float32).numpy(), dn.to(torch.float32).numpy()
    step = 2.0 ** -9
    np.testing.assert_array_equal(uf, np.ceil(x / step) * step)
    np.testing.assert_array_equal(df, np.floor(x / step) * step)
    np.testing.assert_array_equal(
        _tbits(up, "f8"), _jbits(jsk.quantize_directed(jnp.asarray(x), "f8",
                                                       True), "f8"))


@pytest.mark.parametrize("cell", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("positive_only", [False, True])
def test_encode_cells_bit_equal(rng, cell, positive_only):
    n, m, h, B, P = 300, 16, 2, 24, 20
    maps = jsk.make_mappings(5, n, m, h)
    idx = rng.integers(0, n, (B, P)).astype(np.int32)
    idx[:, -4:] = -1
    val = (rng.normal(0, 1, (B, P))
           * 10.0 ** rng.integers(-3, 1, (B, P))).astype(np.float32)
    ju, jl = jsk.encode_batch(jnp.asarray(maps), m, jnp.asarray(idx),
                              jnp.asarray(val), dtype=cell,
                              positive_only=positive_only)
    tu, tl = tsk.encode_batch(torch.from_numpy(maps), m,
                              torch.from_numpy(idx), torch.from_numpy(val),
                              dtype=cell, positive_only=positive_only)
    np.testing.assert_array_equal(_tbits(tu, cell), _jbits(ju, cell))
    if positive_only:
        assert jl is None and tl is None
    else:
        np.testing.assert_array_equal(_tbits(tl, cell), _jbits(jl, cell))
    # single-vector form and decode agree too
    u1, l1 = tsk.encode(torch.from_numpy(maps), m, torch.from_numpy(idx[0]),
                        torch.from_numpy(val[0]), dtype=cell,
                        positive_only=positive_only)
    np.testing.assert_array_equal(_tbits(u1, cell), _jbits(ju[0], cell))
    jub, jlb = jsk.decode_coord(jnp.asarray(maps), ju.T,
                                None if jl is None else jl.T, 7)
    tub, tlb = tsk.decode_coord(torch.from_numpy(maps), tu.T.contiguous(),
                                None if tl is None else tl.T.contiguous(), 7)
    np.testing.assert_array_equal(tub.numpy(), np.asarray(jub))
    np.testing.assert_array_equal(tlb.numpy(), np.asarray(jlb))


def test_resolve_cell_dtype_aliases():
    for alias in ("f32", "bf16", "f8", "float8_e4m3fn", "bfloat16"):
        assert tsk.resolve_cell_dtype(alias) == jsk.resolve_cell_dtype(alias)
    assert tsk.torch_cell_dtype("f8") == torch.float8_e4m3fn
    with pytest.raises(ValueError):
        tsk.resolve_cell_dtype("f16")


def test_bitmap_words_bit_equal(rng):
    """Setting and clearing docs through word-mask adds gives the
    reference's uint32 words, bit 31 (the int32 sign bit) included."""
    n, C = 40, 96
    jb = jbits.empty(n, C)
    tb = tbits.empty(n, C, "cpu")
    docs = {}
    others = [s for s in rng.permutation(C) if s % 32 != 31][:67]
    for slot in [31, 63, 95] + others:      # 31 is cleared below, 63 kept
        idx = np.unique(rng.integers(0, n, 6)).astype(np.int32)
        docs[int(slot)] = idx
        jb = jbits.set_doc(jb, jnp.asarray(idx), int(slot), on=True)
        s = torch.full((len(idx),), int(slot))
        tb.index_put_((torch.from_numpy(idx).long(), s // 32),
                      tbits.word_mask(s), accumulate=True)
    for slot in list(docs)[::3]:
        idx = docs[slot]
        jb = jbits.set_doc(jb, jnp.asarray(idx), slot, on=False)
        s = torch.full((len(idx),), slot)
        tb.index_put_((torch.from_numpy(idx).long(), s // 32),
                      -tbits.word_mask(s), accumulate=True)
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))
    assert (tb.numpy() < 0).any()                    # bit 31 was exercised
    np.testing.assert_array_equal(tbits.unpack_row(tb).numpy(),
                                  np.asarray(jbits.unpack_row(jb)))


@pytest.mark.parametrize("vdt", ["float32", "bfloat16"])
def test_exact_scores_rows_match(rng, vdt):
    n, K, P = 200, 30, 12
    idx = rng.integers(-1, n, (K, P)).astype(np.int32)
    val = rng.normal(0, 1, (K, P)).astype(np.float32)
    qi = rng.integers(-1, n, 15).astype(np.int32)
    qi[3] = qi[5] = max(qi[5], 0)                     # a duplicate coordinate
    qv = rng.normal(0, 1, 15).astype(np.float32)
    jval = jnp.asarray(val).astype(vdt)
    tval = torch.from_numpy(val).to(getattr(torch, vdt))
    want = jvs.exact_scores_rows(jnp.asarray(idx), jval, jnp.asarray(qi),
                                 jnp.asarray(qv))
    got = tvs.exact_scores_rows(torch.from_numpy(idx), tval,
                                torch.from_numpy(qi), torch.from_numpy(qv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    jqs, jc = jvs.combine_query(jnp.asarray(qi), jnp.asarray(qv))
    tqs, tc = tvs.combine_query(torch.from_numpy(qi), torch.from_numpy(qv))
    np.testing.assert_array_equal(tqs.numpy(), np.asarray(jqs))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    jd = jvs.densify_query(n, jnp.asarray(qi), jnp.asarray(qv))
    td = tvs.densify_query(n, torch.from_numpy(qi), torch.from_numpy(qv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    store = tvs.VecStore(torch.from_numpy(idx), tval)
    jall = jvs.exact_scores_all(jvs.VecStore(jnp.asarray(idx), jval), jd)
    np.testing.assert_allclose(tvs.exact_scores_all(store, td).numpy(),
                               np.asarray(jall), rtol=1e-6, atol=1e-6)
