"""Kernel twins against the JAX Pallas kernels (run in interpret mode).

* Kernel A: the plain twin ``sinnamon_score_topk_plain`` + ``merge_tile_topk``
  against ``repro``'s ``sinnamon_score_topk(interpret=True)`` +
  ``merge_tile_topk`` at the shapes of
  tests/test_query_backends.py::test_fused_topk_kernel_matches_dense_oracle:
  slots equal, values rtol=1e-6.
* Kernel B: the plain twin ``csr_score_plain`` against ``repro``'s
  ``csr_score(interpret=True)``: rtol=1e-5.

The CUDA kernels themselves are held against these twins on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.kernels import csr_score as jcsr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sinnamon_score as jsinn  # noqa: E402
from repro_torch.kernels import csr_score as tcsr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sinnamon_score as tsinn  # noqa: E402

SHAPES = [(2, 5, 2, 8, 384, 128, 40), (3, 7, 1, 16, 512, 128, 200),
          (1, 4, 3, 8, 256, 256, 10), (5, 6, 2, 8, 640, 128, 300)]


def _operands(rng, B, L, h, m, C, nrows=12, density=None):
    qv = rng.normal(0, 1, (B, L)).astype(np.float32)
    qv[:, -1] = 0.0
    rows = rng.integers(0, m, (B, L, h)).astype(np.int32)
    if density is None:
        bits = rng.integers(0, 2**32, (nrows, C // 32), dtype=np.uint32)
    else:                  # each bit set with probability ``density``
        on = rng.random((nrows, C // 32, 32)) < density
        bits = np.packbits(on, axis=-1, bitorder="little").view("<u4")[..., 0]
    brows = rng.integers(-1, nrows, (B, L)).astype(np.int32)
    qbits = np.where((brows >= 0)[..., None], bits[np.maximum(brows, 0)], 0)
    u = rng.normal(0, 1, (m, C)).astype(np.float32)
    ll = (rng.normal(0, 1, (m, C)) - 1).astype(np.float32)
    ok = rng.random(C) < 0.8
    return qv, rows, bits, brows, qbits.astype(np.uint32), u, ll, ok


@pytest.mark.parametrize("B,L,h,m,C,tile,kprime", SHAPES)
@pytest.mark.parametrize("one_sided", [True, False])
def test_fused_twin_matches_pallas_kernel(rng, B, L, h, m, C, tile, kprime,
                                          one_sided):
    qv, rows, bits, brows, qbits, u, ll, ok = _operands(rng, B, L, h, m, C)
    gate = np.where(ok, 0.0, -np.inf).astype(np.float32)[None]
    pos = qv > 0
    if one_sided:
        skm = np.concatenate([u, ll], axis=0)
        prow = np.where(pos[..., None], rows, rows + m).astype(np.int32)
    else:
        skm, prow = u, rows
    kp = min(kprime, tile)
    jv, js = jsinn.sinnamon_score_topk(
        jnp.asarray(qv), jnp.asarray(pos), jnp.asarray(prow),
        jnp.asarray(qbits), jnp.asarray(gate), jnp.asarray(skm), kp=kp,
        tile_c=tile, one_sided=one_sided, interpret=True)
    jv, js = jsinn.merge_tile_topk(jv, js, kprime)
    tv, ts = tsinn.sinnamon_score_topk_plain(
        torch.from_numpy(qv), torch.from_numpy(prow), torch.from_numpy(brows),
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(ok),
        torch.from_numpy(skm), kp=kp, tile_c=tile, one_sided=one_sided)
    assert tv.shape == (B, -(-C // tile), kp)
    tv, ts = tsinn.merge_tile_topk(tv, ts, kprime)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    # and the dense oracles agree with each other
    rv, rs = jref.sinnamon_topk_ref(
        jnp.asarray(qv), jnp.asarray(rows), jnp.asarray(qbits),
        jnp.asarray(gate), jnp.asarray(u),
        jnp.asarray(ll) if one_sided else None, kprime)
    pv, ps = tref.sinnamon_topk_ref(
        torch.from_numpy(qv), torch.from_numpy(rows),
        torch.from_numpy(qbits.view(np.int32)), torch.from_numpy(gate),
        torch.from_numpy(u), torch.from_numpy(ll) if one_sided else None,
        kprime)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)


@pytest.mark.parametrize("B,L,h,m,C,tile,kprime,density,gated_tile", [
    (2, 5, 1, 8, 512, 128, 40, 1 / 64, None),
    (3, 7, 2, 8, 512, 128, 200, 1 / 64, 1),     # kp = tile, one tile gated
    (2, 6, 1, 8, 384, 128, 1, 1 / 2048, None),  # kp = 1
    (2, 9, 1, 16, 512, 256, 300, 1 / 256, 0),
])
@pytest.mark.parametrize("one_sided", [True, False])
def test_fused_twin_tie_order_matches_pallas_kernel(rng, B, L, h, m, C, tile,
                                                    kprime, density,
                                                    gated_tile, one_sided):
    """A sparse bitmap makes most slots score exactly +0.0 (and gated slots
    -inf), so each tile's kp-th key lies inside a tie: the twin keeps the
    Pallas kernel's (score desc, slot asc) order through the ties."""
    qv, rows, bits, brows, qbits, u, ll, ok = _operands(
        rng, B, L, h, m, C, density=density)
    if gated_tile is not None:
        ok[gated_tile * tile:(gated_tile + 1) * tile] = False
    gate = np.where(ok, 0.0, -np.inf).astype(np.float32)[None]
    pos = qv > 0
    if one_sided:
        skm = np.concatenate([u, ll], axis=0)
        prow = np.where(pos[..., None], rows, rows + m).astype(np.int32)
    else:
        skm, prow = u, rows
    kp = min(kprime, tile)
    jv, js = jsinn.sinnamon_score_topk(
        jnp.asarray(qv), jnp.asarray(pos), jnp.asarray(prow),
        jnp.asarray(qbits), jnp.asarray(gate), jnp.asarray(skm), kp=kp,
        tile_c=tile, one_sided=one_sided, interpret=True)
    tv, ts = tsinn.sinnamon_score_topk_plain(
        torch.from_numpy(qv), torch.from_numpy(prow), torch.from_numpy(brows),
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(ok),
        torch.from_numpy(skm), kp=kp, tile_c=tile, one_sided=one_sided)
    last = tv[..., -1]                  # each tile's kp-th value
    assert bool(((last == 0) | torch.isinf(last)).any()), \
        "the case must cut a tile inside a tie"
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jv, js = jsinn.merge_tile_topk(jv, js, kprime)
    tv, ts = tsinn.merge_tile_topk(tv, ts, kprime)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_topk_wrapper_sizes_shared_memory():
    """Kernel A's wrapper sizes the block as the kernel lays it out and
    raises, before any launch, for kp, L or h the kernel cannot take."""
    small = 4 * 16 * 8 + 2 * 256 * 4 + 16   # scan packs, histograms, ints
    stage = 2 * 16 * 256 * 4          # two chunks of staged words
    assert tsinn._topk_smem_fixed(1) == stage + small
    assert tsinn._topk_smem_fixed(800) == stage + small
    assert tsinn._topk_smem_fixed(tsinn.TILE_C) == tsinn.TILE_C * 8 + small

    def operands(L, h):
        return (torch.zeros((1, L)), torch.zeros((1, L, h), dtype=torch.int32),
                torch.zeros((1, L), dtype=torch.int32),
                torch.zeros((1, 1), dtype=torch.int32),
                torch.ones(32, dtype=torch.bool), torch.zeros((1, 32)))

    with pytest.raises(ValueError, match="shared memory"):
        tsinn._launch(*operands(20_000, 1), 800, True)
    with pytest.raises(ValueError, match="shared memory"):
        tsinn._launch(*operands(1_000, 60), 800, True)
    with pytest.raises(ValueError, match="TILE_C"):
        tsinn._launch(*operands(4, 1), tsinn.TILE_C + 1, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,P,n,tile", [(128, 8, 200, 64),
                                        (512, 17, 1000, 256)])
def test_csr_twin_matches_pallas_kernel(rng, dtype, C, P, n, tile):
    idx = rng.integers(-1, n, (C, P)).astype(np.int32)
    val = rng.normal(0, 1, (C, P)).astype(np.float32)
    qd = rng.normal(0, 1, (3, n)).astype(np.float32)
    jval = jnp.asarray(val).astype(dtype)
    tval = torch.from_numpy(val).to(getattr(torch, dtype))
    got = tcsr.csr_score(torch.from_numpy(qd), torch.from_numpy(idx), tval)
    slots = rng.integers(0, C, (3, 40)).astype(np.int32)
    got_rr = tcsr.csr_score(torch.from_numpy(qd), torch.from_numpy(idx), tval,
                            torch.from_numpy(slots))
    for b in range(3):
        want = np.asarray(jcsr.csr_score(jnp.asarray(qd[b]),
                                         jnp.asarray(idx), jval,
                                         tile_c=tile, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got_rr[b].numpy(), want[slots[b]],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tref.csr_score_ref(torch.from_numpy(qd[b]), torch.from_numpy(idx),
                               tval).numpy(),
            np.asarray(jref.csr_score_ref(jnp.asarray(qd[b]),
                                          jnp.asarray(idx), jval)),
            rtol=1e-5, atol=1e-5)


def test_order_key_roundtrip_and_order(rng):
    vals = np.concatenate([rng.normal(0, 100, 200),
                           [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40]])
    vals = torch.from_numpy(vals.astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, 2**31 - 1, vals.numel())
                             .astype(np.int32))
    key = tsinn.order_key(vals, slots)
    v2, s2 = tsinn.split_key(key)
    assert torch.equal(v2.view(torch.int32), vals.view(torch.int32))
    assert torch.equal(s2, slots)
    order = torch.argsort(key)
    sv, ss = vals[order], slots[order].long()
    desc = (sv[:-1] > sv[1:]) | ((sv[:-1] == sv[1:]) & (ss[:-1] <= ss[1:]))
    assert bool(desc.all())
    # topk_desc is lax.top_k's order: ties lower index first
    x = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, 0.5]])
    v, i = tsinn.topk_desc(x, 4)
    assert i.tolist() == [[1, 2, 4, 0]] and v.tolist() == [[3, 3, 3, 1]]


def test_prepared_operands_match_reference(rng):
    """Sorting, budgeting and the +m offset give the reference's operands;
    brows picks exactly the reference's pre-gathered words."""
    from repro.core import engine as jeng
    from repro.data import synth as jsynth
    from repro_torch.core import engine as teng

    ds = jsynth.SparseDatasetSpec("t", n=300, psi_doc=20, psi_query=10)
    idx, val = jsynth.make_corpus(0, ds, 60, pad=40)
    qi, qv = jsynth.make_queries(1, ds, 4, pad=20)
    qv[:, 2] = qv[:, 3]                       # an |q| tie: stability matters
    kw = dict(n=300, m=16, capacity=64, max_nnz=40, h=2, index_buckets=50)
    J = jeng.SinnamonIndex(jeng.EngineSpec(**kw))
    T = teng.SinnamonIndex(teng.EngineSpec(**kw), device="cpu")
    for index in (J, T):
        index.insert_many(list(range(60)), idx, val)
    for budget in (None, 4):
        jq, jp, jr, jb, _, _ = jops.prepare_fused_operands(
            J.state, jnp.asarray(qi), jnp.asarray(qv), budget, spec=J.spec)
        tq, tr, tb, sk, one_sided = tops.prepare_fused_operands(
            T.state, T.spec, torch.from_numpy(qi), torch.from_numpy(qv),
            budget)
        assert one_sided and sk.data_ptr() == T.state.sketch.data_ptr()
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        words = T.state.bits[tb.clamp_min(0).long()]
        words = torch.where((tb >= 0)[..., None], words, 0)
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      np.asarray(jb))


def test_cpu_dispatch_never_counts_launches():
    q = torch.zeros((1, 8))
    idx = torch.full((4, 3), -1, dtype=torch.int32)
    val = torch.zeros((4, 3))
    before = tcsr.csr_score.launches
    assert tcsr.csr_score(q, idx, val).shape == (1, 4)
    assert tcsr.csr_score.launches == before
    with pytest.raises(ValueError):
        tcsr.csr_score(q, idx, val, use_kernel=True)
    with pytest.raises(ValueError):
        tsinn.sinnamon_score_topk(
            torch.zeros((1, 2)), torch.zeros((1, 2, 1), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(32, dtype=torch.bool), torch.zeros((1, 32)), kp=4,
            use_kernel=True)


def test_pad_axis_and_backend_names():
    x = torch.arange(5.0)[None]
    p = tops.pad_axis(x, 1, 4, fill=-1.0)
    assert p.shape == (1, 8) and p[0, 5:].tolist() == [-1, -1, -1]
    assert tops.pad_axis(x, 0, 1) is x
    assert tops.resolve_backend(None) == "fused"
    assert tops.resolve_backend("pallas") == "fused"
    with pytest.raises(ValueError):
        tops.resolve_backend("tpu")


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure is an error, never a fallback to the twin."""
    import shutil

    from repro_torch.kernels import _build

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(_build.KernelBuildFailure, match="nvcc failed"):
        _build.build(["broken"])
    with pytest.raises(_build.KernelBuildFailure):
        _build.load("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_build_of_embed_bag_raises(tmp_path, monkeypatch):
    """Kernel D's wrapper raises when its build fails; the twin never runs."""
    import shutil

    from repro_torch.kernels import _build
    from repro_torch.kernels import embed_bag as tbag

    def twin(*args):
        raise AssertionError("the plain twin ran")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: shutil.which("false"))
    monkeypatch.setattr(tbag, "embed_bag_plain", twin)
    table = torch.zeros((10, 8))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(_build.KernelBuildFailure, match="nvcc failed for "
                       "embed_bag"):
        tbag._launch(table, idx, torch.ones((3, 2)))
    assert not list((tmp_path / "build").glob("*.so"))
