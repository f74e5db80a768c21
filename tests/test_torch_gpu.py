"""Kernel-against-twin checks on the card (marker ``gpu``).

Each CUDA kernel of ``repro_torch`` (A: ``sinnamon_score_topk``, B:
``csr_score``, C: ``sinnamon_score``, D: ``embed_bag``) is run at small shapes on CUDA
tensors and held against its plain-torch twin on the same tensors.  The tests skip
when no CUDA device is present; the decision is made inside a fixture, so
every worker collects the same tests.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import csr_score, embed_bag, ops  # noqa: E402
from repro_torch.kernels import sinnamon_score  # noqa: E402

pytestmark = pytest.mark.gpu

CELLS = {"f32": torch.float32, "bf16": torch.bfloat16,
         "f8": torch.float8_e4m3fn}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cells(rng, shape, dtype, shift=0.0):
    if dtype == torch.float8_e4m3fn:
        codes = rng.integers(0, 0x7F, shape).astype(np.uint8)   # no NaN
        codes |= (rng.random(shape) < 0.3).astype(np.uint8) << 7
        return torch.from_numpy(codes).view(torch.float8_e4m3fn)
    x = torch.from_numpy((rng.normal(0, 1, shape) + shift).astype(np.float32))
    return x.to(dtype)


def _sparse_bits(rng, nrows, C, density):
    """int32 bitmap words with each bit set with probability ``density``
    (bit i of word w is slot 32 w + i)."""
    on = rng.random((nrows, C // 32, 32)) < density
    return np.packbits(on, axis=-1, bitorder="little").view("<u4")[..., 0]


def _fused_operands(rng, B, L, h, m, C, nrows, dtype, one_sided,
                    density=0.5, gated_tile=None):
    qv = rng.normal(0, 1, (B, L)).astype(np.float32)
    if L:
        qv[:, -1] = 0.0
    R = 2 * m if one_sided else m
    rows = rng.integers(0, m, (B, L, h)).astype(np.int32)
    if one_sided:
        rows = np.where((qv > 0)[..., None], rows, rows + m).astype(np.int32)
    brows = rng.integers(-1, nrows, (B, L)).astype(np.int32)
    if density == 0.5:
        bits = rng.integers(-2**31, 2**31, (nrows, C // 32), dtype=np.int64)
    else:
        bits = _sparse_bits(rng, nrows, C, density)
    ok = rng.random(C) < 0.8
    if gated_tile is not None:         # every slot of this tile gated
        tile = sinnamon_score.TILE_C
        ok[gated_tile * tile:(gated_tile + 1) * tile] = False
    return (torch.from_numpy(qv), torch.from_numpy(rows),
            torch.from_numpy(brows),
            torch.from_numpy(bits.astype(np.int32)), torch.from_numpy(ok),
            _cells(rng, (R, C), dtype))


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("B,L,h,m,C,kprime,one_sided,density,gated_tile", [
    (2, 5, 2, 8, 384, 40, True, 0.5, None),
    (3, 7, 1, 16, 19_968, 900, True, 0.5, None),
    (2, 9, 3, 8, 16_384, 16_384, True, 0.5, None),
    (4, 6, 2, 8, 8_224, 300, False, 0.5, None),
    # 1 bit in 64: most slots score exactly +0.0, so the kp-th key of a
    # tile lies inside that tie and the tie scan decides the survivors
    (3, 20, 1, 16, 16_384, 800, True, 1 / 64, None),
    (2, 8, 1, 8, 24_576, 800, True, 1 / 64, 1),       # a tile all gated
    (2, 6, 1, 8, 16_384, 1, True, 1 / 64, None),      # kp = 1
    (2, 6, 2, 8, 17_408, 1_500, True, 1 / 64, None),  # partial tile < kp
    (2, 4, 1, 8, 16_384, 16_384, True, 1 / 64, None),  # kp = TILE_C
    (2, 0, 1, 8, 8_192, 800, True, 0.5, None),        # L = 0: all ties
    (2, 150, 1, 8, 16_384, 800, True, 1 / 16, None),  # L across chunks
    (2, 150, 2, 8, 9_216, 800, False, 1 / 64, None),
])
def test_sinnamon_kernel_bit_equal_to_twin(cuda, cell, B, L, h, m, C, kprime,
                                           one_sided, density, gated_tile):
    rng = np.random.default_rng(B * 1000 + C)
    ops = [t.to(cuda) for t in _fused_operands(rng, B, L, h, m, C, 40,
                                               CELLS[cell], one_sided,
                                               density, gated_tile)]
    kp = min(kprime, sinnamon_score.TILE_C)
    before = sinnamon_score.sinnamon_score_topk.launches
    kv, ks = sinnamon_score.sinnamon_score_topk(*ops, kp=kp,
                                                one_sided=one_sided)
    assert sinnamon_score.sinnamon_score_topk.launches == before + 1
    tv, ts = sinnamon_score.sinnamon_score_topk_plain(*ops, kp=kp,
                                                      one_sided=one_sided)
    torch.cuda.synchronize()
    torch.testing.assert_close(ks, ts, rtol=0, atol=0)
    torch.testing.assert_close(kv, tv, rtol=0, atol=0, equal_nan=False)
    gv, gs = sinnamon_score.merge_tile_topk(kv, ks, kprime)
    pv, ps = sinnamon_score.merge_tile_topk(tv, ts, kprime)
    assert torch.equal(gs, ps) and torch.equal(gv, pv)
    assert int(gs.max()) < C


@pytest.mark.parametrize("cell,B,L,h,m,C,one_sided,density", [
    ("f32", 2, 5, 2, 8, 384, True, 0.5),
    ("bf16", 3, 7, 1, 16, 19_968, True, 0.5),      # C not a multiple of 2048
    ("f8", 2, 9, 3, 8, 16_384, True, 0.5),
    ("bf16", 4, 6, 2, 8, 8_224, False, 0.5),       # no lower sketch
    ("f8", 1, 64, 1, 64, 4_128, False, 0.5),
    ("f32", 5, 3, 3, 16, 2_080, True, 0.5),
    ("bf16", 0, 4, 1, 8, 256, True, 0.5),          # empty batch
    # R at the tuner's limit: m=96 one-sided f32 (R=192, 64-slot tiles)
    ("f32", 3, 20, 1, 96, 4_096, True, 0.5),
    # C not a multiple of the tile (256 slots at m=64, bf16 and f8)
    ("bf16", 2, 12, 1, 64, 1_056, True, 0.5),
    ("f8", 3, 12, 2, 64, 2_080, True, 0.5),
    ("bf16", 64, 64, 1, 64, 8_192, True, 0.5),     # B=64: 8 queries a warp
    ("bf16", 13, 40, 2, 16, 2_560, True, 1 / 64),  # sparse, B not 8k
    ("f8", 3, 70, 1, 32, 4_096, True, 1 / 64),     # L across 3 chunks
    ("f32", 4, 33, 3, 16, 3_200, True, 0.5),       # h=3, signed queries
    ("bf16", 3, 33, 3, 16, 3_200, False, 1 / 64),  # h=3, no lower sketch
    ("f32", 2, 10, 1, 500, 640, True, 0.5),        # one block per SM
])
def test_dense_kernel_bit_equal_to_twin(cuda, cell, B, L, h, m, C,
                                        one_sided, density):
    """Kernel C == its plain twin bit for bit (brows = -1 and q = 0
    coordinates included in every case)."""
    rng = np.random.default_rng(B * 7 + C)
    qv, rows, brows, bits, _, sk = [
        t.to(cuda) for t in _fused_operands(rng, B, L, h, m, C, 40,
                                            CELLS[cell], one_sided,
                                            density)]
    before = sinnamon_score.sinnamon_score.launches
    got = sinnamon_score.sinnamon_score(qv, rows, brows, bits, sk,
                                        one_sided=one_sided)
    assert sinnamon_score.sinnamon_score.launches == before + (B > 0)
    want = sinnamon_score.sinnamon_score_plain(qv, rows, brows, bits, sk,
                                               one_sided=one_sided)
    torch.cuda.synchronize()
    assert got.shape == (B, C)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("budget", [None, 5])
def test_dense_path_on_card_matches_reference_backend(cuda, budget):
    """The ``score_fn`` path on the card: candidates bit-equal to the
    on-card ``reference`` backend, ids equal to the CPU index's."""
    from repro_torch.kernels import ops

    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12)
    idx, val = synth.make_corpus(0, ds, 300, pad=48)
    qi, qv = synth.make_queries(1, ds, 8, pad=24)
    spec = teng.EngineSpec(n=500, m=16, h=2, capacity=320, max_nnz=48,
                           value_dtype="float32", seed=3)
    fn = ops.make_engine_score_fn()
    ids = {}
    for dev in ("cpu", "cuda"):
        index = teng.SinnamonIndex(spec, device=dev)
        index.insert_many(list(range(280)), idx[:280], val[:280])
        index.delete_many(list(range(0, 280, 5)))
        index.insert_many(list(range(280, 300)), idx[280:], val[280:])
        ids[dev], _ = index.search_many(qi, qv, k=10, kprime=60,
                                        budget=budget, score_fn=fn)
    np.testing.assert_array_equal(ids["cuda"], ids["cpu"])
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=cuda)  # noqa: E731
    q = (t(qi, torch.int32), t(qv, torch.float32))
    before = sinnamon_score.sinnamon_score.launches
    cv, cs = teng.topk_candidates(index.state, spec, *q, 60, budget,
                                  score_fn=fn)
    assert sinnamon_score.sinnamon_score.launches == before + 1
    rv, rs = teng.topk_candidates(index.state, spec, *q, 60, budget,
                                  backend="reference")
    assert torch.equal(cs, rs)
    assert torch.equal(cv.view(torch.int32), rv.view(torch.int32))


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,C,P,n", [(3, 40, 500, 17, 700),
                                       (16, 800, 4096, 128, 30_000),
                                       (2, 50, 300, 8, 70_000)])
def test_csr_kernel_matches_twin(cuda, vdt, B, K, C, P, n):
    rng = np.random.default_rng(K + P)
    idx = torch.from_numpy(rng.integers(-1, n, (C, P)).astype(np.int32))
    val = torch.from_numpy(rng.normal(0, 1, (C, P)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (B, n)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, C, (B, K)).astype(np.int32))
    idx, val, q, slots = (idx.to(cuda), val.to(vdt).to(cuda), q.to(cuda),
                          slots.to(cuda))
    for s in (slots, None):
        got = csr_score.csr_score(q, idx, val, s)
        want = csr_score.csr_score_plain(q, idx, val, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("L,h,kp", [(0, 1, 1), (64, 1, 800), (150, 3, 1_500),
                                    (7, 2, 8_192)])
def test_sinnamon_topk_smem_matches_kernel_layout(cuda, L, h, kp):
    """The wrapper's shared-memory check sizes the block as the kernel's
    own layout does."""
    lib = sinnamon_score._lib()
    want = sinnamon_score._topk_smem_fixed(kp) + L * (2 + h) * 4
    assert lib.sinnamon_topk_smem(L, h, kp) == want


def test_dense_kernel_rejects_misaligned_sketch(cuda):
    """A sketch view that does not start on a 16-byte boundary raises
    instead of launching (the kernel copies rows in 16-byte pieces)."""
    rng = np.random.default_rng(5)
    qv, rows, brows, bits, _, sk = [
        t.to(cuda) for t in _fused_operands(rng, 2, 6, 1, 8, 256, 40,
                                            torch.bfloat16, True)]
    flat = torch.empty(sk.numel() + 1, dtype=sk.dtype, device=cuda)
    view = flat[1:].view(sk.shape)
    view.copy_(sk)
    assert view.is_contiguous() and view.data_ptr() % 16
    before = sinnamon_score.sinnamon_score.launches
    with pytest.raises(ValueError, match="16-byte"):
        sinnamon_score.sinnamon_score(qv, rows, brows, bits, view)
    assert sinnamon_score.sinnamon_score.launches == before
    got = sinnamon_score.sinnamon_score(qv, rows, brows, bits, sk)
    assert torch.equal(got, sinnamon_score.sinnamon_score_plain(
        qv, rows, brows, bits, view))


@pytest.mark.parametrize("R,cell_bytes,h", [(16, 4, 1), (128, 2, 1),
                                            (128, 1, 2), (192, 4, 3),
                                            (1_720, 4, 1), (6_880, 1, 1)])
def test_dense_smem_matches_kernel_layout(cuda, R, cell_bytes, h):
    """The wrapper's tile choice sizes the block as kernel C's own layout
    does."""
    lib = sinnamon_score._dense_lib()
    words, smem = sinnamon_score.dense_tile(R, cell_bytes, h)
    assert lib.sinnamon_dense_smem(R, cell_bytes, words, h) == smem


def test_kernel_rejects_bad_operands(cuda):
    q = torch.zeros((2, 10), device=cuda)
    idx = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    val = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        csr_score.csr_score(q, idx, val)


@pytest.mark.parametrize("cell", ["bf16", "f8"])
def test_index_on_card_matches_cpu(cuda, cell):
    """Inserts, deletes and searches on the card give the CPU index's
    state bit for bit and its ids; kernel path == plain-twin path."""
    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12)
    idx, val = synth.make_corpus(0, ds, 300, pad=48)
    qi, qv = synth.make_queries(1, ds, 8, pad=24)
    spec = teng.EngineSpec(n=500, m=16, h=2, capacity=320, max_nnz=48,
                           dtype=cell, value_dtype="float32", seed=3)
    out = {}
    for dev in ("cpu", "cuda"):
        index = teng.SinnamonIndex(spec, device=dev)
        index.insert_many(list(range(280)), idx[:280], val[:280])
        for d in range(0, 280, 5):
            index.delete(d)
        index.insert_many(list(range(280, 300)), idx[280:], val[280:])
        out[dev] = index
    a, b = out["cpu"].state, out["cuda"].state
    for name in ("sketch", "bits", "active", "ids", "dirty"):
        x, y = getattr(a, name), getattr(b, name).cpu()
        assert torch.equal(x.view(torch.uint8) if x.dtype.is_floating_point
                           else x, y.view(torch.uint8)
                           if y.dtype.is_floating_point else y), name
    want, _ = out["cpu"].search_many(qi, qv, k=10, kprime=60)
    got, _ = out["cuda"].search_many(qi, qv, k=10, kprime=60)
    np.testing.assert_array_equal(got, want)
    dev_index = out["cuda"]
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=cuda)  # noqa: E731
    ids_k, sc_k, _ = teng.search_batch(dev_index.state, spec,
                                       t(qi, torch.int32),
                                       t(qv, torch.float32), 10, 60)
    ids_p, sc_p, _ = teng.search_batch(dev_index.state, spec,
                                       t(qi, torch.int32),
                                       t(qv, torch.float32), 10, 60,
                                       use_kernel=False)
    assert torch.equal(ids_k, ids_p)
    torch.testing.assert_close(sc_k, sc_p, rtol=1e-5, atol=1e-5)


def _bag_operands(rng, V, D, B, F, dtype, cuda, aligned=True):
    table = _cells(rng, (V, D), dtype).to(cuda)
    if not aligned:          # the same rows, one element past an aligned base
        base = torch.empty(V * D + 1, dtype=dtype, device=cuda)
        base[1:] = table.reshape(-1)
        table = base[1:].view(V, D)
    idx = rng.integers(-1, V, (B, F)).astype(np.int32)
    idx[rng.random((B, F)) < 0.2] = -1
    w = rng.normal(0, 1, (B, F)).astype(np.float32)
    return table, torch.from_numpy(idx).to(cuda), torch.from_numpy(w).to(cuda)


@pytest.mark.parametrize("cell", ["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 18, 64, 128])
@pytest.mark.parametrize("F", [1, 4, 40])
def test_embed_bag_kernel_bit_equal_to_twin(cuda, cell, D, F):
    rng = np.random.default_rng(D * 100 + F)
    table, idx, w = _bag_operands(rng, 3000, D, 5000, F, CELLS[cell], cuda)
    before = embed_bag.embed_bag.launches
    got = embed_bag.embed_bag(table, idx, w)
    assert embed_bag.embed_bag.launches == before + 1
    want = embed_bag.embed_bag_plain(table, idx, w)
    torch.cuda.synchronize()
    assert got.shape == (5000, D) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    mean = ops.embed_bag(table, idx, w, mode="mean")
    assert torch.equal(mean, ops.embed_bag(table, idx, w, mode="mean",
                                           use_kernel=False))


@pytest.mark.parametrize("cell", ["f32", "bf16"])
def test_embed_bag_kernel_unaligned_table(cuda, cell):
    rng = np.random.default_rng(7)
    table, idx, w = _bag_operands(rng, 500, 64, 700, 6, CELLS[cell], cuda,
                                  aligned=False)
    assert table.data_ptr() % 16 != 0
    got = embed_bag.embed_bag(table, idx, w)
    want = embed_bag.embed_bag_plain(table, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_embed_bag_rejects_bad_operands(cuda):
    table = torch.zeros((10, 8), device=cuda)
    idx = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    w = torch.ones((4, 3), device=cuda)
    for args in ((table, idx.long(), w),                     # int64 indices
                 (table.t(), idx, w),                        # not contiguous
                 (table, idx.cpu(), w),                      # mixed devices
                 (table, idx, w[:, :2].contiguous())):       # shape mismatch
        with pytest.raises(ValueError):
            embed_bag.embed_bag(*args)


def test_dlrm_kernel_path_bit_equal_to_twin_path(cuda):
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import loaders
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import recsys
    cfg = dlrm_rm2.smoke_config()
    model = recsys.DLRM(cfg, torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    batch = loaders.recsys_batch(0, 0, 256, cfg)
    reset_launch_counts()
    got = recsys.score(model, batch, cfg)
    assert launch_counts()["embed_bag"] == 1
    want = recsys.score(model, batch, cfg, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
