"""Kernel-against-twin checks on the card (marker ``gpu``).

Each CUDA kernel of ``repro_torch`` (A: ``sinnamon_score_topk``, B:
``csr_score`` and its rerank form ``csr_rerank_topk``, C: ``sinnamon_score``,
D: ``embed_bag``) is run at small shapes on CUDA
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
from repro_torch.kernels import _build, csr_rerank, csr_score  # noqa: E402
from repro_torch.kernels import embed_bag, ops  # noqa: E402
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


@pytest.mark.parametrize("cell", ["bf16", "f8"])
def test_durable_index_on_card_recovers_bit_equal(cuda, cell, tmp_path):
    """A durable index on the card (CUDA update batches, a snapshot, a WAL
    tail with a batched delete and a compaction) recovers on the card to
    its live state bit for bit, and serves the same ids and scores through
    kernel A and B's rerank kernel; the CPU recovery of the same files
    gives the same state."""
    import repro_torch.kernels as kernels
    from repro_torch import convert
    from repro_torch.persist.durable import DurableSinnamonIndex

    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12)
    idx, val = synth.make_corpus(2, ds, 300, pad=48)
    qi, qv = synth.make_queries(3, ds, 8, pad=24)
    spec = teng.EngineSpec(n=500, m=16, h=2, capacity=320, max_nnz=48,
                           dtype=cell, seed=3)
    kw = dict(wal_dir=str(tmp_path / "wal"),
              snapshot_dir=str(tmp_path / "snap"))
    live = DurableSinnamonIndex.open(spec, device=cuda, **kw)
    i_t, v_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    live.insert_many(list(range(200)), i_t[:200], v_t[:200])
    live.snapshot()
    live.delete_many(list(range(0, 200, 7)))
    live.insert_many(torch.arange(200, 300, device=cuda), i_t[200:],
                     v_t[200:])
    live.compact()
    live.delete(13)
    want = convert.state_to_numpy(live.state, spec)
    for dev in (cuda, "cpu"):
        rec = DurableSinnamonIndex.open(spec, device=dev, **kw)
        assert rec._id2slot == live._id2slot and rec._free == live._free
        got = convert.state_to_numpy(rec.state, spec)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rec = DurableSinnamonIndex.open(spec, device=cuda, **kw)
    kernels.reset_launch_counts()
    got_ids, got_sc = rec.search_many(qi, qv, k=10, kprime=60)
    counts = kernels.launch_counts()
    assert counts["sinnamon_score_topk"] >= 1
    assert counts["csr_rerank_topk"] >= 1
    assert counts["sinnamon_score"] == 0 and counts["embed_bag"] == 0
    want_ids, want_sc = live.search_many(qi, qv, k=10, kprime=60)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_sc, want_sc)


def test_searches_from_threads_on_card_match_one_thread(cuda):
    """Four threads searching one index on the card at once (the state
    lock lets them share it) get the answers a single thread gets, through
    kernel A and B's rerank; a write between rounds is seen by all."""
    import threading

    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12)
    idx, val = synth.make_corpus(4, ds, 300, pad=48)
    qi, qv = synth.make_queries(5, ds, 8, pad=24)
    spec = teng.EngineSpec(n=500, m=16, h=2, capacity=320, max_nnz=48,
                           dtype="bf16", seed=3)
    index = teng.SinnamonIndex(spec, device=cuda)
    index.insert_many(list(range(300)), idx, val)
    for round_ in range(2):
        want = index.search_many(qi, qv, k=10, kprime=60)
        got, errors = [None] * 4, []

        def search(t):
            try:
                for _ in range(5):
                    got[t] = index.search_many(qi, qv, k=10, kprime=60)
            except Exception as e:              # noqa: BLE001
                errors.append(e)
        threads = [threading.Thread(target=search, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors and not any(t.is_alive() for t in threads)
        for ids, scores in got:
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(scores, want[1])
        index.delete_many(list(range(round_, 300, 5)))


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


def _stacked_operands(rng, F, V, D, B, hot, dtype, cuda, aligned=True,
                      weighted=True):
    """Tables [F, V, D], indices int32[B, F, hot] with 20% pads, weights
    f32[B, F, hot] (or None) and a [B, F+1, D] buffer whose row 0 holds a
    sentinel (NaNs of a fixed payload)."""
    tables, _, _ = _bag_operands(rng, F * V, D, 1, 1, dtype, cuda, aligned)
    tables = tables.view(F, V, D)
    idx = rng.integers(0, V, (B, F, hot)).astype(np.int32)
    idx[rng.random((B, F, hot)) < 0.2] = -1
    w = rng.normal(0, 1, (B, F, hot)).astype(np.float32)
    vecs = torch.full((B, F + 1, D), 0, dtype=torch.int32, device=cuda)
    vecs[:, 0] = 0x7fc0beef
    return (tables, torch.from_numpy(idx).to(cuda),
            torch.from_numpy(w).to(cuda) if weighted else None,
            vecs.view(torch.float32))


@pytest.mark.parametrize("cell", ["f32", "bf16"])
@pytest.mark.parametrize("hot", [1, 4])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
def test_stacked_embed_bag_bit_equal_to_twin(cuda, cell, hot, weighted,
                                             aligned):
    """The stacked form writes each bag into rows 1.. of the [B, F+1, D]
    buffer, bit-equal to its twin and to the flat twin over the field-offset
    operands, leaves row 0 as it was, and launches once."""
    rng = np.random.default_rng(hot * 10 + weighted)
    tables, idx, w, vecs = _stacked_operands(rng, 5, 700, 64, 3001, hot,
                                             CELLS[cell], cuda, aligned,
                                             weighted)
    assert (tables.data_ptr() % 16 == 0) == aligned
    plan = embed_bag.launch_plan(tables, vecs[:, 1:])
    assert plan.vec == (16 // tables.element_size() if aligned else 1)
    sentinel = vecs[:, 0].clone()
    before = embed_bag.embed_bag.launches
    got = embed_bag.embed_bag(tables, idx, w, out=vecs[:, 1:])
    assert embed_bag.embed_bag.launches == before + 1
    assert got.data_ptr() == vecs[:, 1:].data_ptr()
    want = embed_bag.stacked_embed_bag_plain(tables, idx, w)
    F, V, D = tables.shape
    offs = torch.arange(F, device=cuda, dtype=torch.int32)[None, :, None] * V
    flat_idx = torch.where(idx >= 0, idx + offs, -1).view(-1, hot)
    flat = embed_bag.embed_bag_plain(tables.view(F * V, D), flat_idx,
                                     None if w is None else w.view(-1, hot))
    torch.cuda.synchronize()
    bits = vecs[:, 1:].contiguous().view(torch.int32)
    assert torch.equal(bits, want.view(torch.int32))
    assert torch.equal(bits, flat.view(-1, F, D).view(torch.int32))
    assert torch.equal(vecs[:, 0].view(torch.int32),
                       sentinel.view(torch.int32))


@pytest.mark.parametrize("B", [1, 2, 20, 512])
def test_stacked_embed_bag_every_grid(cuda, B):
    """26 fields: 26 bags (less than one 32-bag chunk), 52 and 520 (ragged
    last chunks) and the serve_p99 shape's 13,312, where blocks shrink to
    spread over the SMs: bit-equal to the twin."""
    rng = np.random.default_rng(B)
    tables, idx, _, vecs = _stacked_operands(rng, 26, 100, 64, B, 1,
                                             torch.float32, cuda,
                                             weighted=False)
    got = embed_bag.embed_bag(tables, idx, out=vecs[:, 1:])
    want = embed_bag.stacked_embed_bag_plain(tables, idx)
    torch.cuda.synchronize()
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.view(torch.int32))


def test_stacked_embed_bag_rejects_bad_operands(cuda):
    tables = torch.zeros((3, 10, 8), device=cuda)
    idx = torch.zeros((4, 3, 2), dtype=torch.int32, device=cuda)
    vecs = torch.zeros((4, 4, 8), device=cuda)
    for args, out in (((tables, idx.long()), None),          # int64 indices
                      ((tables, idx[:, :2].contiguous()), None),   # F != 3
                      ((tables.transpose(1, 2), idx), None),  # not contiguous
                      ((tables, idx.cpu()), None),            # mixed devices
                      ((tables, idx), vecs[:3, 1:]),          # out too small
                      ((tables, idx), vecs[:, 1:, ::2]),      # column stride
                      ((tables, idx), vecs.view(-1).as_strided(
                          (4, 3, 8), (8, 4, 1)))):            # bags overlap
        with pytest.raises(ValueError):
            embed_bag.embed_bag(*args, out=out)


def test_dlrm_kernel_path_bit_equal_to_twin_path_multi_hot(cuda):
    """Smoke width with 4 lookups a field: logits and the [B, F+1, D]
    interaction input bit-equal to the twin program's, one launch."""
    import dataclasses

    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import loaders
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import recsys
    cfg = dataclasses.replace(dlrm_rm2.smoke_config(), multi_hot=4)
    model = recsys.DLRM(cfg, torch.Generator(device=cuda).manual_seed(2),
                        device=cuda)
    batch = loaders.recsys_batch(0, 3, 300, cfg)
    reset_launch_counts()
    got = recsys.score(model, batch, cfg)
    vecs = model.interaction_input(batch.dense, batch.sparse)
    assert launch_counts()["embed_bag"] == 2
    want = recsys.score(model, batch, cfg, use_kernel=False)
    vecs_p = model.interaction_input(batch.dense, batch.sparse,
                                     use_kernel=False)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(vecs.view(torch.int32), vecs_p.view(torch.int32))


# -- kernel B's rerank form: csr_rerank_topk ---------------------------------

def _rerank_operands(rng, B, Kp, C, P, n, vdt, cuda, Lq=64, integer=False,
                     gate=0.1):
    """Rows with pads, queries with duplicate, padded and row-sharing
    coordinates, distinct candidate slots per query, a share gated to
    -inf.  ``integer`` draws small integers: every sum is exact."""
    idx = rng.integers(0, n, (C, P)).astype(np.int32)
    idx[rng.random((C, P)) < 0.2] = -1
    qi = rng.integers(0, n, (B, Lq)).astype(np.int32)
    h = min(P // 2, Lq // 2)
    if h:
        qi[:, :h] = idx[rng.integers(0, C, B), :h]
    qi[:, h:h + 2] = qi[:, :1]                     # duplicates
    qi[:, -4:] = -1                                # pads
    if integer:
        val = rng.integers(-3, 4, (C, P)).astype(np.float32)
        qv = rng.integers(-2, 3, (B, Lq)).astype(np.float32)
    else:
        val = rng.normal(0, 1, (C, P)).astype(np.float32)
        qv = rng.normal(0, 1, (B, Lq)).astype(np.float32)
    slots = np.stack([rng.permutation(C)[:Kp] for _ in range(B)])
    cand = rng.normal(0, 1, (B, Kp)).astype(np.float32)
    cand[rng.random((B, Kp)) < gate] = -np.inf
    ids = rng.integers(0, 2**40, C).astype(np.int64)
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=cuda)  # noqa: E731
    return (t(qi, torch.int32), t(qv, torch.float32), t(idx, torch.int32),
            t(val, torch.float32).to(vdt), t(ids, torch.int64),
            t(cand, torch.float32), t(slots, torch.int32))


def _assert_rerank_close(got, want, rtol=1e-5, atol=1e-5):
    """Scores within rtol = atol and slots equal, except that a place may
    hold another candidate whose twin score agrees with the twin's there
    within that tolerance (kernel and twin sum a row in different orders,
    so two such candidates may swap)."""
    (_, gs, gl), (_, ws, wl) = got, want
    torch.testing.assert_close(gs, ws, rtol=rtol, atol=atol)
    for b, i in (gl != wl).nonzero().tolist():
        s_, v = int(gl[b, i]), float(gs[b, i])
        at = (wl[b] == s_).nonzero()
        w = float(ws[b, at[0, 0]] if at.numel() else ws[b, -1])
        assert v == w or abs(v - w) <= atol + rtol * abs(w), (b, i)


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Kp,C,P,n", [
    (1, 40, 96, 1, 300),              # one entry a row: scalar, G = 1
    (16, 40, 96, 7, 300),             # scalar loads, G = 2
    (3, 130, 300, 17, 700),           # S = 3 uneven blocks, G = 32
    (16, 200, 512, 12, 300),          # P % 8 == 4: 16-byte loads of four
    (1, 800, 4096, 128, 30_000),      # S = 8
    (16, 800, 4096, 128, 30_000),     # the main path's B = 16: S = 8
    (64, 800, 4096, 128, 30_000),     # S = 3
    (256, 800, 4096, 128, 30_000),    # S = 1
    (256, 200, 2_048, 16, 64),        # the recsys retrieval's shape
])
def test_rerank_kernel_matches_twin(cuda, vdt, B, Kp, C, P, n):
    rng = np.random.default_rng(B * 7 + P)
    ops_ = _rerank_operands(rng, B, Kp, C, P, n, vdt, cuda)
    for k in (1, 10, Kp):
        before = csr_rerank.csr_rerank_topk.launches
        got = csr_rerank.csr_rerank_topk(*ops_, k)
        assert csr_rerank.csr_rerank_topk.launches == before + 1
        want = csr_rerank.csr_rerank_topk_plain(*ops_, k)
        torch.cuda.synchronize()
        assert got[0].shape == (B, k) and got[2].dtype == torch.int32
        _assert_rerank_close(got, want)
        assert torch.equal(got[0], ops_[4][got[2].long()])


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P", [(1, 128), (16, 128), (256, 128), (16, 7),
                                 (256, 16)])
def test_rerank_kernel_bit_equal_on_integer_ties(cuda, vdt, B, P):
    """Integer-valued rows and queries: every sum is exact in f32, scores
    tie often, and ids, scores and slots are bit-equal to the twin's, the
    ties broken by candidate position (k = 10 merges S * k keys in rank
    0's shared memory, k = K' through distributed shared memory)."""
    rng = np.random.default_rng(B + P)
    ops_ = _rerank_operands(rng, B, 800, 4096, P, 300, vdt, cuda,
                            integer=True)
    for k in (10, 800):
        got = csr_rerank.csr_rerank_topk(*ops_, k)
        want = csr_rerank.csr_rerank_topk_plain(*ops_, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
    assert (want[1][:, :-1] == want[1][:, 1:]).any()


@pytest.mark.parametrize("S", range(1, 9))
def test_rerank_kernel_every_split(cuda, S):
    """Each cluster size S the wrapper picks at k' = 800 (B = the card's
    SMs / S, rounded up): bit-equal to the twin on an integer batch."""
    sms = _build.sm_count(cuda)
    B = -(-sms // S)
    assert csr_rerank.split(B, 800, sms) == S
    rng = np.random.default_rng(S)
    ops_ = _rerank_operands(rng, B, 800, 4096, 128, 300, torch.bfloat16,
                            cuda, integer=True)
    for k in (10, 800):
        got = csr_rerank.csr_rerank_topk(*ops_, k)
        want = csr_rerank.csr_rerank_topk_plain(*ops_, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))


@pytest.mark.parametrize("B", [1, 16, 256])
def test_rerank_kernel_all_gated(cuda, B):
    """Every candidate gated: the answer is the first k positions in order,
    all -inf, and no row is read (the rows here hold NaN)."""
    rng = np.random.default_rng(B)
    qi, qv, idx, val, ids, cand, slots = _rerank_operands(
        rng, B, 800, 4096, 128, 30_000, torch.float32, cuda)
    cand.fill_(-torch.inf)
    val.fill_(torch.nan)
    got = csr_rerank.csr_rerank_topk(qi, qv, idx, val, ids, cand, slots, 10)
    torch.cuda.synchronize()
    assert torch.isneginf(got[1]).all()
    assert torch.equal(got[2], slots[:, :10])
    assert torch.equal(got[0], ids[slots[:, :10].long()])


def test_rerank_kernel_unaligned_rows(cuda):
    """Rows that do not start on a 16-byte boundary take scalar loads and
    give the same answer."""
    rng = np.random.default_rng(3)
    qi, qv, idx, val, ids, cand, slots = _rerank_operands(
        rng, 16, 800, 4096, 128, 30_000, torch.bfloat16, cuda, integer=True)
    base = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=cuda)
    view = base[1:].view(idx.shape)
    view.copy_(idx)
    assert view.data_ptr() % 16
    got = csr_rerank.csr_rerank_topk(qi, qv, view, val, ids, cand, slots, 10)
    want = csr_rerank.csr_rerank_topk(qi, qv, idx, val, ids, cand, slots, 10)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rerank_kernel_at_its_caps(cuda):
    """K' = 32,768 candidates (eight blocks of 4,096) and a query of 4,096
    coordinates: the largest block the wrapper allows launches, fits the
    card's shared memory and matches the twin."""
    rng = np.random.default_rng(4)
    Kp, Lq = csr_rerank.MAX_KPRIME, csr_rerank.MAX_QUERY_NNZ
    ops_ = _rerank_operands(rng, 2, Kp, Kp, 16, 30_000, torch.float32, cuda,
                            Lq=Lq, integer=True)
    lib = csr_rerank._lib()
    for k in (10, 256, Kp):
        assert lib.csr_rerank_smem(Lq, Kp, k, 8) <= _build.SMEM_PER_BLOCK
        got = csr_rerank.csr_rerank_topk(*ops_, k)
        want = csr_rerank.csr_rerank_topk_plain(*ops_, k)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lib.csr_rerank_launch(0, 4, *([None] * 2), 1, Lq + 1,
                                 *([None] * 2), 16, 2, *([None] * 3), 800,
                                 10, 1, *([None] * 4)) != 0


def test_rerank_kernel_rejects_bad_operands(cuda):
    rng = np.random.default_rng(5)
    qi, qv, idx, val, ids, cand, slots = _rerank_operands(
        rng, 4, 40, 96, 8, 300, torch.float32, cuda)
    before = csr_rerank.csr_rerank_topk.launches
    for args in ((qi.long(), qv, idx, val, ids, cand, slots),
                 (qi, qv, idx, val, ids, cand, slots.cpu()),
                 (qi, qv, idx, val.half(), ids, cand, slots),
                 (qi, qv, idx, val, ids, cand[:, :-1].contiguous(), slots)):
        with pytest.raises(ValueError):
            csr_rerank.csr_rerank_topk(*args, 10)
    assert csr_rerank.csr_rerank_topk.launches == before


def test_rerank_topk_is_one_launch_and_no_csr_score(cuda):
    """``engine.rerank_topk`` on CUDA tensors is one launch of the rerank
    kernel and none of ``csr_score``; the search's ids equal the CPU
    index's."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12)
    idx, val = synth.make_corpus(0, ds, 300, pad=48)
    qi, qv = synth.make_queries(1, ds, 8, pad=24)
    spec = teng.EngineSpec(n=500, m=16, h=2, capacity=320, max_nnz=48,
                           value_dtype="bfloat16", seed=3)
    want = {}
    for dev in ("cpu", "cuda"):
        index = teng.SinnamonIndex(spec, device=dev)
        index.insert_many(list(range(300)), idx, val)
        want[dev] = index.search_many(qi, qv, k=10, kprime=60)[0]
    np.testing.assert_array_equal(want["cuda"], want["cpu"])
    t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=cuda)  # noqa: E731
    q = (t(qi, torch.int32), t(qv, torch.float32))
    cv, cs = teng.topk_candidates(index.state, spec, *q, 60)
    reset_launch_counts()
    for _ in range(3):
        teng.rerank_topk(index.state, cv, cs, *q, 10)
    counts = launch_counts()
    assert counts["csr_rerank_topk"] == 3 and counts["csr_score"] == 0
    reset_launch_counts()
    teng.search_batch(index.state, spec, *q, 10, 60)
    counts = launch_counts()
    assert counts["csr_rerank_topk"] == 1 and counts["csr_score"] == 0
