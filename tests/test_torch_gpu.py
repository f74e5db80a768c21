"""Kernel-against-twin checks on the card (marker ``gpu``).

Each CUDA kernel of ``repro_torch`` (A: ``sinnamon_score_topk``, B:
``csr_score`` and its rerank form ``csr_rerank_topk``, C: ``sinnamon_score``,
D: ``embed_bag`` and its backward ``embed_bag_backward``) is run at
small shapes on CUDA tensors and held against its plain-torch twin on the
same tensors (the backward: bit-equal to its twin on the host copy and to
a second launch); a DLRM train step through D and its backward is held
to the twin path's, and DIN, SASRec and MIND on the card to the CPU; the
paths around them (the rows rerank, the front door, the tiered index, the
sharded index and its tiered and durable forms) are held to their twin
paths or resident forms on the card.  The tests skip
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


def _sample_bound(ops_, kprime, stride):
    """The sample's top-k' keys (kernel A's top-k form over tiles 0,
    stride, ...) and their last, each query's bound."""
    B = ops_[0].shape[0]
    kp = min(kprime, sinnamon_score.TILE_C)
    sv, ss = sinnamon_score._launch(*ops_, kp, True, stride)
    head = torch.topk(sinnamon_score.order_key(sv, ss).reshape(B, -1),
                      kprime, largest=False, sorted=True).values
    return head, head[:, -1].contiguous()


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("B,L,m,C,kprime,density,cap", [
    (16, 20, 16, 40 * 8_192, 800, 1 / 64, None),
    (8, 64, 16, 33 * 8_192 + 1_056, 800, 0.5, None),   # a partial tile
    (4, 6, 8, 34 * 8_192, 9_000, 1 / 512, None),       # k' > TILE_C
    (16, 20, 16, 40 * 8_192, 800, 1 / 64, 37),         # counts past cap
])
def test_threshold_form_matches_twin(cuda, cell, B, L, m, C, kprime, density,
                                     cap):
    """Kernel A's threshold form against its twin: each query's count and
    the flag equal; the survivors equal as sets (the kernel appends in no
    set order) or, past ``cap``, ``cap`` of the twin's; a gated bound
    (query 1) gives no survivors and sets the flag."""
    rng = np.random.default_rng(B * 7 + C)
    ops_ = [t.to(cuda) for t in _fused_operands(rng, B, L, 1, m, C, 40,
                                                CELLS[cell], True, density)]
    s = sinnamon_score.SAMPLE_STRIDE
    head, theta = _sample_bound(ops_, kprime, s)
    theta[1] = sinnamon_score.GATED_KEY + 5
    cap = cap or sinnamon_score.survivor_cap(kprime, s)
    before = sinnamon_score.sinnamon_score_threshold.launches
    kk, kc, kf = sinnamon_score.sinnamon_score_threshold(
        *ops_, theta, head, stride=s, cap=cap)
    assert sinnamon_score.sinnamon_score_threshold.launches == before + 1
    tk, tc, tf = sinnamon_score.sinnamon_score_threshold(
        *ops_, theta, head, stride=s, cap=C, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(kc, tc) and int(kc[1]) == 0
    assert int(kf) == 1 and int(tf) == 1
    H = head.shape[1]
    assert torch.equal(kk[:, :H], head)
    for b in range(B):
        n = int(kc[b])
        got = torch.sort(kk[b, H:H + min(n, cap)]).values
        if n <= cap:
            assert torch.equal(got, tk[b, H:H + n])
        else:
            assert bool(torch.isin(got, tk[b, H:H + n]).all())
        assert bool((kk[b, H + min(n, cap):] == sinnamon_score.KEY_PAD).all())


def test_flag_reaches_the_host_behind_its_pass(cuda):
    """``ops.flagged`` reads a flag copied to the host behind the pass that
    set it, through its event; candidates without a flag read False."""
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    flag.fill_(1)
    host, ready = ops._flag_to_host(flag)
    assert host.device.type == "cpu" and host.is_pinned()
    late = torch.randn(4_096, 4_096, device=cuda)
    late = late @ late                     # queued after the copy
    cands = [ops.Candidates(None, None, host, ready),
             ops.Candidates(None, None)]
    assert ops.flagged(cands) == [True, False]
    del late


@pytest.mark.parametrize("B", [16, 256])
def test_two_pass_bit_equal_to_single_pass_at_shard_size(cuda, monkeypatch,
                                                         B):
    """One shard's 136 tiles: the two passes (given the stride at B=16,
    which is under the cut) give the single pass's candidates bit for bit,
    with one launch of each form; a survivor cap of 3 sets the flag, and
    the single pass (one more top-k launch) gives the same answer."""
    rng = np.random.default_rng(B)
    C, kprime = 136 * 8_192, 800
    ops_ = [t.to(cuda) for t in _fused_operands(rng, B, 64, 1, 64, C, 40,
                                                torch.bfloat16, True)]
    want = sinnamon_score.merge_tile_topk(
        *sinnamon_score.sinnamon_score_topk(*ops_, kp=kprime), kprime)
    kw = dict(one_sided=True, use_kernel=None, tile_c=sinnamon_score.TILE_C)
    for cap, launches in ((None, (1, 1)), (3, (2, 1))):
        if cap is not None:
            monkeypatch.setattr(sinnamon_score, "survivor_cap",
                                lambda kprime, stride: cap)
        a0 = sinnamon_score.sinnamon_score_topk.launches
        t0 = sinnamon_score.sinnamon_score_threshold.launches
        f0 = sinnamon_score.candidate_scan.fallbacks
        keys, flag = sinnamon_score._scan(ops_, kprime,
                                          sinnamon_score.SAMPLE_STRIDE, kw)
        assert int(flag) == (cap == 3)
        if int(flag):
            keys = sinnamon_score.rescan(*ops_, kprime=kprime)
        got = sinnamon_score.merge_keys(keys, kprime)
        torch.cuda.synchronize()
        assert (sinnamon_score.sinnamon_score_topk.launches - a0,
                sinnamon_score.sinnamon_score_threshold.launches - t0) \
            == launches
        assert sinnamon_score.candidate_scan.fallbacks - f0 == (cap == 3)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))


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


# -- the tiered rerank, the front door and the tiered index on the card -------

@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Kp", [(1, 800), (16, 800), (256, 800), (3, 130)])
def test_rerank_topk_rows_matches_twin_and_resident(cuda, vdt, B, Kp):
    """``engine.rerank_topk_rows`` over gathered rows: one launch of the
    unchanged rerank kernel, bit-equal to ``rerank_topk`` on the resident
    store (a row's score does not depend on where it lies), and within the
    twin's tolerance of the twin on the same rows."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(B + Kp)
    qi, qv, idx, val, ids, cand, slots = _rerank_operands(
        rng, B, Kp, 4096, 128, 30_000, vdt, cuda)
    state = teng.SinnamonState(
        mappings=None, sketch=torch.zeros((1, 4096), device=cuda), bits=None,
        store=teng.vecstore.VecStore(idx, val), active=None, ids=ids,
        dirty=None, m=1)
    flat = slots.reshape(-1).long()
    rows_i, rows_v = idx[flat], val[flat]
    reset_launch_counts()
    got = teng.rerank_topk_rows(state, cand, slots, rows_i, rows_v, qi, qv,
                                10)
    assert launch_counts()["csr_rerank_topk"] == 1
    res = teng.rerank_topk(state, cand, slots, qi, qv, 10)
    torch.cuda.synchronize()
    for g, w in zip(got, res):
        assert torch.equal(g, w)
    twin = teng.rerank_topk_rows(state, cand, slots, rows_i, rows_v, qi, qv,
                                 10, use_kernel=False)
    _assert_rerank_close(got, twin)


def _card_index(cuda, cls=teng.SinnamonIndex, **kw):
    ds = synth.SparseDatasetSpec("t", n=2_000, psi_doc=40, psi_query=20)
    idx, val = synth.make_corpus(0, ds, 3_000, pad=64)
    qi, qv = synth.make_queries(1, ds, 48, pad=32)
    spec = teng.EngineSpec(n=2_000, m=16, h=1, capacity=3_072, max_nnz=64,
                           value_dtype="bfloat16", seed=3)
    index = cls(spec, device=cuda, **kw)
    index.insert_many(list(range(3_000)), idx, val)
    return index, idx, val, qi, qv


def test_front_door_coalesced_bit_equal_on_card(cuda):
    """Coalesced front-door answers (padded [16, 32·j] dispatches, dummy
    rows included) equal per-query ``query()`` bit for bit on the card,
    and the ids of one ``query_many`` at B = 48."""
    from repro_torch.serving import QueryServer, ServingFrontend
    index, _, _, qi, qv = _card_index(cuda)
    server = QueryServer(index, k=10, kprime=200)
    expect = [server.query(qi[b], qv[b]) for b in range(qi.shape[0])]
    whole = server.query_many(qi, qv)
    fe = ServingFrontend(server, max_batch=16, batch_window_ms=2.0,
                         query_pad=32, queue_depth=128)
    try:
        futs = [fe.submit(qi[b], qv[b]) for b in range(qi.shape[0])]
        got = [f.result(timeout=120) for f in futs]
    finally:
        fe.close()
    for b, (g, e) in enumerate(zip(got, expect)):
        np.testing.assert_array_equal(g.ids, e.ids, err_msg=f"query {b}")
        np.testing.assert_array_equal(g.scores, e.scores,
                                      err_msg=f"query {b}")
        np.testing.assert_array_equal(g.ids, whole.ids[b])


def test_tiered_bit_equal_to_resident_under_concurrency(cuda):
    """A 2-line cache, two searcher threads and an inserter at once: every
    answer equals the resident index's at the same state, which pins the
    in-place promotion overwriting a line a queued gather still reads."""
    import threading
    resident, idx, val, qi, qv = _card_index(cuda)
    tiered, _, _, _, _ = _card_index(
        cuda, teng.TieredSinnamonIndex, tier_chunk_slots=64, cache_chunks=2)
    want = resident.search_many(qi, qv, k=10, kprime=2)
    errors, stop = [], threading.Event()

    def searcher(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            b = int(rng.integers(0, qi.shape[0]))
            # one query's two candidates lie in at most two chunks: they
            # fit the cache, so each search promotes and evicts
            got = tiered.search_many(qi[b:b + 1], qv[b:b + 1], k=10,
                                     kprime=2)
            for g, w in zip(got, (want[0][b:b + 1], want[1][b:b + 1])):
                if not np.array_equal(g, w):
                    errors.append(b)

    def inserter():
        # re-insert the same documents under new ids: the answers to the
        # searches above stay the same (their top rows are earlier slots)
        for lo in range(0, 3_000, 250):
            tiered.insert_many(list(range(10_000 + lo, 10_250 + lo)),
                               idx[lo:lo + 250] * 0 - 1, val[lo:lo + 250] * 0)

    threads = [threading.Thread(target=searcher, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    ins = threading.Thread(target=inserter)
    ins.start()
    ins.join(timeout=300)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    assert not ins.is_alive() and not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    st = tiered.tiered.stats()
    assert st["promotions"] > 2 and st["evictions"] > 0
    np.testing.assert_array_equal(
        tiered.search_many(qi, qv, k=10, kprime=2)[1], want[1])


def _card_sharded(cuda, cls=None, n_shards=4, docs=3_000, capacity=1_024,
                  **kw):
    """The documents of :func:`_card_index` (``docs`` of them) in a sharded
    index of ``capacity`` slots a shard, every shard on the card."""
    from repro_torch.serving import sharded
    ds = synth.SparseDatasetSpec("t", n=2_000, psi_doc=40, psi_query=20)
    idx, val = synth.make_corpus(0, ds, docs, pad=64)
    qi, qv = synth.make_queries(1, ds, 48, pad=32)
    spec = teng.EngineSpec(n=2_000, m=16, h=1, capacity=capacity, max_nnz=64,
                           value_dtype="bfloat16", seed=3)
    cls = cls or sharded.ShardedSinnamonIndex
    index = cls(spec, cuda, n_shards=n_shards, **kw)
    index.insert_many(list(range(docs)), idx, val)
    return index, idx, val, qi, qv


@pytest.mark.parametrize("kprime", [200, 64])
def test_sharded_kernel_path_matches_twin_path(cuda, kprime):
    """Four shards on one card: kernel A and B's rerank S times a batch;
    the kernel path's ids and locators equal the twin path's and those of
    the same shards on the CPU, scores within B's rtol = atol = 1e-5."""
    import repro_torch.kernels as kernels
    index, _, _, qi, qv = _card_sharded(cuda)
    kernels.reset_launch_counts()
    got = index.search_many(qi, qv, 10, kprime=kprime, return_locators=True)
    counts = kernels.launch_counts()
    assert counts["sinnamon_score_topk"] == counts["csr_rerank_topk"] == 4
    assert counts["sinnamon_score"] == counts["csr_score"] == 0
    twin = index.search_many(qi, qv, 10, kprime=kprime,
                             return_locators=True, use_kernel=False)
    cpu, _, _, _, _ = _card_sharded(torch.device("cpu"))
    on_cpu = cpu.search_many(qi, qv, 10, kprime=kprime, return_locators=True)
    for want in (twin, on_cpu):
        np.testing.assert_array_equal(got[0], want[0])          # ids
        np.testing.assert_array_equal(got[2], want[2])          # locators
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kprime", [64, 800])
def test_sharded_kernel_path_matches_twin_path_over_tiles(cuda, kprime):
    """As above on shards of 2.5 of kernel A's tiles (20,480 slots, 20,000
    documents each), so the per-tile top-k' and the tile merge run over
    full and partial tiles at the deployment's k'=64 and at k'=800."""
    import repro_torch.kernels as kernels
    kw = dict(docs=80_000, capacity=20_480, update_block=4_096)
    index, _, _, qi, qv = _card_sharded(cuda, **kw)
    kernels.reset_launch_counts()
    got = index.search_many(qi, qv, 10, kprime=kprime, return_locators=True)
    assert kernels.launch_counts()["sinnamon_score_topk"] == 4
    twin = index.search_many(qi, qv, 10, kprime=kprime,
                             return_locators=True, use_kernel=False)
    cpu, _, _, _, _ = _card_sharded(torch.device("cpu"), **kw)
    on_cpu = cpu.search_many(qi, qv, 10, kprime=kprime, return_locators=True)
    for want in (twin, on_cpu):
        np.testing.assert_array_equal(got[0], want[0])          # ids
        np.testing.assert_array_equal(got[2], want[2])          # locators
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def test_sharded_score_fn_hook_on_card(cuda):
    """The hook (kernel C once a shard) gives the reference backend's
    candidates, so the same answer."""
    import repro_torch.kernels as kernels
    index, _, _, qi, qv = _card_sharded(cuda)
    want = index.search_many(qi, qv, 10, kprime=200, backend="reference")
    kernels.reset_launch_counts()
    got = index.search_many(qi, qv, 10, kprime=200,
                            score_fn=ops.make_engine_score_fn())
    assert kernels.launch_counts()["sinnamon_score"] == 4
    assert kernels.launch_counts()["sinnamon_score_topk"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_tiered_bit_equal_to_resident_on_card(cuda):
    """Tiered shards with a 2-line cache (every batch falls back) and with
    room for every chunk answer as the resident shards, through churn and
    compaction."""
    from repro_torch.serving import sharded
    churn = list(range(0, 3_000, 7))

    def churned(ix, idx, val):
        ix.delete_many(churn)
        ix.insert_many(churn, idx[churn], val[churn])
        return ix.compact()

    resident, idx, val, qi, qv = _card_sharded(cuda)
    n_res = churned(resident, idx, val)
    want = resident.search_many(qi, qv, 10, kprime=200)
    for lines in (2, 64):
        tiered, _, _, _, _ = _card_sharded(
            cuda, sharded.TieredShardedSinnamonIndex, tier_chunk_slots=64,
            cache_chunks=lines)
        assert churned(tiered, idx, val) == n_res
        for g, w in zip(tiered.search_many(qi, qv, 10, kprime=200), want):
            np.testing.assert_array_equal(g, w)


def test_sharded_durable_recovers_on_card(cuda, tmp_path):
    """Log, snapshot, a WAL tail; the recovered shards on the card equal
    the live ones leaf for leaf and answer alike."""
    from repro_torch import convert
    from repro_torch.persist import DurableShardedSinnamonIndex
    ds = synth.SparseDatasetSpec("t", n=2_000, psi_doc=40, psi_query=20)
    idx, val = synth.make_corpus(0, ds, 2_000, pad=64)
    qi, qv = synth.make_queries(1, ds, 16, pad=32)
    spec = teng.EngineSpec(n=2_000, m=16, h=1, capacity=1_024, max_nnz=64,
                           value_dtype="bfloat16", seed=3)
    dkw = dict(wal_dir=str(tmp_path / "wal"),
               snapshot_dir=str(tmp_path / "snap"), fsync=False)
    live = DurableShardedSinnamonIndex.open(spec, cuda, n_shards=4, **dkw)
    live.insert_many(list(range(1_500)), torch.from_numpy(idx[:1_500]).to(
        cuda), torch.from_numpy(val[:1_500]).to(cuda))
    live.snapshot()
    live.delete_many(range(0, 1_500, 5))
    live.insert_many(list(range(1_500, 2_000)), idx[1_500:], val[1_500:])
    live.compact()
    rec = DurableShardedSinnamonIndex.open(spec, cuda, n_shards=4, **dkw)
    a = convert.state_to_numpy(live.logical_state(), live.spec)
    b = convert.state_to_numpy(rec.logical_state(), rec.spec)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert rec._free == live._free and rec._id2slot == live._id2slot
    for g, w in zip(rec.search_many(qi, qv, 10, kprime=200),
                    live.search_many(qi, qv, 10, kprime=200)):
        np.testing.assert_array_equal(g, w)


# -- kernel D's backward: embed_bag_backward ----------------------------------

def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


def _backward_case(rng, cuda, B, F, V, D, hot, weighted=False, hot_row=None,
                   stacked=True):
    """(grad_bags as a view of rows 1.. of a [B, F+1, D] buffer (stacked)
    or [B, D], int32 indices with 20% pads, weights or None); ``hot_row``
    names one row from half the slots."""
    shape = (B, F, hot) if stacked else (B, hot)
    idx = rng.integers(0, V, shape).astype(np.int32)
    if hot_row is not None:
        idx[rng.random(shape) < 0.5] = hot_row
    idx[rng.random(shape) < 0.2] = -1
    w = rng.normal(0, 1, shape).astype(np.float32) if weighted else None
    if stacked:
        buf = torch.from_numpy(rng.normal(0, 1, (B, F + 1, D)).astype(
            np.float32)).to(cuda)
        grad = buf[:, 1:]
    else:
        grad = torch.from_numpy(rng.normal(0, 1, (B, D)).astype(
            np.float32)).to(cuda)
    return (grad, torch.from_numpy(idx).to(cuda),
            None if w is None else torch.from_numpy(w).to(cuda))


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("D", [64, 18, 8])
@pytest.mark.parametrize("hot", [1, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_backward_bit_equal_to_twin(cuda, stacked, D, hot,
                                              weighted):
    """The backward kernel against its twin (``index_add_`` in slot order
    on the CPU): bit-equal, 20% pads, a strided grad view (stacked: rows
    1.. of a [B, F+1, D] buffer), a row named by half the slots, every
    untouched row 0; two launches give the same bits, one launch a
    call."""
    rng = np.random.default_rng(D * 10 + hot + 100 * weighted)
    F = 5 if stacked else 1
    grad, idx, w = _backward_case(rng, cuda, 700, F, 3_000, D, hot,
                                  weighted, hot_row=17, stacked=stacked)
    assert not grad.is_contiguous() or not stacked
    before = embed_bag.embed_bag_backward.launches
    got = embed_bag.embed_bag_backward(grad, idx, 3_000, w)
    again = embed_bag.embed_bag_backward(grad, idx, 3_000, w)
    assert embed_bag.embed_bag_backward.launches == before + 2
    want = embed_bag.embed_bag_backward_plain(
        grad.cpu(), idx.cpu(), 3_000, None if w is None else w.cpu())
    torch.cuda.synchronize()
    _assert_bits(got.cpu(), want)
    _assert_bits(again, got)
    assert got.shape == ((F, 3_000, D) if stacked else (3_000, D))


@pytest.mark.parametrize("B,V", [(1, 50_000), (3, 7), (64, 100_000),
                                 (4_096, 64)])
def test_embed_bag_backward_gaps_and_runs(cuda, B, V):
    """Rows no slot names are written as zeros by the warps whose heads
    follow them: long gaps (B=1 over 26 x 50,000 rows), a batch whose
    every row is named many times (V=7), all pads, no pads."""
    rng = np.random.default_rng(B + V)
    for pad_all in (False, True):
        grad, idx, _ = _backward_case(rng, cuda, B, 26, V, 64, 1)
        if pad_all:
            idx = torch.full_like(idx, -1)
        got = embed_bag.embed_bag_backward(grad, idx, V)
        want = embed_bag.embed_bag_backward_plain(grad.cpu(), idx.cpu(), V)
        torch.cuda.synchronize()
        _assert_bits(got.cpu(), want)
    idx = torch.from_numpy(rng.integers(0, V, (B, 26, 1)).astype(
        np.int32)).to(cuda)
    got = embed_bag.embed_bag_backward(grad, idx, V)
    want = embed_bag.embed_bag_backward_plain(grad.cpu(), idx.cpu(), V)
    torch.cuda.synchronize()
    _assert_bits(got.cpu(), want)


def test_embed_bag_backward_rejects_bad_operands(cuda):
    grad = torch.zeros((4, 3, 8), device=cuda)
    idx = torch.zeros((4, 3, 2), dtype=torch.int32, device=cuda)
    for args in ((grad, idx.long(), 10),                 # int64 indices
                 (grad[:, :2], idx, 10),                  # fields differ
                 (grad, idx.cpu(), 10),                   # mixed devices
                 (grad[..., ::2], idx, 10),               # column stride
                 (grad.double(), idx, 10),                # f64 gradient
                 (grad, idx, 2**30)):                     # rows past int32
        with pytest.raises(ValueError):
            embed_bag.embed_bag_backward(*args)


def _check_backward(grad, idx, V, w=None):
    """The wrapper once and the kernel on prepared operands once (each a
    launch), both bit-equal to the twin on the host copy."""
    before = embed_bag.embed_bag_backward.launches
    got = embed_bag.embed_bag_backward(grad, idx, V, w)
    keys, slots = embed_bag.backward_operands(idx, V)
    again = embed_bag.backward_kernel(grad, keys, slots, idx.shape[-1], V, w)
    assert embed_bag.embed_bag_backward.launches == before + 2
    want = embed_bag.embed_bag_backward_plain(
        grad.cpu(), idx.cpu(), V, None if w is None else w.cpu())
    torch.cuda.synchronize()
    _assert_bits(got.cpu(), want)
    _assert_bits(again, got)


def _span_rows(F, V, D):
    return embed_bag.backward_plan(1, F, 1, V, D).span_rows


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("D", [64, 18])
@pytest.mark.parametrize("weighted", [False, True])
def test_embed_bag_backward_runs_on_span_edges(cuda, stacked, D, weighted):
    """Runs of several slots on a span's first and last rows (rows R - 1,
    R, 2R - 1, 2R, ...), row 0 and row F·V - 1 named, F·V not a multiple
    of the span's R rows; the flat form with weights among them."""
    rng = np.random.default_rng(D + 2 * stacked + weighted)
    F = 3 if stacked else 1
    R = _span_rows(F, 1, D)
    V = 2 * R + 37 if stacked else 5 * R + 3
    rows = F * V
    assert rows % R
    grad, idx, w = _backward_case(rng, cuda, 300, F, V, D, 2, weighted,
                                  stacked=stacked)
    edges = sorted({0, rows - 1} | {e for k in range(1, rows // R + 1)
                                    for e in (k * R - 1, k * R)
                                    if e < rows})
    host = idx.cpu().numpy().reshape(300, F, 2)
    for g in edges:
        f, v = divmod(g, V)
        bags = rng.choice(300, 4, replace=False)
        host[bags, f, rng.integers(0, 2, 4)] = v
    idx = torch.from_numpy(host.reshape(idx.shape).copy()).to(cuda)
    _check_backward(grad, idx, V, w)


@pytest.mark.parametrize("V", [7, 129, 1_000])
def test_embed_bag_backward_tables_smaller_than_a_span_or_ragged(cuda, V):
    """F·V below one span (V = 7: one block, one span), just past one
    (F = 1, V = 129), and not a multiple of R; stacked and flat."""
    rng = np.random.default_rng(V)
    for stacked, F in ((True, 26), (False, 1)):
        grad, idx, w = _backward_case(rng, cuda, 50, F, V, 64, 2, True,
                                      stacked=stacked)
        _check_backward(grad, idx, V, w)


@pytest.mark.parametrize("stacked", [True, False])
def test_embed_bag_backward_one_run_of_every_slot(cuda, stacked):
    """Every slot names one row: a single run of n = 3,000 slots, longer
    than a block's scan of 256 positions and than a group's 16 lanes."""
    rng = np.random.default_rng(31 + stacked)
    shape = (1_000, 1, 3) if stacked else (1_000, 3)
    idx = torch.full(shape, 5, dtype=torch.int32, device=cuda)
    grad, _, w = _backward_case(rng, cuda, 1_000, 1, 300, 64, 3, True,
                                stacked=stacked)
    _check_backward(grad, idx, 300, w)
    _check_backward(grad, idx, 300)


@pytest.mark.parametrize("D", [100, 260, 50])
def test_embed_bag_backward_wide_rows(cuda, D):
    """D = 100 (25 lanes of float4, not a power of two), D = 260 (a
    column loop past 32 lanes x 4), D = 50 (4-byte accesses and a column
    loop past 32 lanes), stacked with weights and flat without."""
    rng = np.random.default_rng(D)
    grad, idx, w = _backward_case(rng, cuda, 400, 4, 900, D, 3, True,
                                  hot_row=11)
    _check_backward(grad, idx, 900, w)
    grad, idx, _ = _backward_case(rng, cuda, 400, 1, 900, D, 3,
                                  stacked=False)
    _check_backward(grad, idx, 900)


def test_embed_bag_backward_unaligned_gradient(cuda):
    """A gradient view one element off 16 bytes: 4-byte gradient loads
    (64 columns a row in two passes of 32 lanes), 4-byte stores of the
    sums over 16-byte stores of the zeros."""
    rng = np.random.default_rng(17)
    buf = torch.from_numpy(rng.normal(0, 1, (200, 4, 65)).astype(
        np.float32)).to(cuda)
    grad = buf[:, 1:, 1:]
    assert grad.data_ptr() % 16
    idx = torch.from_numpy(rng.integers(-1, 500, (200, 3, 2)).astype(
        np.int32)).to(cuda)
    _check_backward(grad, idx, 500)


def test_ops_embed_bag_autograd_on_card(cuda):
    """ops.embed_bag on a table that takes a gradient: the forward kernel
    and the backward kernel once each, the table's gradient bit-equal to
    the twins' (CPU autograd through the same Function)."""
    rng = np.random.default_rng(11)
    table, idx, w = _bag_operands(rng, 900, 64, 2_000, 6, torch.float32,
                                  cuda)
    upstream = torch.from_numpy(rng.normal(0, 1, (2_000, 64)).astype(
        np.float32))
    got_t = table.clone().requires_grad_(True)
    f0 = embed_bag.embed_bag.launches
    b0 = embed_bag.embed_bag_backward.launches
    (ops.embed_bag(got_t, idx, w) * upstream.to(cuda)).sum().backward()
    assert embed_bag.embed_bag.launches == f0 + 1
    assert embed_bag.embed_bag_backward.launches == b0 + 1
    want_t = table.cpu().clone().requires_grad_(True)
    (ops.embed_bag(want_t, idx.cpu(), w.cpu()) * upstream).sum().backward()
    torch.cuda.synchronize()
    _assert_bits(got_t.grad.cpu(), want_t.grad)


def test_dlrm_train_step_on_card_matches_twin_path(cuda):
    """One train step of DLRM (smoke width, 4 lookups a field) through
    kernel D and its backward kernel against the same step through the
    twins, from the same state: the loss within rtol 1e-5, the table
    gradients within rtol = 1e-5, atol = 1e-6 and every updated parameter
    within rtol = atol = 1e-5 (on the card the twin's ``index_add_`` adds
    with atomics, in another order)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import dlrm_rm2
    from repro_torch.data import loaders
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg = dataclasses.replace(dlrm_rm2.smoke_config(), multi_hot=4)
    gen = torch.Generator(device=cuda).manual_seed(4)
    base = recsys.DLRM(cfg, gen, device=cuda)
    tree = convert.recsys_params_to_numpy(base)
    batch = loaders.recsys_batch(0, 2, 512, cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=20)
    out = {}
    for use_kernel in (None, False):
        model = convert.recsys_params_from_numpy(tree, cfg, device=cuda)
        step = loop.make_train_step(
            lambda p, b, u=use_kernel: (recsys.loss(p, b, cfg,
                                                    use_kernel=u), {}),
            opt_cfg)
        reset_launch_counts()
        recsys.loss(model, batch, cfg, use_kernel=use_kernel).backward()
        out[use_kernel, "grad"] = model.tables.grad.clone()
        counts = launch_counts()
        state, metrics = step(loop.init_state(model), batch)
        out[use_kernel] = (float(metrics["loss"]),
                           {k: t.detach().clone() for k, t in
                            state.params.leaves().items()}, counts)
    (lk, pk, ck), (lt, pt, ct) = out[None], out[False]
    assert ck["embed_bag"] == 1 and ck["embed_bag_backward"] == 1
    assert ct["embed_bag"] == 0 and ct["embed_bag_backward"] == 0
    np.testing.assert_allclose(lk, lt, rtol=1e-5)
    torch.testing.assert_close(out[None, "grad"], out[False, "grad"],
                               rtol=1e-5, atol=1e-6)
    for k in pk:
        torch.testing.assert_close(pk[k], pt[k], rtol=1e-5, atol=1e-5,
                                   msg=k)


@pytest.mark.parametrize("arch", ["din", "sasrec", "mind"])
def test_seq_models_on_card_match_cpu(cuda, arch):
    """DIN, SASRec and MIND at full width (1,000 items) on the card against
    the same parameters and batch on the CPU: serving outputs within
    rtol = atol = 1e-5, the loss within rtol 1e-5 and every gradient
    within rtol = 1e-4, atol = 1e-6 (cuBLAS sums in another order)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.data import loaders
    from repro_torch.models import recsys
    cfg = dataclasses.replace(registry.get(arch).full_config(),
                              n_items=1000)
    tree = convert.recsys_params_to_numpy(
        recsys.init_params(torch.Generator().manual_seed(2), cfg,
                           device="cpu"))
    out = {}
    for dev in ("cpu", cuda):
        model = convert.recsys_params_from_numpy(tree, cfg, device=dev)
        batch = loaders.recsys_batch(0, 3, 64, cfg, device=dev)
        loss = recsys.loss(model, batch, cfg)
        loss.backward()
        out[str(dev)] = (
            {fn: getattr(recsys, fn)(model, batch, cfg).cpu()
             for fn in ("score", "user_repr", "retrieval_scores")},
            loss.detach().cpu(),
            {k: g.cpu() for k, g in model.leaves(grad=True).items()})
    (sc, lc, gc_), (sg, lg, gg) = out["cpu"], out[str(cuda)]
    for fn in sc:
        torch.testing.assert_close(sg[fn], sc[fn], rtol=1e-5, atol=1e-5,
                                   msg=fn)
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    for k in gc_:
        torch.testing.assert_close(gg[k], gc_[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


# -- the LM family (no kernel of the port: torch on the card vs the CPU) ------

LM_ARCHS = ("deepseek-67b", "stablelm-12b", "gemma3-27b",
            "llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")


def _lm_close(got, want, tol, what):
    """max |got - want| within ``tol`` of the largest |want|."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol:g} x {scale:.3g}"


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_on_card_matches_cpu(cuda, arch):
    """A smoke config on the card against the port on the CPU from the
    same f32 weights, activations in f32 (TF32 off: 1e-4 of the largest
    value, f32 sums in another order): forward, loss and every gradient,
    prefill and two decode steps."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.data import loaders
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(registry.get(arch).smoke_config(),
                              dtype="float32")
    tree = convert.lm_params_to_numpy(
        tr.init_params(torch.Generator().manual_seed(2), cfg, device="cpu"))
    out = {}
    for dev in ("cpu", cuda):
        model = convert.lm_params_from_numpy(tree, cfg, device=dev)
        toks, labels = loaders.lm_batch(0, 3, 2, 64, cfg.vocab, device=dev)
        loss, metrics = tr.lm_loss(model, toks, labels, cfg)
        loss.backward()
        logits, cache = tr.prefill(model, toks[:, :48], cfg)
        full = tr.init_cache(cfg, 2, 50, device=dev)
        for n in full:
            full[n][:, :, :, :48] = cache[n]
        dec = [tr.decode_step(model, full, toks[:, p:p + 1], p, cfg)[0]
               for p in (48, 49)]
        out[str(dev)] = (loss, metrics["aux"], model.leaves(grad=True),
                         logits, dec)
    (lc, ac, gc_, pc, dc), (lg, ag, gg, pg, dg) = out["cpu"], out[str(cuda)]
    _lm_close(lg, lc, 1e-5, "loss")
    _lm_close(ag, ac, 1e-5, "aux")
    for k in gc_:
        _lm_close(gg[k], gc_[k], 1e-4, k)
    _lm_close(pg, pc, 1e-4, "prefill logits")
    for a, b in zip(dg, dc):
        _lm_close(a, b, 1e-4, "decode logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma3-27b"])
def test_lm_prefill_and_decode_match_forward_on_card(cuda, arch, dtype):
    """Prefill, then decode through the cache, against one forward over the
    whole sequence, all on the card: f32 within 1e-4 of the largest logit;
    bf16 activations within 5e-2 (the GEMM shapes differ, so bf16 roundings
    differ, and each moves the later layers)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(registry.get(arch).smoke_config(), dtype=dtype)
    model = tr.init_params(torch.Generator(device=cuda).manual_seed(3), cfg,
                           device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 80), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(4))
    with torch.no_grad():
        hidden, _ = tr.forward(model, toks, cfg)
        want = tr.logits_f32(model, hidden[:, 59:])
    logits, pcache = tr.prefill(model, toks[:, :60], cfg)
    cache = tr.init_cache(cfg, 2, 80, device=cuda)
    for n in cache:
        cache[n][:, :, :, :60] = pcache[n]
    got = [logits]
    for p in range(60, 80):
        got.append(tr.decode_step(model, cache, toks[:, p:p + 1], p, cfg)[0])
    tol = 1e-4 if dtype == "float32" else 5e-2
    _lm_close(torch.stack(got, 1), want, tol, f"{arch} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,cf", [(1, 0.5), (3, 0.5), (6, 1.25)])
def test_moe_layer_with_overflow_on_card_matches_cpu(cuda, dtype, top_k, cf):
    """``moe_layer`` on the card against the CPU, same inputs: the kept
    and dropped counts equal, the output within 1e-5 of the largest value
    in f32 and 2**-6 in bf16 (k expert outputs, each rounded), aux within
    1e-6."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(5)
    E, d, f = 16, 32, 24
    x = torch.randn((2, 64, d), generator=g).to(dtype)
    ws = [torch.randn(s, generator=g) / s[-2] ** 0.5
          for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]
    out = {}
    for dev in ("cpu", cuda):
        stats = []
        y, aux = layers.moe_layer(x.to(dev), *(w.to(dev) for w in ws),
                                  top_k=top_k, capacity_factor=cf,
                                  group_size=32, stats=stats)
        out[str(dev)] = (y.cpu(), aux.cpu(), stats[0])
    (yc, ac, sc), (yg, ag, sg) = out["cpu"], out[str(cuda)]
    assert torch.equal(sg["received"].cpu(), sc["received"])
    assert torch.equal(sg["dropped"].cpu(), sc["dropped"])
    if cf < 1:
        assert int(sc["dropped"].sum()) > 0
    _lm_close(yg, yc, 1e-5 if dtype == torch.float32 else 2.0 ** -6, "y")
    _lm_close(ag, ac, 1e-6, "aux")
