"""Two-pass candidate selection (``sinnamon_score.candidate_scan``) on the
CPU, through the plain twins: a strided sample of tiles in kernel A's top-k
form, then its threshold form over the other tiles.  The answer must equal
the single pass, ``merge_tile_topk`` of ``sinnamon_score_topk_plain``, bit
for bit.  The twins' ``tile_c`` gives many tiles at a small capacity; the
card's kernels are held to the same twins in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sinnamon_score as sinn  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402

TILE = 32                      # the twins' tile: 160 tiles at 5,120 slots
CAPACITY = 160 * TILE


def _random_operands(rng, B, L, C, density, ok_share=0.8, m=8, nrows=20):
    qv = rng.normal(0, 1, (B, L)).astype(np.float32)
    qv[:, -1] = 0.0
    rows = rng.integers(0, m, (B, L, 1)).astype(np.int32)
    rows = np.where((qv > 0)[..., None], rows, rows + m).astype(np.int32)
    brows = rng.integers(-1, nrows, (B, L)).astype(np.int32)
    on = rng.random((nrows, C // 32, 32)) < density
    bits = np.packbits(on, axis=-1, bitorder="little").view("<u4")[..., 0]
    ok = rng.random(C) < ok_share
    sk = rng.normal(0, 1, (2 * m, C)).astype(np.float32)
    return [torch.from_numpy(x) for x in (qv, rows, brows,
                                          bits.astype(np.int32), ok, sk)]


def _small_index(B, delete_share=0.0):
    """A CPU engine index of ``CAPACITY`` documents, every
    ``1 / delete_share``-th deleted, and B queries."""
    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=20, psi_query=8)
    idx, val = synth.make_corpus(1, ds, CAPACITY, pad=32)
    qi, qv = synth.make_queries(2, ds, B, pad=16)
    spec = teng.EngineSpec(n=500, m=16, h=1, capacity=CAPACITY, max_nnz=32,
                           seed=3)
    index = teng.SinnamonIndex(spec, "cpu")
    index.insert_many(list(range(CAPACITY)), idx, val)
    if delete_share:
        index.delete_many(list(range(0, CAPACITY, int(1 / delete_share))))
    return index, torch.as_tensor(qi), torch.as_tensor(qv)


def _index_operands(rng, B, budget=None, delete_share=0.0, filter_share=None):
    """Operands of :func:`_small_index` as the fused path prepares them;
    ``ok`` the live slots and, with ``filter_share``, a random filter."""
    index, qi, qv = _small_index(B, delete_share)
    st = index.state
    q, rows, brows, skmat, one_sided = ops.prepare_fused_operands(
        st, index.spec, qi, qv, budget)
    ok = st.active
    if filter_share is not None:
        ok = ok & torch.from_numpy(rng.random(CAPACITY) < filter_share)
    assert one_sided
    return [q, rows, brows, st.bits, ok.contiguous(), skmat]


def _gate_sample(ops_, live_tiles):
    """Gate every sample tile (tiles 0, s, 2 s, ...) but the first
    ``live_tiles``, so the sample holds few live slots."""
    ok = ops_[4].clone()
    s = sinn.SAMPLE_STRIDE
    for t in range(live_tiles * s, CAPACITY // TILE, s):
        ok[t * TILE:(t + 1) * TILE] = False
    ops_[4] = ok
    return ops_


# (operands, k', two passes taken, fallbacks)
CASES = {
    "random": (lambda r: _random_operands(r, 256, 6, CAPACITY, 0.3),
               50, 1, 0),
    # 1 bit in 256: most slots score exactly +0.0, so the sample's k'-th
    # key is a +0.0 key and the survivors are decided by slot order
    "ties_at_zero": (lambda r: _random_operands(r, 256, 6, CAPACITY,
                                                1 / 256), 50, 1, 0),
    "gated_and_deleted": (lambda r: _index_operands(r, 256,
                                                    delete_share=1 / 3),
                          40, 1, 0),
    "filter_mask": (lambda r: _index_operands(r, 256, filter_share=0.5),
                    40, 1, 0),
    "budget": (lambda r: _index_operands(r, 256, budget=3), 40, 1, 0),
    # k' = 80 over tiles of 32: kp = 32, the sample's 5 tiles hold 160
    "kprime_over_tile": (lambda r: _random_operands(r, 256, 6, CAPACITY,
                                                    0.3), 80, 1, 0),
    # one live sample tile of 0.8 * 32 slots < k': the bound is gated
    "sample_short_of_kprime": (lambda r: _gate_sample(
        _random_operands(r, 256, 6, CAPACITY, 0.3), 1), 40, 1, 1),
    "cap_forced_small": (lambda r: _random_operands(r, 256, 6, CAPACITY,
                                                    0.3), 50, 1, 1),
    # 8 queries x 160 tiles is under the cut: one pass, nothing counted
    "under_the_cut": (lambda r: _random_operands(r, 8, 6, CAPACITY, 0.3),
                      50, 0, 0),
}


def _select(args, kprime, stride=None):
    """``ops.fused_candidates``' steps on raw operands: the passes
    (``stride`` None: as the cut picks), the merge, and the single pass
    where the flag is set."""
    kw = dict(kprime=kprime, tile_c=TILE)
    if stride is None:
        keys, flag = sinn.candidate_scan(*args, **kw)
    else:
        keys, flag = sinn._scan(args, kprime, stride,
                                dict(one_sided=True, use_kernel=None,
                                     tile_c=TILE))
    if flag is not None and int(flag):
        keys = sinn.rescan(*args, **kw)
    return sinn.merge_keys(keys, kprime)


@pytest.mark.parametrize("case", list(CASES))
def test_two_pass_bit_equal_to_single_pass(rng, monkeypatch, case):
    make, kprime, two_pass, fallbacks = CASES[case]
    args = make(rng)
    if case == "cap_forced_small":
        monkeypatch.setattr(sinn, "survivor_cap", lambda kprime, stride: 3)
    p0, f0 = sinn.candidate_scan.two_pass, sinn.candidate_scan.fallbacks
    vals, slots = _select(args, kprime)
    assert sinn.candidate_scan.two_pass - p0 == two_pass
    assert sinn.candidate_scan.fallbacks - f0 == fallbacks
    tv, ts = sinn.sinnamon_score_topk_plain(*args, kp=min(kprime, TILE),
                                            tile_c=TILE)
    want_v, want_s = sinn.merge_tile_topk(tv, ts, kprime)
    assert torch.equal(slots, want_s)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))
    assert slots.shape == (args[0].shape[0], kprime)


def test_two_passes_forced_under_the_cut(rng):
    """A batch under the cut, given the sample's stride, takes the two
    passes and gives the single pass's answer."""
    args = _random_operands(rng, 8, 6, CAPACITY, 0.3)
    p0 = sinn.candidate_scan.two_pass
    vals, slots = _select(args, 50, sinn.SAMPLE_STRIDE)
    assert sinn.candidate_scan.two_pass - p0 == 1
    want_v, want_s = sinn.merge_tile_topk(
        *sinn.sinnamon_score_topk_plain(*args, kp=min(50, TILE),
                                        tile_c=TILE), 50)
    assert torch.equal(slots, want_s) and torch.equal(vals, want_v)


def test_threshold_twin_counts_and_flags(rng):
    """The threshold form's twin: survivors are the keys below the bound
    outside the sample, in key order after the head; counts past ``cap``
    and gated bounds raise the flag."""
    args = _random_operands(rng, 4, 6, CAPACITY, 0.3)
    s = sinn.SAMPLE_STRIDE
    acc = sinn.sinnamon_score_plain(*args[:4], args[5])
    score = torch.where(args[4][None, :], acc, -torch.inf)
    key = sinn.order_key(score, torch.arange(CAPACITY).expand(4, -1))
    rest = (torch.arange(CAPACITY) // TILE) % s != 0
    theta = torch.stack([key[b][~rest].sort().values[30] for b in range(4)])
    theta[2] = sinn.GATED_KEY + 7
    head = torch.arange(8, dtype=torch.int64).expand(4, -1).contiguous()
    keys, counts, flag = sinn.sinnamon_score_threshold(
        *args, theta, head, stride=s, cap=10_000, tile_c=TILE)
    assert torch.equal(keys[:, :8], head)
    for b in range(4):
        want = key[b][rest & (key[b] < theta[b])].sort().values
        if b == 2:
            want = want[:0]
        n = want.numel()
        assert int(counts[b]) == n
        assert torch.equal(keys[b, 8:8 + n], want)
        assert bool((keys[b, 8 + n:] == sinn.KEY_PAD).all())
    assert int(flag) == 1                          # query 2's gated bound
    theta[2] = theta[1]
    _, counts, flag = sinn.sinnamon_score_threshold(
        *args, theta, head, stride=s, cap=10_000, tile_c=TILE)
    assert int(flag) == 0
    _, _, flag = sinn.sinnamon_score_threshold(
        *args, theta, head, stride=s, cap=int(counts.max()) - 1, tile_c=TILE)
    assert int(flag) == 1


@pytest.mark.parametrize("B,T,kprime,want", [
    (256, 1_088, 800, sinn.SAMPLE_STRIDE),      # the cell's batch
    (256, 136, 800, sinn.SAMPLE_STRIDE),        # one shard at B=256
    (16, 136, 800, 0),                          # the front door's shard
    (32, 136, 800, sinn.SAMPLE_STRIDE),         # over the cut: 4,352 blocks
    (16, 1_088, 800, sinn.SAMPLE_STRIDE),
    (1_024, 2 * sinn.SAMPLE_STRIDE - 1, 800, 0),  # too few tiles
    (256, 40, 8_192 * 3 + 1, 0),                # a sample short of k'
    (0, 1_088, 800, 0),
])
def test_two_pass_cut(B, T, kprime, want):
    assert sinn.two_pass_stride(B, T, kprime) == want


def _small_tiles(monkeypatch, cap=None):
    """Route the fused path's ``candidate_scan`` through the twins' 32-slot
    tiles (so a small index takes the two passes), with a survivor cap of
    ``cap`` where given; returns the stand-in, which counts as the real
    one does."""
    orig = sinn.candidate_scan

    def small_tiles(*a, **kw):
        return orig(*a, tile_c=TILE, **kw)

    small_tiles.two_pass = small_tiles.fallbacks = 0
    monkeypatch.setattr(sinn, "candidate_scan", small_tiles)
    if cap is not None:
        monkeypatch.setattr(sinn, "survivor_cap", lambda kprime, stride: cap)
    return small_tiles


@pytest.mark.parametrize("kind", ["timed", "synced"])
def test_fallback_span(rng, monkeypatch, kind):
    """``engine.topk_candidates``: a fallback runs in its own
    ``fallback_scan`` span of a device-timed trace, and in ``topk_merge``
    of a synced (staged) one; the answer is the single pass's either
    way."""
    index, qi, qv = _small_index(256)
    scan = _small_tiles(monkeypatch, cap=3)
    tr = otrace.Trace("query", torch.device("cpu"),
                      device_timed=kind == "timed")
    vals, slots = teng.topk_candidates(index.state, index.spec, qi, qv, 40,
                                       backend="fused", trace=tr)
    assert scan.two_pass == 1 and scan.fallbacks == 1
    names = [s.name for s in tr.spans]
    if kind == "timed":
        assert names == ["sketch_scan", "topk_merge", "fallback_scan"]
    else:
        assert names == ["sketch_scan", "topk_merge", "topk_merge"]
    q, rows, brows, skmat, _ = ops.prepare_fused_operands(
        index.state, index.spec, qi, qv)
    tv, ts = sinn.sinnamon_score_topk_plain(
        q, rows, brows, index.state.bits, index.state.active, skmat,
        kp=min(40, TILE), tile_c=TILE)
    want_v, want_s = sinn.merge_tile_topk(tv, ts, 40)
    assert torch.equal(slots, want_s) and torch.equal(vals, want_v)


def _count_flag_reads(monkeypatch, scan):
    """Wrap ``ops.flagged``: each call records how many batches had taken
    the two passes by then."""
    reads, orig = [], ops.flagged

    def counted(cands):
        reads.append(scan.two_pass)
        return orig(cands)

    monkeypatch.setattr(ops, "flagged", counted)
    return reads


@pytest.mark.parametrize("cap", [None, 3])
def test_search_batch_reads_the_flag_after_the_rerank(monkeypatch, cap):
    """``engine.search_batch`` issues the rerank before it reads the flag
    (once); a flagged batch redoes the candidates and the rerank in
    ``fallback_scan``.  The answer is the single pass's either way."""
    index, qi, qv = _small_index(256)
    want = teng.search_batch(index.state, index.spec, qi, qv, 10, 40,
                             backend="fused")
    scan = _small_tiles(monkeypatch, cap)
    reads = _count_flag_reads(monkeypatch, scan)
    tr = otrace.Trace("query", torch.device("cpu"), device_timed=True)
    got = teng.search_batch(index.state, index.spec, qi, qv, 10, 40,
                            backend="fused", trace=tr)
    assert reads == [1] and scan.fallbacks == (cap is not None)
    assert [s.name for s in tr.spans] == (
        ["sketch_scan", "topk_merge", "rerank"]
        + ["fallback_scan"] * (cap is not None))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tiered", [False, True])
@pytest.mark.parametrize("cap", [None, 3])
def test_sharded_issues_every_shard_before_the_flags(monkeypatch, tiered,
                                                     cap):
    """A sharded index issues every shard's candidates before it reads the
    flags, in one read; a flagged shard is redone in one pass.  The
    answer is the single pass's either way."""
    from repro_torch.serving import sharded

    S = 2
    ds = synth.SparseDatasetSpec("t", n=500, psi_doc=20, psi_query=8)
    idx, val = synth.make_corpus(1, ds, 6_000, pad=32)
    qi, qv = synth.make_queries(2, ds, 256, pad=16)
    spec = teng.EngineSpec(n=500, m=16, h=1, capacity=CAPACITY, max_nnz=32,
                           seed=3)
    if tiered:
        index = sharded.TieredShardedSinnamonIndex(spec, "cpu", n_shards=S,
                                                   cache_chunks=8)
    else:
        index = sharded.ShardedSinnamonIndex(spec, "cpu", n_shards=S)
    index.insert_many(list(range(6_000)), idx, val)
    want = index.search_many(qi, qv, 10, kprime=40, backend="fused")
    scan = _small_tiles(monkeypatch, cap)
    reads = _count_flag_reads(monkeypatch, scan)
    got = index.search_many(qi, qv, 10, kprime=40, backend="fused")
    assert reads == [S] and scan.fallbacks == S * (cap is not None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
