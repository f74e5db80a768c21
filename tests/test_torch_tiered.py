"""The port's hot/cold tiered store against the resident port and the JAX
package (the single-device cases of ``tests/test_tiered_store.py``).

* Within the port, bit for bit: a churn stream (insert, overwrite, delete,
  compact, query) through ``TieredSinnamonIndex`` and the resident
  ``SinnamonIndex`` in lockstep gives equal ids and scores for ``search``
  and ``search_many`` on every backend, with a cache of 1, 3 or all
  chunks; likewise across ``grow``; drift and compaction leave equal
  sketches; the staged serving path equals ``search_many``.
* Store mechanics: a chunk evicted just after it was written reads back
  its rows; a fully pinned cache falls back to the host gather; prefetch
  warms the cache; LFU evicts the cold chunk; an injected ``vecstore.read``
  fault maps nothing.
* Against the JAX package: one access sequence gives the same hits,
  misses, promotions, evictions and fallbacks in both ``TieredVecStore``s;
  the tiered port and the tiered JAX index give equal ids (scores within
  rtol = atol = 1e-5, kernel B's tolerance) and bit-equal sketch, bitmap
  and store leaves; durable tiered crash recovery, and snapshots that
  restore across tiered and resident, in both packages;
  ``open_index(device_budget_mb=...)``.
"""

import dataclasses

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.persist import durable as jdurable  # noqa: E402
from repro.storage import tiered as jtiered  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.fault import failpoints as tfp  # noqa: E402
from repro_torch.persist import durable  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402
from repro_torch.storage.tiered import TieredVecStore  # noqa: E402

BACKENDS = ("reference", "grouped", "fused")
N, MAX_NNZ, DOC_NNZ = 512, 16, 12


def _spec(capacity=96, m=24, pkg=eng):
    return pkg.EngineSpec(capacity=capacity, n=N, m=m, max_nnz=MAX_NNZ,
                          h=2, seed=7, value_dtype="float32")


def _tiered(spec, cache_chunks=2, cls=eng.TieredSinnamonIndex):
    return cls(spec, device="cpu", tier_chunk_slots=8,
               cache_chunks=cache_chunks)


def _docs(rng, B, nnz=DOC_NNZ):
    """Padded [B, MAX_NNZ] rows."""
    idx = np.full((B, MAX_NNZ), -1, np.int32)
    val = np.zeros((B, MAX_NNZ), np.float32)
    idx[:, :nnz] = np.stack([rng.choice(N, nnz, replace=False)
                             for _ in range(B)])
    val[:, :nnz] = rng.standard_normal((B, nnz)).astype(np.float32)
    return idx, val


def _assert_bitwise(a, b, msg):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]),
                                  err_msg=f"{msg}: ids")
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]),
                                  err_msg=f"{msg}: scores")


def _churn(indexes, rng, steps, check):
    """A random insert / overwrite / delete / compact / query stream through
    every index of ``indexes`` in lockstep; ``check(step, qi, qv)`` runs on
    each query step."""
    live, next_id = set(), 0
    for step in range(steps):
        op = rng.random()
        if op < 0.45 or len(live) < 10:
            ids = []
            for _ in range(int(rng.integers(1, 6))):
                if live and rng.random() < 0.3:     # overwrite in place
                    ids.append(int(rng.choice(sorted(live))))
                else:
                    ids.append(next_id)
                    next_id += 1
            di, dv = _docs(rng, len(ids))
            for ix in indexes:
                ix.insert_many(ids, di, dv)
            live.update(ids)
        elif op < 0.62 and len(live) > 5:
            doc = int(rng.choice(sorted(live)))
            for ix in indexes:
                ix.delete(doc)
            live.discard(doc)
        elif op < 0.72:
            assert len({ix.compact() for ix in indexes}) == 1
        else:
            qi, qv = _docs(rng, int(rng.integers(1, 4)))
            check(step, qi, qv)
    return live


# -- churn equivalence within the port ----------------------------------------

@pytest.mark.parametrize("cache_chunks,seed", [(1, 0), (3, 1), ("all", 2)])
def test_churn_equivalence_all_backends(cache_chunks, seed):
    """Tiered == resident (ids AND scores) under churn, with a cache so
    small every multi-chunk candidate set falls back, one that promotes
    and evicts, and one that holds the whole store."""
    rng = np.random.default_rng(seed)
    spec = _spec()
    resident = eng.SinnamonIndex(spec, device="cpu")
    chunks = spec.capacity // 8 if cache_chunks == "all" else cache_chunks
    tiered = _tiered(spec, chunks)

    def check(step, qi, qv):
        for backend in BACKENDS:
            _assert_bitwise(resident.search_many(qi, qv, k=5, backend=backend),
                            tiered.search_many(qi, qv, k=5, backend=backend),
                            f"step {step} search_many backend={backend}")
        _assert_bitwise(resident.search(qi[0], qv[0], k=5),
                        tiered.search(qi[0], qv[0], k=5),
                        f"step {step} search")
        # k' = 3 candidates span at most 3 chunks: they fit a 3-line cache
        _assert_bitwise(resident.search(qi[0], qv[0], k=2, kprime=3),
                        tiered.search(qi[0], qv[0], k=2, kprime=3),
                        f"step {step} search k'=3")

    _churn([resident, tiered], rng, 60, check)
    st = tiered.tiered.stats()
    assert st["promotions"] + st["fallbacks"] > 0, "cold path never exercised"
    assert st["resident_chunks"] <= chunks
    if cache_chunks == "all":
        assert st["fallbacks"] == 0 and st["promotions"] > 0
    if cache_chunks == 3:
        assert st["evictions"] > 0


def test_grow_keeps_equivalence():
    rng = np.random.default_rng(3)
    spec = _spec(capacity=32)
    resident = eng.SinnamonIndex(spec, device="cpu")
    tiered = _tiered(spec, 2)
    di, dv = _docs(rng, 30)
    resident.insert_many(list(range(30)), di, dv)
    tiered.insert_many(list(range(30)), di, dv)
    resident.grow(96)
    tiered.grow(96)
    assert tiered.tiered.capacity >= 96
    assert tiered.state.store.capacity == 0          # still a placeholder
    di2, dv2 = _docs(rng, 50)
    resident.insert_many(list(range(30, 80)), di2, dv2)
    tiered.insert_many(list(range(30, 80)), di2, dv2)   # auto-grows too
    assert tiered.spec.capacity == resident.spec.capacity == 96
    qi, qv = _docs(rng, 4)
    _assert_bitwise(resident.search_many(qi, qv, k=7),
                    tiered.search_many(qi, qv, k=7), "post-grow")


def test_drift_and_compaction_parity():
    rng = np.random.default_rng(4)
    spec = _spec()
    resident = eng.SinnamonIndex(spec, device="cpu")
    tiered = _tiered(spec, 1)
    tiered._MAINT_BLOCK = 4            # several maintenance blocks
    di, dv = _docs(rng, 60)
    resident.insert_many(list(range(60)), di, dv)
    tiered.insert_many(list(range(60)), di, dv)
    for doc in range(0, 30, 3):
        resident.delete(doc)
        tiered.delete(doc)
    tiered.delete_many([40, 41, 40])
    resident.delete_many([40, 41])
    di2, dv2 = _docs(rng, 10)
    resident.insert_many(list(range(100, 110)), di2, dv2)
    tiered.insert_many(list(range(100, 110)), di2, dv2)

    dirty = resident.state.dirty.numpy()
    assert dirty.sum() > 4
    # the rows form of the compaction, on a copy of the resident state:
    # the dirty slots' rows (and two masked-off ones) give compact_state's
    # cells
    st = eng.SinnamonState(**{f: getattr(resident.state, f).clone()
                              if f not in ("store", "m") else
                              getattr(resident.state, f)
                              for f in ("mappings", "sketch", "bits", "store",
                                        "active", "ids", "dirty", "m")})
    slots = torch.cat([torch.from_numpy(np.flatnonzero(dirty)),
                       torch.tensor([1, 2])]).int()
    mask = torch.ones(slots.shape, dtype=torch.bool)
    mask[-2:] = False
    rows = resident.state.store.indices[slots.long()]
    vals = resident.state.store.values[slots.long()]
    eng.compact_slots_rows(st, spec, slots, rows, vals, mask)
    want = eng.compact_state(eng.SinnamonState(
        **{**st.__dict__, "sketch": resident.state.sketch.clone(),
           "dirty": resident.state.dirty.clone()}), spec)
    assert torch.equal(st.sketch.view(torch.int16),
                       want.sketch.view(torch.int16))
    assert not st.dirty.any()
    np.testing.assert_array_equal(resident.slot_drift()[dirty],
                                  tiered.slot_drift()[dirty])
    assert (tiered.slot_drift()[~dirty] == 0).all()
    assert resident.compact() == tiered.compact()
    for name in ("sketch", "bits", "active", "ids", "dirty"):
        a, b = getattr(resident.state, name), getattr(tiered.state, name)
        assert torch.equal(a.view(torch.int32) if name == "sketch" else a,
                           b.view(torch.int32) if name == "sketch" else b), \
            name
    leaves = convert.state_to_numpy(tiered.logical_state(), tiered.spec)
    want = convert.state_to_numpy(resident.state, resident.spec)
    for k in want:
        np.testing.assert_array_equal(leaves[k], want[k], err_msg=k)


def test_staged_serving_path_equals_search_many():
    rng = np.random.default_rng(12)
    spec = _spec()
    tiered = _tiered(spec, 4)
    di, dv = _docs(rng, 80)
    tiered.insert_many(list(range(80)), di, dv)
    qi, qv = _docs(rng, 5)
    staged = QueryServer(tiered, k=5, kprime=20, trace_every=1)
    res = staged.query_many(qi, qv)
    assert [s.name for s in staged.last_trace.spans] == \
        ["admission", "sketch_scan", "prefetch", "rerank"]
    _assert_bitwise((res.ids, res.scores),
                    tiered.search_many(qi, qv, k=5, kprime=20), "staged")
    sketch_only = QueryServer(tiered, k=5, kprime=20).query_many(
        qi, qv, degrade=2)
    assert sketch_only.degraded and sketch_only.ids.shape == (5, 5)
    mem = tiered.memory_bytes()
    assert mem["storage"] == tiered.tiered.device_bytes() == 4 * 8 * 16 * 8
    assert mem["storage_host"] == tiered.tiered.host_bytes()


# -- store mechanics ----------------------------------------------------------

def _store(cache_chunks, rows=None):
    store = TieredVecStore(64, MAX_NNZ, value_dtype="float32", chunk_slots=8,
                           cache_chunks=cache_chunks)
    if rows is not None:
        store.load_rows(*rows)
    return store


def test_evict_just_written_chunk_roundtrips():
    rng = np.random.default_rng(5)
    store = _store(1)
    store.gather_rows(np.arange(8))                 # chunk 0 resident
    di, dv = _docs(rng, 8)
    store.write_rows(np.arange(8), di, dv)          # patches the device line
    ri, rv = store.gather_rows(np.arange(8))        # a hit: the patched line
    np.testing.assert_array_equal(ri.numpy(), di)
    before = store.stats()["evictions"]
    store.gather_rows(np.arange(48, 56))            # chunk 6 evicts chunk 0
    assert store.stats()["evictions"] > before
    ri, rv = store.gather_rows(np.arange(8))        # cold re-promotion
    np.testing.assert_array_equal(ri.numpy(), di)
    np.testing.assert_array_equal(rv.float().numpy(), dv)


def test_fully_pinned_cache_falls_back_to_host_gather():
    rng = np.random.default_rng(6)
    di, dv = _docs(rng, 64)
    store = _store(2, (di, dv))
    store.gather_rows(np.arange(0, 16))             # chunks 0, 1 resident
    with store.pinning(np.arange(0, 16)):
        before = store.stats()
        ri, rv = store.gather_rows(np.arange(24, 40))   # needs chunks 3, 4
        after = store.stats()
        assert after["fallbacks"] == before["fallbacks"] + 1
        assert after["resident_chunks"] == 2        # nothing evicted
    np.testing.assert_array_equal(ri.numpy(), di[24:40])
    np.testing.assert_array_equal(rv.float().numpy(), dv[24:40])
    store.gather_rows(np.arange(24, 32))            # unpinned: promotes
    assert store.stats()["promotions"] > before["promotions"]


def test_prefetch_warms_then_hits():
    rng = np.random.default_rng(7)
    store = _store(4, _docs(rng, 64))
    assert store.prefetch(np.arange(0, 24)) == 3    # chunks 0..2 promoted
    before = store.stats()
    store.gather_rows(np.arange(0, 24))
    after = store.stats()
    assert after["misses"] == before["misses"]
    assert after["promotions"] == before["promotions"]
    assert after["prefetched"] == 3


def test_lfu_evicts_the_cold_chunk():
    rng = np.random.default_rng(8)
    store = _store(2, _docs(rng, 64))
    for _ in range(5):
        store.gather_rows(np.arange(0, 8))          # chunk 0 hot
    store.gather_rows(np.arange(8, 16))             # chunk 1: one access
    store.gather_rows(np.arange(16, 24))            # chunk 2 evicts chunk 1
    p = store.stats()["promotions"]
    store.gather_rows(np.arange(0, 8))              # hot chunk: still a hit
    assert store.stats()["promotions"] == p
    store.gather_rows(np.arange(8, 16))             # chunk 1: cold again
    assert store.stats()["promotions"] == p + 1


def test_injected_read_fault_maps_nothing():
    rng = np.random.default_rng(9)
    di, dv = _docs(rng, 64)
    store = _store(2, (di, dv))
    reg = tfp.FailpointRegistry().configure("vecstore.read=error")
    prev = tfp.set_failpoints(reg)
    try:
        with pytest.raises(tfp.InjectedError):
            store.gather_rows(np.arange(0, 8))
    finally:
        tfp.set_failpoints(prev)
    assert store.resident_chunks() == 0
    assert (store._line_by_chunk < 0).all()
    ri, _ = store.gather_rows(np.arange(0, 8))
    np.testing.assert_array_equal(ri.numpy(), di[:8])


# -- against the JAX package --------------------------------------------------

def test_access_sequence_matches_reference_store():
    """One access sequence (gathers, prefetches, writes, pins) through both
    packages' stores: the same counters and chunk -> line map after every
    step, the same rows.  Each gather or prefetch names one chunk, or all
    eight (more than the cache holds: a fallback), so the reference's LFU
    never meets a resident chunk of its own request (ROADMAP Queue 3,
    item 3; ``test_gather_never_evicts_its_own_chunks``)."""
    rng = np.random.default_rng(10)
    di, dv = _docs(rng, 64)
    jstore = jtiered.TieredVecStore(64, MAX_NNZ, value_dtype="float32",
                                    chunk_slots=8, cache_chunks=3,
                                    aging_every=16)
    tstore = TieredVecStore(64, MAX_NNZ, value_dtype="float32",
                            chunk_slots=8, cache_chunks=3, aging_every=16)
    jstore.load_rows(di, dv)
    tstore.load_rows(di, dv)
    keys = ("hits", "misses", "promotions", "evictions", "prefetched",
            "fallbacks", "resident_chunks")
    for step in range(80):
        op = rng.random()
        chunk = int(rng.integers(0, 8))
        slots = chunk * 8 + rng.integers(0, 8, int(rng.integers(1, 6)))
        if rng.random() < 0.2:
            slots = rng.integers(0, 64, 40)          # every chunk
        if op < 0.6:
            jr, tr = jstore.gather_rows(slots), tstore.gather_rows(slots)
            np.testing.assert_array_equal(np.asarray(jr[0]), tr[0].numpy())
            np.testing.assert_array_equal(np.asarray(jr[1], np.float32),
                                          tr[1].float().numpy())
        elif op < 0.75:
            assert jstore.prefetch(slots) == tstore.prefetch(slots)
        elif op < 0.9:
            wi, wv = _docs(rng, slots.size)
            jstore.write_rows(slots, wi, wv)
            tstore.write_rows(slots, wi, wv)
        else:
            with jstore.pinning(slots), tstore.pinning(slots):
                q = int(rng.integers(0, 8)) * 8 + np.arange(8)
                jstore.gather_rows(q)
                tstore.gather_rows(q)
        js, ts = jstore.stats(), tstore.stats()
        assert {k: js[k] for k in keys} == {k: ts[k] for k in keys}, step
        np.testing.assert_array_equal(jstore._line_by_chunk,
                                      tstore._line_by_chunk)
    assert ts["evictions"] > 0 and ts["fallbacks"] > 0


def test_gather_never_evicts_its_own_chunks():
    """Pins ROADMAP Queue 3 item 3: a gather naming a resident chunk (the
    LFU one) and a cold one.  The reference evicts the resident chunk to
    make room and reads its rows through the unmapped line; the port keeps
    a request's own chunks, evicts the other one and returns the rows."""
    rng = np.random.default_rng(19)
    di, dv = _docs(rng, 64)
    store = _store(2, (di, dv))
    store.gather_rows(np.arange(0, 8))              # chunk 0: one access
    for _ in range(3):
        store.gather_rows(np.arange(8, 16))         # chunk 1: hot
    slots = np.array([0, 1, 16, 17])                # chunks 0 and 2
    ri, rv = store.gather_rows(slots)
    np.testing.assert_array_equal(ri.numpy(), di[slots])
    np.testing.assert_array_equal(rv.float().numpy(), dv[slots])
    assert store.stats()["evictions"] == 1
    assert store._line_by_chunk[1] < 0 <= store._line_by_chunk[0]


def _jax_leaves(index):
    st = index.logical_state() if hasattr(index, "logical_state") \
        else index.state
    return jckpt._flatten(st)


def test_tiered_port_matches_tiered_jax():
    rng = np.random.default_rng(11)
    jt = jeng.TieredSinnamonIndex(_spec(pkg=jeng), tier_chunk_slots=8,
                                  cache_chunks=3)
    tt = _tiered(_spec(), 3)

    def check(step, qi, qv):
        j_ids, j_sc = jt.search_many(qi, qv, k=5, backend="reference")
        t_ids, t_sc = tt.search_many(qi, qv, k=5)
        np.testing.assert_array_equal(t_ids, j_ids, err_msg=f"step {step}")
        np.testing.assert_allclose(t_sc, j_sc, rtol=1e-5, atol=1e-5)

    # JAX's single-query path deletes one by one: keep to the batched ops
    _churn([jt, tt], rng, 40, check)
    tl = convert.state_to_numpy(tt.logical_state(), tt.spec)
    jl = _jax_leaves(jt)
    for k in (".u", ".l", ".bits", ".store/.indices", ".store/.values",
              ".active", ".ids", ".dirty"):
        np.testing.assert_array_equal(tl[k], np.asarray(jl[k]), err_msg=k)
    js, ts = jt.tiered.stats(), tt.tiered.stats()
    assert (ts["hits"], ts["misses"]) == (js["hits"], js["misses"])


def _drive(ix, rng, steps=30):
    live, nid = [], 0
    for _ in range(steps):
        op = rng.random()
        if op < 0.55 or len(live) < 8:
            B = int(rng.integers(1, 4))
            ids = list(range(nid, nid + B))
            nid += B
            di, dv = _docs(rng, B)
            ix.insert_many(ids, di, dv)
            live += ids
        elif op < 0.72 and len(live) > 4:
            ix.delete(live.pop(int(rng.integers(len(live)))))
        elif op < 0.82:
            ix.compact()
    return live


def _assert_logical_equal(a, b):
    la = convert.state_to_numpy(a.logical_state(), a.spec)
    lb = convert.state_to_numpy(b.logical_state(), b.spec)
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_durable_tiered_crash_recovery_and_cross_restore(tmp_path):
    spec = _spec(capacity=64)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    kw = dict(wal_dir=wd, snapshot_dir=sd, tier_chunk_slots=8,
              cache_chunks=2, fsync=False, device="cpu")
    t = durable.DurableTieredSinnamonIndex.open(spec, **kw)
    rng = np.random.default_rng(11)
    _drive(t, rng)
    t.snapshot()
    _drive(t, rng)                                  # WAL tail past snapshot
    qi, qv = _docs(rng, 6)
    want = t.search_many(qi, qv, k=5)
    del t                                           # crash

    r = durable.DurableTieredSinnamonIndex.open(spec, **kw)
    _assert_bitwise(want, r.search_many(qi, qv, k=5), "recovery")
    assert r.tiered.resident_chunks() == 0 or r.tiered.stats()["hits"] >= 0
    # the same WAL + snapshot restores into a resident durable index
    r2 = durable.DurableSinnamonIndex.open(spec, wal_dir=wd,
                                           snapshot_dir=sd, fsync=False,
                                           device="cpu")
    _assert_bitwise(want, r2.search_many(qi, qv, k=5), "into resident")
    _assert_logical_equal(r, r2)
    assert r._id2slot == r2._id2slot and r._free == r2._free
    # the optimistic compaction on the tiered wrapper
    r.try_compact_async()
    r2.try_compact_async()
    _assert_bitwise(want, r.search_many(qi, qv, k=5), "post-compact")
    _assert_logical_equal(r, r2)


def test_resident_snapshot_restores_into_tiered(tmp_path):
    spec = _spec(capacity=64)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    res = durable.DurableSinnamonIndex.open(spec, wal_dir=wd,
                                            snapshot_dir=sd, fsync=False,
                                            device="cpu")
    _drive(res, np.random.default_rng(13))
    res.snapshot()
    _drive(res, np.random.default_rng(14), steps=10)
    qi, qv = _docs(np.random.default_rng(15), 4)
    want = res.search_many(qi, qv, k=5)
    tier = durable.DurableTieredSinnamonIndex.open(
        spec, wal_dir=wd, snapshot_dir=sd, fsync=False, device="cpu",
        tier_chunk_slots=8, cache_chunks=1)
    _assert_bitwise(want, tier.search_many(qi, qv, k=5), "resident->tiered")
    _assert_logical_equal(res, tier)
    assert tier.state.store.capacity == 0


@pytest.mark.parametrize("writer", ["jax_tiered", "jax_resident"])
def test_jax_snapshot_restores_into_port_tiered(tmp_path, writer):
    spec = _spec(capacity=64, pkg=jeng)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    if writer == "jax_tiered":
        j = jdurable.DurableTieredSinnamonIndex.open(
            spec, wal_dir=wd, snapshot_dir=sd, tier_chunk_slots=8,
            cache_chunks=2, fsync=False)
    else:
        j = jdurable.DurableSinnamonIndex.open(spec, wal_dir=wd,
                                               snapshot_dir=sd, fsync=False)
    rng = np.random.default_rng(16)
    _drive(j, rng)
    j.snapshot()
    _drive(j, rng, steps=10)
    qi, qv = _docs(rng, 5)
    j_ids, j_sc = j.search_many(qi, qv, k=5, backend="reference")
    t = durable.DurableTieredSinnamonIndex.open(
        _spec(capacity=64), wal_dir=wd, snapshot_dir=sd, fsync=False,
        device="cpu", tier_chunk_slots=8, cache_chunks=2)
    t_ids, t_sc = t.search_many(qi, qv, k=5)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=1e-5, atol=1e-5)
    tl = convert.state_to_numpy(t.logical_state(), t.spec)
    jl = _jax_leaves(j)
    for k in tl:
        np.testing.assert_array_equal(tl[k], np.asarray(jl[k]), err_msg=k)
    assert t._id2slot == j._id2slot and t._free == j._free


def test_port_tiered_snapshot_restores_in_jax(tmp_path):
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    t = durable.DurableTieredSinnamonIndex.open(
        _spec(capacity=64), wal_dir=wd, snapshot_dir=sd, fsync=False,
        device="cpu", tier_chunk_slots=8, cache_chunks=2)
    rng = np.random.default_rng(17)
    _drive(t, rng)
    t.snapshot()
    _drive(t, rng, steps=10)
    qi, qv = _docs(rng, 5)
    t_ids, t_sc = t.search_many(qi, qv, k=5)
    for cls, kw in ((jdurable.DurableTieredSinnamonIndex,
                     dict(tier_chunk_slots=8, cache_chunks=2)),
                    (jdurable.DurableSinnamonIndex, {})):
        j = cls.open(_spec(capacity=64, pkg=jeng), wal_dir=wd,
                     snapshot_dir=sd, fsync=False, **kw)
        j_ids, j_sc = j.search_many(qi, qv, k=5, backend="reference")
        np.testing.assert_array_equal(j_ids, t_ids, err_msg=cls.__name__)
        np.testing.assert_allclose(t_sc, j_sc, rtol=1e-5, atol=1e-5)
        jl = _jax_leaves(j)
        tl = convert.state_to_numpy(t.logical_state(), t.spec)
        for k in tl:
            np.testing.assert_array_equal(tl[k], np.asarray(jl[k]),
                                          err_msg=k)


# -- open_index -----------------------------------------------------------------

def test_open_index_routes_device_budget(tmp_path):
    cfg = tapi.IndexConfig(n=N, capacity=64, m=24, max_nnz=MAX_NNZ,
                           store_dtype="float32", device_budget_mb=0.01,
                           tier_chunk_slots=8)
    index = tapi.open_index(cfg, device="cpu")
    assert type(index) is eng.TieredSinnamonIndex
    assert index.tiered.cache_chunks == int(0.01 * 2**20) // (8 * 16 * 8)
    assert index.config is cfg
    dcfg = tapi.IndexConfig(
        n=N, capacity=64, m=24, max_nnz=MAX_NNZ, store_dtype="float32",
        device_budget_mb=0.01, tier_chunk_slots=8,
        durability=tapi.DurabilityConfig(wal_dir=str(tmp_path / "w"),
                                         fsync=False))
    dindex = tapi.open_index(dcfg, device="cpu")
    assert type(dindex) is durable.DurableTieredSinnamonIndex
    rng = np.random.default_rng(18)
    di, dv = _docs(rng, 20)
    dindex.insert_many(list(range(20)), di, dv)
    again = tapi.open_index(dcfg, device="cpu")
    assert again.size == 20
    qi, qv = _docs(rng, 3)
    _assert_bitwise(dindex.search_many(qi, qv, k=5),
                    again.search_many(qi, qv, k=5), "reopened")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.open_index(cfg)
    from repro_torch.serving.sharded import TieredShardedSinnamonIndex
    sharded = tapi.open_index(tapi.IndexConfig(n=N, capacity=64, shards=2,
                                               device_budget_mb=1.0),
                              device="cpu")
    assert type(sharded) is TieredShardedSinnamonIndex
    with pytest.raises(NotImplementedError, match="durability"):
        tapi.open_index(dataclasses.replace(dcfg, shards=2), device="cpu")
    for bad in (dict(device_budget_mb=0.0), dict(tier_chunk_slots=0)):
        with pytest.raises(ValueError):
            tapi.IndexConfig(n=N, capacity=64, **bad)
