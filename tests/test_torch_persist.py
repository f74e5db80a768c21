"""Durability parity: ``repro_torch.persist`` against ``repro.persist``.

* Snapshots and WALs recover across the two packages in both directions,
  bit for bit in every state leaf (the reference's snapshot leaves, as
  ``repro.checkpoint.ckpt`` flattens the JAX state), the free list and the
  id map; searches give the same ids.  The port's batched ``delete_many``
  (one KIND_DELETE record) recovers in JAX to the port's state.
* A JAX sharded-kind snapshot with one shard restores elastically into
  the port, to the state JAX's own single-device restore reaches.
* The single-device crash/recover cases of ``tests/test_persist_recovery.py``
  hold for the port (same names, same inputs).
* The checkpoint layout, the spec recipe, the optimistic compaction and
  the launcher's recovery run.
"""

import dataclasses
import json
import os
import shutil
import threading

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import synth  # noqa: E402
from repro.distributed import mesh as meshlib  # noqa: E402
from repro.persist import snapshot as jsnap  # noqa: E402
from repro.persist.durable import DurableShardedSinnamonIndex  # noqa: E402
from repro.persist.durable import DurableSinnamonIndex as JDurable  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.fault import failpoints as tfp  # noqa: E402
from repro_torch.persist import compact  # noqa: E402
from repro_torch.persist import snapshot as snaplib  # noqa: E402
from repro_torch.persist import wal  # noqa: E402
from repro_torch.persist.durable import DurableSinnamonIndex  # noqa: E402

DS = synth.SparseDatasetSpec("t", n=300, psi_doc=16, psi_query=8,
                             value_dist="gaussian")
N_DOCS = 96


def _spec(capacity=96, pkg=teng, **kw):
    return pkg.EngineSpec(**{**dict(n=DS.n, m=12, capacity=capacity,
                                    max_nnz=32, h=2, seed=3,
                                    value_dtype="float32"), **kw})


def _open(wd, sd=None, capacity=96, **kw):
    return DurableSinnamonIndex.open(_spec(capacity), wal_dir=wd,
                                     snapshot_dir=sd, device="cpu", **kw)


def _leaves(index) -> dict:
    """The snapshot leaves of either package's live state."""
    if isinstance(index, teng.SinnamonIndex):
        return convert.state_to_numpy(index.state, index.spec)
    return jckpt._flatten(index.state)


def _assert_state_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _assert_search_identical(a, b, nq=4, k=10, kprime=40):
    qi, qv = synth.make_queries(11, DS, nq, pad=16)
    for q in range(nq):
        ids_a, sc_a = a.search(qi[q], qv[q], k=k, kprime=kprime)
        ids_b, sc_b = b.search(qi[q], qv[q], k=k, kprime=kprime)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_array_equal(sc_a, sc_b)


def _stream(index, idx, val):
    """Inserts + snapshot-while-inserting + deletes + recycling re-inserts
    (tests/test_persist_recovery.py::_stream)."""
    index.insert_many(list(range(48)), idx[:48], val[:48])
    index.snapshot()                       # snapshot mid-insert-stream
    index.insert_many(list(range(48, 80)), idx[48:80], val[48:80])
    for e in (3, 17, 48):
        index.delete(e)
    index.insert_many(list(range(80, N_DOCS)), idx[80:], val[80:])
    index.insert(17, idx[1][idx[1] >= 0], val[1][idx[1] >= 0])  # re-insert


# -- across the two packages ---------------------------------------------------

LEVERS = {"bf16": {}, "f8": dict(dtype="f8", value_dtype="bfloat16"),
          "lite": dict(sketch_kind="lite", index_buckets=64)}


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_jax_snapshot_and_wal_recover_in_port(tmp_path, lever):
    idx, val = synth.make_corpus(0, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    kw = LEVERS[lever]
    live = JDurable.open(_spec(pkg=jeng, **kw), wal_dir=wd, snapshot_dir=sd)
    _stream(live, idx, val)
    assert live.compact() > 0              # a KIND_COMPACT in the tail
    for e in (5, 60):
        live.delete(e)
    live.insert_many([5], idx[2:3], val[2:3])
    tail = wal.read_ops(wd, snaplib.latest_wal_lsn(sd))

    rec = DurableSinnamonIndex.open(_spec(**kw), wal_dir=wd,
                                    snapshot_dir=sd, device="cpu")
    assert rec.recovery_timings["replayed_ops"] == len(tail) == 10
    assert rec._id2slot == live._id2slot
    assert rec._free == live._free
    _assert_state_equal(rec, live)
    qi, qv = synth.make_queries(11, DS, 6, pad=16)
    j_ids, _ = live.search_many(qi, qv, k=10, kprime=40, backend="reference")
    t_ids, _ = rec.search_many(qi, qv, k=10, kprime=40)
    np.testing.assert_array_equal(t_ids, j_ids)


def test_port_snapshot_and_wal_recover_in_jax(tmp_path):
    idx, val = synth.make_corpus(1, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    _stream(live, idx, val)
    live.delete_many([20, 7, 20, 33, 90])  # one record, a repeated id
    live.insert_many([7, 33], idx[40:42], val[40:42])
    live.grow(128)
    assert live.compact() > 0
    live.delete_many(torch.tensor([1, 2]))
    kinds = [kind for _, kind, _ in wal.read_ops(wd, snaplib.latest_wal_lsn(sd))]
    assert kinds.count(wal.KIND_DELETE) == 5     # 3 deletes + 2 batches
    deletes = [a["ext_ids"].tolist() for _, kind, a in
               wal.read_ops(wd, snaplib.latest_wal_lsn(sd))
               if kind == wal.KIND_DELETE]
    assert [20, 7, 33, 90] in deletes

    rec = JDurable.open(_spec(128, pkg=jeng), wal_dir=wd, snapshot_dir=sd)
    assert rec._id2slot == live._id2slot
    assert rec._free == live._free
    _assert_state_equal(live, rec)
    qi, qv = synth.make_queries(12, DS, 6, pad=16)
    j_ids, _ = rec.search_many(qi, qv, k=10, kprime=40, backend="reference")
    t_ids, _ = live.search_many(qi, qv, k=10, kprime=40)
    np.testing.assert_array_equal(t_ids, j_ids)

    # and a snapshot of the port's state restores in JAX as it is
    live.snapshot()
    state, extra = jsnap.restore_parts(sd)
    assert extra["kind"] == "single"
    index = jeng.SinnamonIndex(jsnap._spec_from(extra["spec"]))
    jsnap.apply_single(index, state, extra)
    _assert_state_equal(live, index)


def test_jax_sharded_snapshot_restores_elastically_into_port(tmp_path):
    idx, val = synth.make_corpus(8, DS, 64, pad=32)
    mesh = meshlib.single_device_mesh(("data", "model"))
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = DurableShardedSinnamonIndex.open(_spec(64, pkg=jeng), mesh,
                                            wal_dir=wd, snapshot_dir=sd)
    live.insert_many(list(range(48)), idx[:48], val[:48])
    live.snapshot()
    live.delete_many([1, 2])
    live.insert_many(list(range(48, 64)), idx[48:], val[48:])
    jwd, jsd = str(tmp_path / "jwal"), str(tmp_path / "jsnap")
    shutil.copytree(wd, jwd)
    shutil.copytree(sd, jsd)

    port = _open(wd, sd, capacity=64)
    ref = JDurable.open(_spec(64, pkg=jeng), wal_dir=jwd, snapshot_dir=jsd)
    assert port.size == live.size == ref.size
    assert port._id2slot == ref._id2slot and port._free == ref._free
    _assert_state_equal(port, ref)
    assert snaplib.latest_extra(sd)["kind"] == "single"     # rebased
    qi, qv = synth.make_queries(12, DS, 3, pad=16)
    for q in range(3):
        ids_l, sc_l = live.search(qi[q], qv[q], k=10, kprime=64)
        ids_p, sc_p = port.search(qi[q], qv[q], k=10, kprime=64)
        assert set(ids_l.tolist()) == set(ids_p.tolist())
        np.testing.assert_allclose(np.sort(sc_l), np.sort(sc_p), atol=1e-5)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_state_to_numpy_inverts_state_from_numpy(lever):
    idx, val = synth.make_corpus(3, DS, 64, pad=32)
    kw = LEVERS[lever]
    J = jeng.SinnamonIndex(_spec(64, pkg=jeng, **kw))
    T = teng.SinnamonIndex(_spec(64, **kw), device="cpu")
    for index in (J, T):
        index.insert_many(list(range(64)), idx, val)
        for e in (4, 9, 30):
            index.delete(e)
        index.insert_many([100, 101], idx[:2], val[:2])
    _assert_state_equal(T, J)
    leaves = convert.state_to_numpy(T.state, T.spec)
    back = convert.state_from_numpy(leaves, T.spec, "cpu")
    for k, v in convert.state_to_numpy(back, T.spec).items():
        np.testing.assert_array_equal(v, leaves[k])
    manifest = {k: (list(v.shape), str(jnp.asarray(v).dtype))
                for k, v in jax_state_leaves(J).items()}
    assert manifest == {k: (list(s), d) for k, (s, d)
                        in snaplib.expected_leaves(T.spec).items()}


def jax_state_leaves(index) -> dict:
    """The JAX state's leaves with their true dtypes (what the reference's
    manifest records)."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(index.state)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("kw", [{}, dict(dtype="f8", sketch_kind="lite"),
                                dict(dtype="f32", index_buckets=64,
                                     positive_only=True)])
def test_spec_recipe_matches_reference(kw):
    assert dataclasses.asdict(_spec(**kw)) == jsnap._spec_dict(
        _spec(pkg=jeng, **kw))


def test_manifest_matches_reference(tmp_path):
    idx, val = synth.make_corpus(4, DS, 32, pad=32)
    spec_kw = dict(dtype="f8", value_dtype="bfloat16")
    J = JDurable.open(_spec(32, pkg=jeng, **spec_kw),
                      wal_dir=str(tmp_path / "jw"),
                      snapshot_dir=str(tmp_path / "js"))
    T = DurableSinnamonIndex.open(_spec(32, **spec_kw),
                                  wal_dir=str(tmp_path / "tw"),
                                  snapshot_dir=str(tmp_path / "ts"),
                                  device="cpu")
    for index in (J, T):
        index.insert_many(list(range(32)), idx, val)
        index.delete(5)
    paths = [J.snapshot(), T.snapshot()]
    manifests = []
    for p in paths:
        with open(os.path.join(p, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[1]["leaves"][".u"] == {"shape": [12, 32],
                                            "dtype": "float8_e4m3fn"}
    with np.load(os.path.join(paths[1], "arrays.npz")) as z:
        assert z[".store/.values"].dtype == np.uint16
        assert z[".bits"].dtype == np.uint32 and z[".ids"].shape == (32, 2)


def test_checkpoint_checks_leaves(tmp_path):
    d = str(tmp_path / "c")
    bits = torch.randn(3, 4).to(torch.bfloat16)
    arrays = {".a": convert.cells_to_numpy(bits),
              ".b": np.arange(4, dtype=np.int32)}
    with pytest.raises(ValueError, match="bits"):
        ckpt.save(d, 1, {".a": np.zeros(3, np.float32)},
                  dtypes={".a": "bfloat16"})
    ckpt.save(d, 1, arrays, dtypes={".a": "bfloat16"}, extra={"x": 1})
    got, step, extra = ckpt.restore(d, {".a": ((3, 4), "bfloat16"),
                                        ".b": ((4,), "int32")})
    assert step == 1 and extra == {"x": 1}
    back = convert.cells_from_numpy(got[".a"], torch.bfloat16)
    assert torch.equal(back.view(torch.int16), bits.view(torch.int16))
    with pytest.raises(ValueError, match="model"):
        ckpt.restore(d, {".a": ((3, 5), "bfloat16"), ".b": ((4,), "int32")})
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(d, {".a": ((3, 4), "bfloat16")})


# -- tests/test_persist_recovery.py's single-device cases, on the port ---------

def test_single_recovery_is_byte_identical(tmp_path):
    idx, val = synth.make_corpus(0, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    _stream(live, idx, val)

    rec = _open(wd, sd)
    assert rec._id2slot == live._id2slot
    assert rec._free == live._free
    _assert_state_equal(rec, live)
    _assert_search_identical(rec, live)


def test_recovery_after_compaction_point(tmp_path):
    """Compaction is a logged op: replay rebuilds at the same position."""
    idx, val = synth.make_corpus(1, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    _stream(live, idx, val)
    assert live.compact() > 0
    live.insert(777, idx[2][idx[2] >= 0], val[2][idx[2] >= 0])

    rec = _open(wd, sd)
    _assert_state_equal(rec, live)
    _assert_search_identical(rec, live)


@pytest.mark.parametrize("cut", [1, 7, 13, 64])
def test_truncated_wal_recovers_surviving_prefix(tmp_path, cut):
    """Truncate the WAL at arbitrary byte offsets (mid-payload, mid-header);
    recovery must equal a cleanly built index fed only the surviving ops."""
    idx, val = synth.make_corpus(2, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    _stream(live, idx, val)

    part = os.path.join(wd, wal.partition_name(0))
    seg = os.path.join(part, sorted(os.listdir(part))[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - cut)

    snap_lsn = snaplib.latest_wal_lsn(sd)
    survivors = wal.read_ops(wd, after_lsn=snap_lsn)
    rec = _open(wd, sd)

    # clean reference: fresh index fed the snapshot base + surviving tail
    clean = _open(str(tmp_path / "wal2"))
    clean.insert_many(list(range(48)), idx[:48], val[:48])   # snapshot base
    with clean._nolog():
        for _, kind, arrays in survivors:
            clean._apply_op(kind, arrays)
    _assert_state_equal(rec, clean)
    _assert_search_identical(rec, clean)


def test_wal_only_recovery_no_snapshot(tmp_path):
    """No snapshot at all: the WAL alone rebuilds the index."""
    idx, val = synth.make_corpus(5, DS, 64, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, capacity=64)
    live.insert_many(list(range(64)), idx, val)
    for e in (1, 2):
        live.delete(e)
    rec = _open(wd, capacity=64)
    _assert_state_equal(rec, live)


def test_writer_resumes_after_torn_tail(tmp_path):
    """Recover from a torn WAL, keep writing, recover again."""
    idx, val = synth.make_corpus(6, DS, 64, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, capacity=64)
    live.insert_many(list(range(32)), idx[:32], val[:32])
    part = os.path.join(wd, wal.partition_name(0))
    seg = os.path.join(part, sorted(os.listdir(part))[-1])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 5)

    rec = _open(wd, capacity=64)
    rec.insert_many(list(range(32, 64)), idx[32:], val[32:])
    rec2 = _open(wd, capacity=64)
    _assert_state_equal(rec2, rec)
    assert rec2.size == rec.size


def test_mutation_errors_do_not_poison_the_wal(tmp_path):
    """Failed ops must not be logged: a caught error, then recovery, must
    leave a fully usable, byte-identical index (validate-before-log)."""
    idx, val = synth.make_corpus(9, DS, 32, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, capacity=32)
    live.insert_many(list(range(16)), idx[:16], val[:16])
    with pytest.raises(KeyError):
        live.delete(999)                      # unknown id
    with pytest.raises(KeyError):
        live.delete_many([3, 999])            # unknown id in a batch
    with pytest.raises(ValueError):
        live.grow(live.spec.capacity)         # not larger
    with pytest.raises(ValueError):
        live.insert_many([100], idx[:1, :8], val[:1, :8])   # wrong width
    live.insert_many(list(range(16, 32)), idx[16:], val[16:])
    rec = _open(wd, capacity=32)
    _assert_state_equal(rec, live)
    assert rec.size == 32


def test_snapshot_is_idempotent_at_same_lsn(tmp_path):
    """snapshot() with no new ops must NOT rewrite the on-disk snapshot."""
    idx, val = synth.make_corpus(15, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    live.insert_many(list(range(48)), idx[:48], val[:48])
    p1 = live.snapshot()
    mtime = os.path.getmtime(os.path.join(p1, "manifest.json"))
    p2 = live.snapshot()
    assert p2 == p1
    assert os.path.getmtime(os.path.join(p1, "manifest.json")) == mtime
    rec = _open(wd, sd)
    _assert_state_equal(rec, live)


def test_open_refuses_pruned_wal_without_its_snapshot(tmp_path):
    """Opening a pruned WAL without the snapshot it was pruned against must
    raise, NOT 'repair' the unreachable records away (silent data loss)."""
    idx, val = synth.make_corpus(12, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    live.insert_many(list(range(48)), idx[:48], val[:48])
    live.snapshot()                               # prunes WAL <= snapshot LSN
    live.insert_many(list(range(48, 80)), idx[48:80], val[48:80])

    with pytest.raises(RuntimeError, match="unreachable"):
        _open(wd)                                 # forgot snapshot_dir
    survivors = wal.orphan_lsns(wd, -1)
    assert survivors, "refusing open must leave the WAL records intact"
    rec = _open(wd, sd)
    _assert_state_equal(rec, live)


def test_duplicate_delete_batch_never_poisons_the_wal(tmp_path):
    """delete_many with a repeated id is one deletion — it must not log a
    record that fails on apply (which would break every future recovery)."""
    idx, val = synth.make_corpus(18, DS, 32, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, capacity=32)
    live.insert_many(list(range(16)), idx[:16], val[:16])
    live.delete_many([2, 2, 5])
    assert live.size == 14

    rec = _open(wd, capacity=32)
    assert rec._id2slot == live._id2slot
    _assert_state_equal(rec, live)


def test_failed_insert_never_poisons_the_wal(tmp_path):
    """An op that will fail must not be logged: after a caller-handled batch
    length mismatch, recovery must still succeed (validate-before-log)."""
    idx, val = synth.make_corpus(13, DS, N_DOCS, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd)
    live.insert_many(list(range(8)), idx[:8], val[:8])
    with pytest.raises(ValueError, match="length mismatch"):
        live.insert_many([100, 101, 102], idx[8:10], val[8:10])
    live.insert_many([100, 101], idx[8:10], val[8:10])

    rec = _open(wd)
    assert rec._id2slot == live._id2slot
    _assert_state_equal(rec, live)


def test_corrupt_record_header_is_rejected(tmp_path):
    """The CRC covers the header too: a flipped kind/lsn byte must make the
    record undecodable (treated as a torn tail), not crash or misreplay."""
    idx, val = synth.make_corpus(14, DS, N_DOCS, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd)
    live.insert_many(list(range(8)), idx[:8], val[:8])
    live.insert_many(list(range(8, 16)), idx[8:16], val[8:16])

    part = os.path.join(wd, wal.partition_name(0))
    seg = os.path.join(part, sorted(os.listdir(part))[-1])
    assert len(wal.read_ops(wd)) == 2
    with open(seg, "r+b") as f:        # flip the LAST record's kind byte
        first_plen = wal._HEADER.unpack(f.read(wal._HEADER.size))[3]
        second_off = wal._HEADER.size + first_plen
        f.seek(second_off + 12)        # kind field: after magic(4)+lsn(8)
        f.write(bytes([wal.KIND_DELETE]))
    assert [lsn for lsn, _, _ in wal.read_ops(wd)] == [0]

    rec = _open(wd)
    assert sorted(rec._id2slot) == list(range(8))


def test_corrupt_mid_stream_segment_refuses_repair(tmp_path):
    """A bit-rotted record hides only the rest of ITS segment: records in
    later segments stay visible as orphans, so open() must refuse to repair
    (raise) instead of silently deleting the acknowledged later segments."""
    idx, val = synth.make_corpus(17, DS, N_DOCS, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, segment_bytes=1)
    for d in range(8):                       # 1-byte segments: one per record
        keep = idx[d] >= 0
        live.insert(d, idx[d][keep], val[d][keep])

    part = os.path.join(wd, wal.partition_name(0))
    segs = sorted(os.listdir(part))
    assert len(segs) == 8
    p = os.path.join(part, segs[2])
    with open(p, "r+b") as f:                # flip one payload byte
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(size - 1)
        byte = f.read(1)
        f.seek(size - 1)
        f.write(bytes([byte[0] ^ 0xFF]))

    with pytest.raises(RuntimeError, match="unreachable"):
        _open(wd, segment_bytes=1)
    assert sorted(os.listdir(part)) == segs  # refusal deleted nothing


def test_query_server_serves_during_maintenance(tmp_path):
    """Snapshots + background compaction must not disturb serving: queries
    sent while maintenance runs return the same answers as afterwards."""
    from repro_torch.serving.serve import QueryServer

    idx, val = synth.make_corpus(7, DS, N_DOCS, pad=32)
    wd, sd = str(tmp_path / "wal"), str(tmp_path / "snap")
    live = _open(wd, sd)
    live.insert_many(list(range(64)), idx[:64], val[:64])
    for e in (1, 5, 9):
        live.delete(e)
    live.insert_many([200, 201, 202], idx[64:67], val[64:67])

    srv = QueryServer(live, k=10, kprime=64)
    qi, qv = synth.make_queries(13, DS, 4, pad=16)
    bc = compact.BackgroundCompactor(live, threshold=0.0,
                                     interval_s=0.01).start()
    try:
        answers = [srv.query(qi[q], qv[q]) for q in range(4)]
        live.snapshot()
        answers2 = [srv.query(qi[q], qv[q]) for q in range(4)]
    finally:
        bc.stop()
    # compaction only TIGHTENS bounds; with kprime=capacity the result set
    # is exact either way, so answers must be stable across maintenance
    for (a, sa), (b, sb) in zip(answers, answers2):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)
    assert srv.stats["queries"] == 8
    # and the maintained state recovers byte-identically
    rec = _open(wd, sd)
    _assert_state_equal(rec, live)


# -- the port's own mechanisms -------------------------------------------------

def test_async_compaction_yields_to_a_racing_write(tmp_path):
    """try_compact_async re-encodes with no lock held; a logged op that
    lands meanwhile moves the mutation counter, so the write-in is skipped
    (None), nothing is logged, and the next attempt compacts."""
    idx, val = synth.make_corpus(19, DS, 64, pad=32)
    wd = str(tmp_path / "wal")
    live = _open(wd, capacity=64)
    live.insert_many(list(range(48)), idx[:48], val[:48])
    live.delete_many([1, 2, 3])
    live.insert_many([50, 51], idx[48:50], val[48:50])
    out = []
    with tfp.injected("compact.swap=stall:400ms"):
        t = threading.Thread(target=lambda: out.append(
            live.try_compact_async()))
        t.start()
        live.insert_many([52], idx[50:51], val[50:51])
        t.join()
    assert out == [None]
    assert int(live.state.dirty.sum()) == 3
    assert live.try_compact_async() == 3
    assert int(live.state.dirty.sum()) == 0
    kinds = [kind for _, kind, _ in wal.read_ops(wd)]
    assert kinds.count(wal.KIND_COMPACT) == 1
    rec = _open(wd, capacity=64)
    _assert_state_equal(rec, live)


def test_open_index_with_durability_recovers(tmp_path):
    idx, val = synth.make_corpus(20, DS, 40, pad=32)
    dur = tapi.DurabilityConfig(wal_dir=str(tmp_path / "wal"),
                                snapshot_dir=str(tmp_path / "snap"),
                                snapshot_every=16, snapshot_keep=1)
    cfg = tapi.IndexConfig(n=DS.n, capacity=64, m=12, h=2, max_nnz=32,
                           store_dtype="float32", seed=3, durability=dur)
    live = tapi.open_index(cfg, device="cpu")
    assert isinstance(live, DurableSinnamonIndex) and live.config is cfg
    for lo in range(0, 40, 8):
        live.insert_many(list(range(lo, lo + 8)), idx[lo:lo + 8],
                         val[lo:lo + 8])
    assert snaplib.latest_wal_lsn(str(tmp_path / "snap")) is not None
    rec = tapi.open_index(cfg, device="cpu")
    assert rec.size == 40
    _assert_state_equal(rec, live)
    with pytest.raises(ValueError, match="snapshot_dir"):
        tapi.DurabilityConfig(wal_dir="w", snapshot_every=4)


def test_launcher_recovers_on_second_run(tmp_path, capsys):
    from repro_torch.launch import serve as launcher
    argv = ["--docs", "200", "--queries", "8", "--query-batch", "4",
            "--device", "cpu", "--m", "32",
            "--wal", str(tmp_path / "wal"),
            "--snapshot-dir", str(tmp_path / "snap")]
    launcher.main(argv)
    first = capsys.readouterr().out
    assert "recovered" not in first and "indexed 200 docs" in first
    launcher.main(argv)
    second = capsys.readouterr().out
    assert "recovered 200 docs from snapshot + WAL tail" in second
    assert (first.split("recall@10=")[1].split()[0]
            == second.split("recall@10=")[1].split()[0])
    with pytest.raises(SystemExit, match="refusing to recover"):
        launcher.main(argv[:1] + ["300"] + argv[2:])


def test_searches_beside_writes_see_whole_states(tmp_path):
    """Stress (more threads than the test's cores, a short switch
    interval): searches running beside logged writes and a snapshot answer
    from the state before or after each write, never from half of it."""
    import sys

    idx, val = synth.make_corpus(21, DS, 64, pad=32)
    qi, qv = synth.make_queries(22, DS, 4, pad=16)
    churn = list(range(0, 64, 4))
    rest = [e for e in range(64) if e not in churn]
    live = _open(str(tmp_path / "wal"), str(tmp_path / "snap"), capacity=64,
                 fsync=False)
    live.insert_many(list(range(64)), idx, val)
    without = teng.SinnamonIndex(_spec(64), device="cpu")
    without.insert_many(rest, idx[rest], val[rest])

    def answer(ix):
        """The (id, score) pairs of each query's top-10 that score above 0
        (k'= capacity, so exact; zero-score ties may come in any order)."""
        ids, scores = ix.search_many(qi, qv, k=10, kprime=64)
        return tuple(frozenset((int(i), float(s)) for i, s in zip(a, b)
                               if s > 0) for a, b in zip(ids, scores))

    answers = [answer(ix) for ix in (live, without)]
    assert answers[0] != answers[1]
    stop, bad, seen = threading.Event(), [], set()
    # The writer waits in its first cycle until a search has seen each
    # state, so that both are seen whatever the scheduler does.
    saw = [threading.Event(), threading.Event()]

    def search():
        while not stop.is_set():
            got = answer(live)
            if got not in answers:
                bad.append(got)
            seen.add(answers.index(got) if got in answers else -1)
            if got in answers:
                saw[answers.index(got)].set()

    def write():
        for cycle in range(50):
            if cycle == 0:
                saw[0].wait(60)
            live.delete_many(churn)
            if cycle == 0:
                saw[1].wait(60)
            live.insert_many(churn, idx[churn], val[churn])

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=search) for _ in range(3)]
        writer = threading.Thread(target=write)
        for t in readers + [writer]:
            t.start()
        live.snapshot()
        writer.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
        stop.set()
    assert not writer.is_alive() and not any(t.is_alive() for t in readers)
    assert not bad, f"{len(bad)} searches saw half of a write"
    assert seen == {0, 1}
    rec = _open(str(tmp_path / "wal"), str(tmp_path / "snap"), capacity=64)
    _assert_state_equal(rec, live)


def _in_thread(fn):
    """Start ``fn`` on a daemon thread; returns (thread, done event)."""
    done = threading.Event()

    def run():
        fn()
        done.set()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, done


def _hold(side):
    """Take ``side()`` (a lock context) on a daemon thread until released;
    returns (entered, release) events."""
    entered, release = threading.Event(), threading.Event()

    def run():
        with side():
            entered.set()
            release.wait(30)
    threading.Thread(target=run, daemon=True).start()
    return entered, release


def test_state_lock_readers_share_and_writers_exclude():
    """``StateLock``: two reads hold it at once; a write waits for the
    reads, and a waiting write holds off a new read; a write nests writes
    and reads; a read cannot become a write."""
    lock = teng.StateLock()
    in1, out1 = _hold(lock.read)
    assert in1.wait(30)
    in2, out2 = _hold(lock.read)
    assert in2.wait(30), "a second read waited for the first"
    out2.set()
    in_w, out_w = _hold(lock.write)
    assert not in_w.wait(0.2), "a write ran beside a read"
    in3, out3 = _hold(lock.read)
    assert not in3.wait(0.2), "a read overtook a waiting write"
    out1.set()
    assert in_w.wait(30)
    assert not in3.wait(0.2), "a read ran beside a write"
    out_w.set()
    assert in3.wait(30)
    out3.set()
    with lock.write():
        with lock.write():
            with lock.read():
                assert lock._writer == threading.get_ident()
    with lock.read():
        with lock.read():
            with pytest.raises(RuntimeError, match="cannot take it to write"):
                with lock.write():
                    pass
    in4, out4 = _hold(lock.write)       # every hold above was given back
    assert in4.wait(30)
    out4.set()


def test_searches_run_side_by_side():
    """Two searches of one index from two threads run at the same time:
    the first one's scorer waits inside its search until the second one's
    scorer has run."""
    idx, val = synth.make_corpus(23, DS, 64, pad=32)
    qi, qv = synth.make_queries(24, DS, 2, pad=16)
    index = teng.SinnamonIndex(_spec(64), device="cpu")
    index.insert_many(list(range(64)), idx, val)
    entered = [threading.Event(), threading.Event()]

    def scorer(which):
        def score_fn(state, spec, q_idx, q_val, budget):
            entered[which].set()
            if which == 0:
                assert entered[1].wait(30), "the second search never ran"
            return teng.score_batch(state, spec, q_idx, q_val, budget)
        return score_fn

    want = index.search_many(qi, qv, k=5, kprime=20)
    got = [None, None]

    def search(which):
        got[which] = index.search_many(qi, qv, k=5, kprime=20,
                                       score_fn=scorer(which))
    _, done0 = _in_thread(lambda: search(0))
    assert entered[0].wait(30)
    _, done1 = _in_thread(lambda: search(1))
    assert done1.wait(30) and done0.wait(30)
    for ids, scores in got:
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(scores, want[1])
