"""The port's sharded streaming index against the JAX reference.

* S = 1, in-process: the port's ``ShardedSinnamonIndex`` against the
  reference's on a 1x1 mesh and against the port's own ``SinnamonIndex``.
* S = 2 and 4: the reference runs once, in one module-scoped subprocess
  with ``--xla_force_host_platform_device_count=4`` (as
  tests/test_sharded_stream.py does), and writes every scenario's results
  to an npz; the port runs the same scenarios in-process and is compared
  step by step: placement (``id2slot``) and the free lists, the
  ``logical_state()`` leaves bit for bit, ids and (shard, slot) locators
  equal, exact scores within rtol = atol = 1e-6 (the rerank tests'
  tolerance: f32 sums in another order), drift within the same.  The
  steps: duplicate and overwrite inserts, batched deletes (an unknown id
  raises with nothing changed), ``grow``, recycled slots, ``slot_drift``
  and ``compact``.
* Edge cases: cross-shard ties on integer-valued rows (the lower shard
  wins), k above the live count (the ``-inf`` tail), the ``score_fn`` hook
  with kernel C's twin, the tiered sharded index bit-equal to the resident
  one.
* Durable: each package recovers the other's sharded snapshot + WAL (the
  port's files are written before the subprocess starts, which recovers
  them); elastic 4 -> 2, sharded -> single and single -> sharded against an
  index built fresh from the live documents in ``_reinsert_live``'s order;
  a multi-shard batch torn by a failed or crashed append is discarded whole;
  ``snapshot.load_sharded`` on the reference's snapshots against its own.
* ``QueryServer`` (staged ``spmd_search`` span) and the front door over the
  sharded index; ``open_index`` rows; the launcher's ``--shards 2``.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import synth  # noqa: E402
from repro.distributed import mesh as jmesh  # noqa: E402
from repro.serving.sharded import ShardedSinnamonIndex as JSharded  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.distributed import topk as ttopk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sinnamon_score as tsinn  # noqa: E402
from repro_torch.persist import snapshot as tsnap  # noqa: E402
from repro_torch.persist import wal as twal  # noqa: E402
from repro_torch.persist.durable import (  # noqa: E402
    DurableShardedSinnamonIndex, DurableSinnamonIndex)
from repro_torch.serving import sharded as tsharded  # noqa: E402
from repro_torch.serving.serve import QueryServer  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TOL = dict(rtol=1e-6, atol=1e-6)

#: Shared by both packages: the data, the spec and the op streams (run
#: in-process for the port, in the subprocess for the reference).
COMMON = textwrap.dedent('''
    import numpy as np

    DS_KW = dict(name="t", n=400, psi_doc=20, psi_query=10,
                 value_dist="gaussian")
    SPEC_KW = dict(n=400, m=16, capacity=64, max_nnz=48, h=2, seed=3,
                   value_dtype="float32")
    SEARCHES = ((10, 40), (25, 16))          # (k, k')

    def data(synth):
        ds = synth.SparseDatasetSpec(**DS_KW)
        idx, val = synth.make_corpus(0, ds, 160, pad=48)
        qi, qv = synth.make_queries(1, ds, 6, pad=24)
        return idx, val, qi, qv

    def stream(index, idx, val, dump):
        """Duplicate and overwrite inserts, batched deletes, a refused
        delete, grow, recycled slots and compact; ``dump(tag)`` after
        each step."""
        ids = list(range(100)) + [5, 17, 5]      # the last 5 wins
        index.insert_many(ids, idx[:103], val[:103])
        dump("insert")
        index.insert_many([3, 7, 150, 151, 7], idx[103:108], val[103:108])
        dump("overwrite")
        index.delete_many([10, 11, 12, 10, 150, 40, 41, 42, 43])
        try:
            index.delete_many([13, 9999])
        except KeyError:
            pass
        else:
            raise AssertionError("an unknown id must raise")
        dump("delete")
        index.grow()
        dump("grow")
        index.insert_many(list(range(200, 240)), idx[108:148],
                          val[108:148])
        dump("recycle")
        dump("compact", index.compact())

    def ties(synth):
        """Integer-valued rows that tie across shards, 12 live docs."""
        idx = np.full((12, 48), -1, np.int32)
        val = np.zeros((12, 48), np.float32)
        idx[:, 0] = 5
        val[:, 0] = 1.0
        idx[6:, 1] = 9
        val[6:, 1] = 2.0
        qi = np.full((2, 24), -1, np.int32)
        qv = np.zeros((2, 24), np.float32)
        qi[:, 0], qv[:, 0] = 5, 1.0
        qi[1, 1], qv[1, 1] = 9, 0.5
        return [int(e) for e in range(100, 112)], idx, val, qi, qv

    def durable_stream(index, idx, val):
        """Snapshot mid-stream, then a WAL tail of deletes, inserts into
        recycled slots, a compaction and a re-insert."""
        index.insert_many(list(range(60)), idx[:60], val[:60])
        index.snapshot()
        index.delete_many([3, 17, 40, 41])
        index.insert_many(list(range(60, 100)), idx[60:100], val[60:100])
        index.compact()
        index.insert_many([3], idx[100:101], val[100:101])
''')
exec(COMMON)  # noqa: S102  (defines DS_KW, SPEC_KW, SEARCHES, data, ...)

REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, {src!r})
    import jax
    import numpy as np
    from repro.checkpoint import ckpt
    from repro.core import engine as eng
    from repro.data import synth
    from repro.distributed import mesh as meshlib
    from repro.persist.durable import DurableShardedSinnamonIndex
    from repro.serving.sharded import ShardedSinnamonIndex
    exec({common!r})

    out = {{}}
    def record(prefix, index, n=None):
        for key, arr in ckpt._flatten(index.state).items():
            out[prefix + "leaf" + key] = arr
        out[prefix + "id2slot"] = np.asarray(sorted(
            (e, s, t) for e, (s, t) in index._id2slot.items()), np.int64)
        for s, f in enumerate(index._free):
            out[prefix + f"free{{s}}"] = np.asarray(f, np.int64)
        if n is not None:
            out[prefix + "n"] = np.asarray(n)

    def searches(prefix, index, qi, qv, **kw):
        for k, kp in SEARCHES:
            ids, sc, loc = index.search_many(qi, qv, k, kprime=kp,
                                             return_locators=True, **kw)
            out[prefix + f"k{{k}}_ids"] = ids
            out[prefix + f"k{{k}}_sc"] = sc
            out[prefix + f"k{{k}}_loc"] = loc

    def score_fn(state, spec, qi, qv, budget):
        return jax.vmap(lambda i, v: eng.score(state, spec, i, v, budget))(
            qi, qv)

    idx, val, qi, qv = data(synth)
    spec = eng.EngineSpec(**SPEC_KW)
    for S in (2, 4):
        mesh = meshlib.make_mesh((1, S), ("data", "model"))
        index = ShardedSinnamonIndex(spec, mesh)
        def dump(tag, n=None):
            p = f"S{{S}}/{{tag}}/"
            record(p, index, n)
            searches(p, index, qi, qv, backend="reference")
            if tag == "recycle":
                out[p + "drift"] = index.slot_drift()
                searches(p + "hook/", index, qi, qv, score_fn=score_fn)
        stream(index, idx, val, dump)
        tid, tidx, tval, tqi, tqv = ties(synth)
        tix = ShardedSinnamonIndex(eng.EngineSpec(**SPEC_KW), mesh)
        tix.insert_many(tid, tidx, tval)
        ids, sc, loc = tix.search_many(tqi, tqv, 20, kprime=16,
                                       backend="reference",
                                       return_locators=True)
        out[f"S{{S}}/ties/ids"], out[f"S{{S}}/ties/sc"] = ids, sc
        out[f"S{{S}}/ties/loc"] = loc

    mesh4 = meshlib.make_mesh((1, 4), ("data", "model"))
    ref_dir = {ref_dir!r}
    live = DurableShardedSinnamonIndex.open(
        spec, mesh4, wal_dir=os.path.join(ref_dir, "wal"),
        snapshot_dir=os.path.join(ref_dir, "snap"))
    durable_stream(live, idx, val)
    record("ref_durable/", live)
    searches("ref_durable/", live, qi, qv, backend="reference")
    port_dir = {port_dir!r}
    rec = DurableShardedSinnamonIndex.open(
        spec, mesh4, wal_dir=os.path.join(port_dir, "wal"),
        snapshot_dir=os.path.join(port_dir, "snap"))
    record("port_durable/", rec)
    searches("port_durable/", rec, qi, qv, backend="reference")
    np.savez({npz!r}, **out)
    print("REFERENCE_OK")
''')


def _spec(pkg=teng, **kw):
    return pkg.EngineSpec(**{**SPEC_KW, **kw})


def _inputs():
    return data(synth)


def _port_record(index, n=None) -> dict:
    out = {"leaf" + k: v for k, v in convert.state_to_numpy(
        index.logical_state(), index.spec).items()}
    out["id2slot"] = np.asarray(sorted(
        (e, s, t) for e, (s, t) in index._id2slot.items()), np.int64)
    for s, f in enumerate(index._free):
        out[f"free{s}"] = np.asarray(f, np.int64)
    if n is not None:
        out["n"] = np.asarray(n)
    return out


def _port_searches(index, qi, qv, **kw) -> dict:
    out = {}
    for k, kp in SEARCHES:
        ids, sc, loc = index.search_many(qi, qv, k, kprime=kp,
                                         return_locators=True, **kw)
        out[f"k{k}_ids"], out[f"k{k}_sc"], out[f"k{k}_loc"] = ids, sc, loc
    return out


def _assert_matches(ref: dict, prefix: str, got: dict, what: str):
    """``got`` (a port record or searches) against the reference's entries
    under ``prefix``: state and maps bit for bit, ids and locators equal,
    scores within TOL."""
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)
            and not k[len(prefix):].startswith("hook/")}
    assert want, f"{what}: no reference entries under {prefix}"
    for key, w in want.items():
        g = got[key]
        if key.endswith("_sc") or key == "drift":
            np.testing.assert_allclose(g, w, err_msg=f"{what}: {key}", **TOL)
        else:
            assert g.dtype == w.dtype, f"{what}: {key} {g.dtype} {w.dtype}"
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {key}")


def _port_durable(root, idx, val):
    ix = DurableShardedSinnamonIndex.open(
        _spec(), "cpu", n_shards=4, wal_dir=os.path.join(root, "wal"),
        snapshot_dir=os.path.join(root, "snap"))
    durable_stream(ix, idx, val)
    return ix


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results of every scenario (one subprocess), plus the
    port's live durable index whose files that subprocess recovered."""
    root = tmp_path_factory.mktemp("sharded")
    idx, val, qi, qv = _inputs()
    port_dir = str(root / "port_durable")
    port_live = _port_durable(port_dir, idx, val)
    port_seen = {**_port_record(port_live),
                 **_port_searches(port_live, qi, qv, backend="reference")}
    npz = str(root / "reference.npz")
    script = REFERENCE.format(src=os.path.abspath(SRC), common=COMMON,
                              ref_dir=str(root / "ref_durable"),
                              port_dir=port_dir, npz=npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=900, env=env)
    assert "REFERENCE_OK" in out.stdout, out.stdout + out.stderr[-4000:]
    with np.load(npz) as f:
        ref = {k: f[k] for k in f.files}
    return {"ref": ref, "root": root, "port_live": port_seen}


# -- the stream, S = 2 and 4 ----------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
def test_stream_matches_reference(reference, S):
    ref = reference["ref"]
    idx, val, qi, qv = _inputs()
    index = tsharded.ShardedSinnamonIndex(_spec(), "cpu", n_shards=S)
    steps = []

    def dump(tag, n=None):
        p = f"S{S}/{tag}/"
        record = _port_record(index, n)
        if tag == "recycle":
            record["drift"] = index.slot_drift()
            _assert_matches(ref, p + "hook/", _port_searches(
                index, qi, qv, score_fn=tops.make_engine_score_fn()),
                p + "hook")
        for backend in ("reference", "fused"):
            _assert_matches(ref, p, {**record, **_port_searches(
                index, qi, qv, backend=backend)}, p + backend)
        steps.append(tag)

    stream(index, idx, val, dump)
    assert steps == ["insert", "overwrite", "delete", "grow", "recycle",
                     "compact"]


@pytest.mark.parametrize("S", [2, 4])
def test_cross_shard_ties_and_inf_tail(reference, S):
    """Equal scores across shards go to the lower shard; k above the live
    count returns the -inf tail in (shard, candidate) order."""
    ref = reference["ref"]
    tid, tidx, tval, tqi, tqv = ties(synth)
    index = tsharded.ShardedSinnamonIndex(_spec(), "cpu", n_shards=S)
    index.insert_many(tid, tidx, tval)
    for backend in ("reference", "fused"):
        ids, sc, loc = index.search_many(tqi, tqv, 20, kprime=16,
                                         backend=backend,
                                         return_locators=True)
        np.testing.assert_array_equal(ids, ref[f"S{S}/ties/ids"])
        np.testing.assert_array_equal(sc, ref[f"S{S}/ties/sc"])
        np.testing.assert_array_equal(loc, ref[f"S{S}/ties/loc"])
    shard, _ = ttopk.unpack_shard_slot(torch.from_numpy(loc[0]))
    live = np.isfinite(sc[0])
    assert live.sum() == 12 and np.isneginf(sc[0][~live]).all()
    assert (np.diff(shard.numpy()[live]) >= 0).all()     # lower shard first


# -- S = 1 ----------------------------------------------------------------------

def test_one_shard_matches_reference_and_single_index():
    idx, val, qi, qv = _inputs()
    jidx = JSharded(_spec(jeng), jmesh.single_device_mesh(("data", "model")))
    port = tsharded.ShardedSinnamonIndex(_spec(), ["cpu"])
    single = teng.SinnamonIndex(_spec(), device="cpu")
    for ix in (jidx, port, single):
        ix.insert_many(list(range(120)), idx[:120], val[:120])
        ix.delete_many([4])
        ix.insert_many([4, 300], idx[120:122], val[120:122])
    assert port._id2slot == jidx._id2slot
    assert port._free == [list(f) for f in jidx._free]
    want = jckpt._flatten(jidx.state)
    got = convert.state_to_numpy(port.logical_state(), port.spec)
    lone = convert.state_to_numpy(single.state, single.spec)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got[key], lone[key], err_msg=key)
    for k, kp in SEARCHES:
        j_ids, j_sc, j_loc = jidx.search_many(qi, qv, k, kprime=kp,
                                              backend="reference",
                                              return_locators=True)
        p_ids, p_sc, p_loc = port.search_many(qi, qv, k, kprime=kp,
                                              return_locators=True)
        s_ids, s_sc = single.search_many(qi, qv, k, kprime=kp)
        np.testing.assert_array_equal(p_ids, j_ids)
        np.testing.assert_array_equal(p_loc, j_loc)
        np.testing.assert_allclose(p_sc, j_sc, **TOL)
        np.testing.assert_array_equal(p_ids, s_ids)
        np.testing.assert_array_equal(p_sc, s_sc)


def test_routing_and_locators_match_reference():
    ids = [0, 1, 7, 2**31 + 5, 2**40 + 3, -1, -123456789]
    for S in (1, 2, 3, 4, 8):
        want = [((e * 2654435761) & 0xFFFFFFFF) % S for e in ids]
        assert tsharded.route_many(ids, S).tolist() == want
        ix = tsharded.ShardedSinnamonIndex(_spec(capacity=32), "cpu",
                                           n_shards=S)
        assert [ix.route(e) for e in ids] == want
    loc = ttopk.pack_shard_slot(torch.tensor([0, 3, 7]),
                                torch.tensor([5, 1_114_111, 0]))
    shard, slot = ttopk.unpack_shard_slot(loc)
    assert shard.tolist() == [0, 3, 7] and slot.tolist() == [5, 1_114_111, 0]


def test_merge_breaks_ties_by_shard_then_rank():
    vals = [torch.tensor([[2.0, 1.0, -torch.inf]]),
            torch.tensor([[2.0, 2.0, 1.0]])]
    pays = [torch.tensor([[10, 11, 12]]), torch.tensor([[20, 21, 22]])]
    top, pay, pos = ttopk.merge_shards(vals, pays, 5)
    assert pay.tolist() == [[10, 20, 21, 11, 22]]
    assert top.tolist() == [[2.0, 2.0, 2.0, 1.0, 1.0]]
    assert pos.tolist() == [[0, 3, 4, 1, 5]]
    # per-shard local_candidates, then the merge == one top-k over all
    rng = np.random.default_rng(5)
    scores = torch.from_numpy(rng.integers(0, 4, (3, 24)).astype(np.float32))
    ids = torch.arange(24)
    parts = [ttopk.local_candidates(scores[:, lo:lo + 8], ids[lo:lo + 8], 6)
             for lo in (0, 8, 16)]
    top, pay, _ = ttopk.merge_shards([v for v, _ in parts],
                                     [p for _, p in parts], 6)
    want_v, want_i = tsinn.topk_desc(scores, 6)
    assert torch.equal(top, want_v) and torch.equal(pay, want_i.long())


# -- tiered ---------------------------------------------------------------------

def _stream_steps(index, idx, val, qi, qv) -> dict:
    """{tag: state record, searches (every backend) and drift} of
    :func:`stream` on ``index``."""
    steps = {}

    def dump(tag, n=None):
        got = {**_port_record(index, n), "drift": index.slot_drift()}
        for backend in ("reference", "fused"):
            got.update({f"{backend}_{k}": v for k, v in _port_searches(
                index, qi, qv, backend=backend).items()})
        steps[tag] = got

    stream(index, idx, val, dump)
    return steps


@pytest.mark.parametrize("cache_chunks", [1, 64])
def test_tiered_sharded_bit_equal_to_resident(cache_chunks):
    idx, val, qi, qv = _inputs()
    res = tsharded.ShardedSinnamonIndex(_spec(), "cpu", n_shards=3)
    tie = tsharded.TieredShardedSinnamonIndex(
        _spec(), "cpu", n_shards=3, tier_chunk_slots=8,
        cache_chunks=cache_chunks)
    want = _stream_steps(res, idx, val, qi, qv)
    got = _stream_steps(tie, idx, val, qi, qv)
    assert list(got) == list(want)
    for tag in want:
        for key, w in want[tag].items():
            np.testing.assert_array_equal(got[tag][key], w,
                                          err_msg=f"{tag} {key}")
    stats = tie.tiers[0].stats()
    # a one-line cache cannot hold a batch's chunks: every gather falls back
    assert stats["fallbacks" if cache_chunks == 1 else "hits"] > 0
    # logical_state / adopt_logical_state: tiered -> resident -> tiered
    last = want["compact"]
    for src, cls, kw in ((tie, tsharded.ShardedSinnamonIndex, {}),
                         (res, tsharded.TieredShardedSinnamonIndex,
                          dict(tier_chunk_slots=8,
                               cache_chunks=cache_chunks))):
        back = cls(src.spec, "cpu", n_shards=3, **kw)
        back.adopt_logical_state(src.logical_state())
        back._free, back._id2slot = src._free, src._id2slot
        got = {**_port_record(back, last["n"]),
               **_port_searches(back, qi, qv, backend="fused")}
        for key, w in got.items():
            np.testing.assert_array_equal(
                w, last[key] if key in last else last[f"fused_{key}"],
                err_msg=f"{type(back).__name__} {key}")
    with pytest.raises(NotImplementedError):
        tie.search_many(qi, qv, 5, score_fn=tops.make_engine_score_fn())


# -- durable --------------------------------------------------------------------

def test_reference_durable_recovers_in_port(reference, tmp_path):
    ref = reference["ref"]
    _, _, qi, qv = _inputs()
    root = str(tmp_path / "d")
    shutil.copytree(reference["root"] / "ref_durable", root)
    rec = DurableShardedSinnamonIndex.open(
        _spec(), "cpu", n_shards=4, wal_dir=os.path.join(root, "wal"),
        snapshot_dir=os.path.join(root, "snap"))
    assert rec.recovery_timings["replayed_ops"] > 0
    _assert_matches(ref, "ref_durable/", {
        **_port_record(rec),
        **_port_searches(rec, qi, qv, backend="reference")}, "recovered")


def test_port_durable_recovers_in_reference(reference):
    ref, port = reference["ref"], reference["port_live"]
    _assert_matches(ref, "port_durable/", port, "port's files in JAX")


@pytest.mark.parametrize("case", ["sharded4", "elastic1", "single"])
def test_load_sharded_matches_reference(reference, tmp_path, case):
    """``snapshot.load_sharded`` on a snapshot the reference wrote: its own
    shard count placed directly (leaves, free lists, slot map bit for bit);
    onto one shard, and a single-kind snapshot onto one shard, elastically,
    equal to the reference's ``load_sharded`` on a 1x1 mesh."""
    from repro.persist import snapshot as jsnap
    from repro.serving.sharded import ShardedSinnamonIndex as JIndex
    snap = str(tmp_path / "snap")
    if case == "single":
        idx, val, _, _ = _inputs()
        jone = jeng.SinnamonIndex(_spec(jeng, capacity=128))
        jone.insert_many(list(range(90)), idx[:90], val[:90])
        jone.delete(5)
        jone.delete(6)
        jsnap.save(snap, jone, wal_lsn=7)
    else:
        shutil.copytree(reference["root"] / "ref_durable" / "snap", snap)
    state, extra = jsnap.restore_parts(snap)
    if case == "sharded4":
        port, lsn = tsnap.load_sharded(snap, "cpu")
        assert port.n_shards == 4 == extra["n_shards"]
        want = jckpt._flatten(state)
        want_free = extra["free"]
        want_map = {int(k): tuple(v) for k, v in extra["id2slot"].items()}
    else:
        jix, jlsn = jsnap.load_sharded(
            snap, jmesh.single_device_mesh(("data", "model")))
        port, lsn = tsnap.load_sharded(snap, "cpu", n_shards=1)
        assert lsn == jlsn and port.n_shards == 1
        assert port.update_block == jix.update_block
        want = jckpt._flatten(jix.state)
        want_free = [list(f) for f in jix._free]
        want_map = jix._id2slot
    assert type(port) is tsharded.ShardedSinnamonIndex
    assert lsn == extra["wal_lsn"]
    got = convert.state_to_numpy(port.logical_state(), port.spec)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert port._free == want_free and port._id2slot == want_map


def _fresh_from_live(cls_kwargs, live_state, id2row, cls):
    """An index built fresh from the live documents in ``_reinsert_live``'s
    order (ascending ids, chunks of 512), from ``live_state``'s raw rows."""
    ix = cls(**cls_kwargs)
    ind = live_state.store.indices.numpy()
    vals = live_state.store.values.float().numpy()
    ext = sorted(id2row)
    for lo in range(0, len(ext), 512):
        chunk = ext[lo:lo + 512]
        rows = [id2row[e] for e in chunk]
        ix.insert_many(chunk, ind[rows], vals[rows])
    return ix


def _assert_same_index(a, b, qi, qv):
    la = convert.state_to_numpy(a.logical_state(), a.spec)
    lb = convert.state_to_numpy(b.logical_state(), b.spec)
    for key in la:
        np.testing.assert_array_equal(la[key], lb[key], err_msg=key)
    assert a._id2slot == b._id2slot and a._free == b._free
    for k, kp in SEARCHES:
        ia, sa = a.search_many(qi, qv, k, kprime=kp)
        ib, sb = b.search_many(qi, qv, k, kprime=kp)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("target", ["sharded2", "single"])
def test_elastic_recovery_of_a_sharded_index(tmp_path, target):
    """4 shards -> 2 shards, and 4 shards -> one device: the restore
    re-inserts the live documents (and writes a rebased snapshot)."""
    idx, val, qi, qv = _inputs()
    root = str(tmp_path / "d")
    live = _port_durable(root, idx, val)
    live.snapshot()
    state = live.logical_state()
    cap = live.spec.capacity
    id2row = {e: s * cap + t for e, (s, t) in live._id2slot.items()}
    dkw = dict(wal_dir=os.path.join(root, "wal"),
               snapshot_dir=os.path.join(root, "snap"))
    if target == "single":
        rec = DurableSinnamonIndex.open(_spec(), device="cpu", **dkw)
        fresh = _fresh_from_live(dict(spec=_spec(), device="cpu"), state,
                                 id2row, teng.SinnamonIndex)
        kind = "single"
    else:
        rec = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=2,
                                               **dkw)
        fresh = _fresh_from_live(dict(spec=_spec(), devices="cpu",
                                      n_shards=2), state, id2row,
                                 tsharded.ShardedSinnamonIndex)
        kind = "sharded"
    assert rec.doc_ids() == live.doc_ids()
    _assert_same_index(rec, fresh, qi, qv)
    assert tsnap.latest_extra(dkw["snapshot_dir"])["kind"] == kind


def test_elastic_recovery_of_a_single_index_onto_shards(tmp_path):
    idx, val, qi, qv = _inputs()
    dkw = dict(wal_dir=str(tmp_path / "wal"),
               snapshot_dir=str(tmp_path / "snap"))
    live = DurableSinnamonIndex.open(_spec(capacity=128), device="cpu",
                                     **dkw)
    live.insert_many(list(range(90)), idx[:90], val[:90])
    live.delete_many([5, 6])
    live.snapshot()
    rec = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=2, **dkw)
    fresh = _fresh_from_live(dict(spec=_spec(), devices="cpu", n_shards=2),
                             live.logical_state(), dict(live._id2slot),
                             tsharded.ShardedSinnamonIndex)
    _assert_same_index(rec, fresh, qi, qv)
    extra = tsnap.latest_extra(dkw["snapshot_dir"])
    assert extra["kind"] == "sharded" and extra["n_shards"] == 2


@pytest.mark.parametrize("how", ["error", "crash"])
def test_torn_multi_shard_batch_is_discarded_whole(tmp_path, monkeypatch,
                                                   how):
    """The batch's records go out in descending LSN order: an append that
    fails (OSError: the appended records are taken back) or a crash
    between appends (they stay on disk, missing the batch's first LSN)
    loses the whole batch on recovery, never part of it."""
    idx, val, qi, qv = _inputs()
    dkw = dict(wal_dir=str(tmp_path / "wal"),
               snapshot_dir=str(tmp_path / "snap"))
    live = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=4,
                                            **dkw)
    live.insert_many(list(range(50)), idx[:50], val[:50])
    before = _port_record(live)
    lsns = [lsn for lsn, _, _ in twal.scan_all(dkw["wal_dir"])[0]]
    assert lsns == [0, 1, 2, 3]            # one record per shard
    batch = list(range(50, 70))
    assert len({live.route(e) for e in batch}) == 4
    w0 = live._writer(0)

    def fail(*a, **kw):
        if how == "error":
            raise OSError("injected append failure")
        raise KeyboardInterrupt("process dies between appends")

    monkeypatch.setattr(w0, "append", fail)
    with pytest.raises(OSError if how == "error" else KeyboardInterrupt):
        live.insert_many(batch, idx[50:70], val[50:70])
    monkeypatch.undo()
    on_disk = sorted(lsn for lsn, _, _ in twal.scan_all(dkw["wal_dir"])[0])
    if how == "error":
        assert on_disk == lsns             # the taken-back records are gone
    else:
        assert on_disk == lsns + [5, 6, 7]  # lsn 4, shard 0's, missing
    for w in live._writers.values():
        w.close()
    rec = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=4, **dkw)
    assert not any(e in rec for e in batch)
    got = _port_record(rec)
    for key, v in before.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert sorted(lsn for lsn, _, _ in twal.scan_all(dkw["wal_dir"])[0]) \
        == lsns
    rec.insert_many(batch, idx[50:70], val[50:70])   # the LSNs are reusable
    again = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=4,
                                             **dkw)
    assert again.size == 70


def test_compaction_policy_and_async_compaction_on_shards(tmp_path,
                                                          monkeypatch):
    """``persist.compact`` reads a sharded index's drift over every shard;
    the optimistic compaction rebuilds all shards' dirty columns, yields
    to a racing write, and a recovery replays it at the same position."""
    from repro_torch.persist import compact
    idx, val, qi, qv = _inputs()
    dkw = dict(wal_dir=str(tmp_path / "wal"))
    live = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=2,
                                            **dkw)
    live.insert_many(list(range(100)), idx[:100], val[:100])
    live.delete_many(range(0, 100, 3))
    live.insert_many(list(range(200, 234)), idx[100:134], val[100:134])
    stats = compact.drift_metrics(live)
    assert stats["dirty_active"] == 34 and stats["max_overestimate"] > 0
    from repro_torch.persist import durable as tdurable
    fire = tdurable._fp.fire

    def racing(site):                # a write lands between rebuild and swap
        if site == "compact.swap":
            live.insert_many([999], idx[150:151], val[150:151])
        return fire(site)

    monkeypatch.setattr(tdurable._fp, "fire", racing)
    assert live.try_compact_async() is None and 999 in live
    monkeypatch.undo()
    dirty = live._n_dirty(live.states)
    assert dirty == 34 and live.try_compact_async() == dirty
    assert compact.drift_metrics(live)["max_overestimate"] == 0.0
    rec = DurableShardedSinnamonIndex.open(_spec(), "cpu", n_shards=2, **dkw)
    for key, v in _port_record(live).items():
        np.testing.assert_array_equal(_port_record(rec)[key], v, err_msg=key)


# -- serving, the facade, the launcher ------------------------------------------

def test_query_server_and_front_door_serve_the_sharded_index():
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving.frontend import ServingFrontend
    idx, val, qi, qv = _inputs()
    index = tsharded.ShardedSinnamonIndex(_spec(), "cpu", n_shards=2)
    index.insert_many(list(range(150)), idx[:150], val[:150])
    server = QueryServer(index, k=10, kprime=40,
                         registry=obs_metrics.MetricsRegistry())
    want_ids, want_sc = index.search_many(qi, qv, 10, kprime=40)
    res = server.query_many(qi, qv)
    np.testing.assert_array_equal(res.ids, want_ids)
    staged = QueryServer(index, k=10, kprime=40, trace_every=1,
                         registry=obs_metrics.MetricsRegistry())
    sres = staged.query_many(qi, qv)
    np.testing.assert_array_equal(sres.ids, want_ids)
    np.testing.assert_array_equal(sres.scores, want_sc)
    assert [s.name for s in staged.last_trace.spans] == ["admission",
                                                         "spmd_search"]
    deg = server.query_many(qi, qv, degrade=2)       # no sketch-only answer
    assert np.isfinite(deg.scores).all()
    staged.reset_stats()
    fe = ServingFrontend(server, max_batch=4, batch_window_ms=20.0,
                         queue_depth=32)
    try:
        futs = [fe.submit(qi[b], qv[b]) for b in range(qi.shape[0])]
        got = [f.result(timeout=60) for f in futs]
    finally:
        fe.close()
    for b, g in enumerate(got):
        e = server.query(qi[b], qv[b])
        np.testing.assert_array_equal(g.ids, e.ids, err_msg=f"query {b}")
        np.testing.assert_array_equal(g.scores, e.scores)


def test_open_index_sharded_rows(tmp_path):
    from repro.api import IndexConfig as JConfig
    assert JConfig.__dataclass_fields__["update_block"].default == \
        tapi.IndexConfig.__dataclass_fields__["update_block"].default
    cfg = tapi.IndexConfig(n=100, capacity=200, m=8, shards=2,
                           update_block=8)
    index = tapi.open_index(cfg, device="cpu")
    assert type(index) is tsharded.ShardedSinnamonIndex
    assert index.n_shards == 2 and index.spec.capacity == 128
    assert index.update_block == 8 and index.config is cfg
    one = tapi.open_index(tapi.IndexConfig(n=100, capacity=64, m=8),
                          device=["cpu"])
    assert type(one) is tsharded.ShardedSinnamonIndex and one.n_shards == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.open_index(cfg)


def test_launcher_serves_two_shards(capsys, tmp_path):
    from repro_torch.launch import serve as launcher
    launcher.main(["--docs", "300", "--queries", "8", "--device", "cpu",
                   "--shards", "2"])
    out = capsys.readouterr().out
    assert "indexed 300 docs over 2 shard(s)" in out
    recall = float(out.split("recall@10=")[1].split()[0])
    assert recall >= 0.9
    argv = ["--docs", "300", "--queries", "4", "--device", "cpu",
            "--wal", str(tmp_path / "wal"), "--snapshot-dir",
            str(tmp_path / "snap")]
    launcher.main(argv + ["--shards", "2"])
    launcher.main(argv + ["--shards", "3"])          # elastic: 2 -> 3
    out = capsys.readouterr().out
    assert "recovered 300 docs from snapshot + WAL tail" in out
    assert "indexed 300 docs over 3 shard(s)" in out
