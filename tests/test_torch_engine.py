"""Engine parity: ``repro_torch.core.engine`` against ``repro.core.engine``.

The same streaming history (inserts, §4.3 deletes, re-inserts into dirty
slots) is replayed into both packages.  Every state leaf must be bit-equal;
``search_many`` of every port backend (``reference``, ``grouped``,
``fused``) must return the JAX ``reference`` backend's ids, with exact
scores within rtol=1e-5, atol=1e-6 (f32 sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import engine as jeng  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.data import synth as tsynth  # noqa: E402

DS = jsynth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12,
                              value_dist="gaussian")

SPECS = {
    "plain": dict(m=16, h=2),
    "buckets": dict(m=16, h=1, index_buckets=96),
    "fp32": dict(m=24, h=1, dtype="float32"),
    "f8": dict(m=16, h=2, dtype="f8"),
    "lite": dict(m=16, h=2, sketch_kind="lite"),
}

BACKENDS = ("reference", "grouped", "fused")


def _specs(capacity, **kw):
    common = dict(n=DS.n, capacity=capacity, max_nnz=48,
                  value_dtype="float32", seed=3, **kw)
    return jeng.EngineSpec(**common), teng.EngineSpec(**common)


def _churned(spec_kw, n_docs=140, capacity=192, seed=0):
    """Both indexes after the same stream as
    tests/test_query_backends.py::_churned_index."""
    idx, val = jsynth.make_corpus(seed, DS, n_docs + 20, pad=48)
    js, ts = _specs(capacity, **spec_kw)
    J, T = jeng.SinnamonIndex(js), teng.SinnamonIndex(ts, device="cpu")
    for index in (J, T):
        index.insert_many(list(range(n_docs)), idx[:n_docs], val[:n_docs])
        for d in range(0, n_docs, 7):
            index.delete(d)
        extra = list(range(n_docs, n_docs + 20))
        index.insert_many(extra, idx[n_docs:], val[n_docs:])
    return J, T


def _cells(x):
    return tsk.cell_bits(x.contiguous()).numpy()


def _assert_state_equal(js, ts):
    bits = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    for name in ("u", "l"):
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            np.testing.assert_array_equal(
                _cells(b).view(bits[a.dtype.itemsize]),
                a.view(bits[a.dtype.itemsize]), err_msg=name)
    np.testing.assert_array_equal(np.asarray(js.mappings), ts.mappings.numpy())
    np.testing.assert_array_equal(ts.bits.numpy().view(np.uint32),
                                  np.asarray(js.bits))
    np.testing.assert_array_equal(ts.store.indices.numpy(),
                                  np.asarray(js.store.indices))
    np.testing.assert_array_equal(
        ts.store.values.to(torch.float32).numpy(),
        np.asarray(js.store.values).astype(np.float32))
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_array_equal(ts.dirty.numpy(), np.asarray(js.dirty))
    np.testing.assert_array_equal(ts.ids.numpy(),
                                  jeng.unpack_ids64(np.asarray(js.ids)))


def test_synth_draws_identical():
    for seed in (0, 5):
        a = jsynth.make_corpus(seed, jsynth.SPLADE_LIKE, 40, pad=128)
        b = tsynth.make_corpus(seed, tsynth.SPLADE_LIKE, 40, pad=128)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        a = jsynth.make_queries(seed, DS, 9, pad=24)
        b = tsynth.make_queries(seed, tsynth.SparseDatasetSpec(
            "t", n=500, psi_doc=24, psi_query=12, value_dist="gaussian"),
            9, pad=24)
        np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("spec_kw", list(SPECS.values()), ids=list(SPECS))
def test_churned_state_bit_equal(spec_kw):
    J, T = _churned(spec_kw)
    _assert_state_equal(J.state, T.state)
    assert J._free == T._free and J._id2slot == T._id2slot


def _check_search(J, T, qi, qv, k=10, kprime=60, budget=None, filt=None):
    r_ids, r_sc = J.search_many(qi, qv, k=k, kprime=kprime, budget=budget,
                                filter_mask=None if filt is None
                                else jnp.asarray(filt),
                                backend="reference")
    for backend in BACKENDS:
        ids, sc = T.search_many(qi, qv, k=k, kprime=kprime, budget=budget,
                                filter_mask=filt, backend=backend)
        assert ids.dtype == np.int64
        np.testing.assert_array_equal(ids, r_ids, err_msg=backend)
        np.testing.assert_allclose(sc, r_sc, rtol=1e-5, atol=1e-6,
                                   err_msg=backend)


@pytest.mark.parametrize("spec_kw", list(SPECS.values()), ids=list(SPECS))
@pytest.mark.parametrize("budget", [None, 5])
def test_search_matches_reference(spec_kw, budget):
    J, T = _churned(spec_kw)
    qi, qv = jsynth.make_queries(1, DS, 6, pad=24)
    _check_search(J, T, qi, qv, budget=budget)
    mask = np.ones(T.spec.capacity, bool)
    mask[::3] = False
    _check_search(J, T, qi, qv, budget=budget, filt=mask)


def test_search_positive_only():
    ds = dataclasses.replace(DS, nonneg=True, value_dist="lognormal",
                             value_param=0.5)
    idx, val = jsynth.make_corpus(11, ds, 128, pad=48)
    js, ts = _specs(128, m=16, h=1, positive_only=True)
    J, T = jeng.SinnamonIndex(js), teng.SinnamonIndex(ts, device="cpu")
    for index in (J, T):
        index.insert_many(list(range(128)), idx, val)
    _assert_state_equal(J.state, T.state)
    qi, qv = jsynth.make_queries(12, ds, 6, pad=24)
    _check_search(J, T, qi, qv)


def test_odd_capacity_after_grow():
    J, T = _churned(SPECS["plain"], n_docs=100, capacity=128)
    for index in (J, T):
        index.grow(224)                               # not a tile multiple
    _assert_state_equal(J.state, T.state)
    assert J._free == T._free
    qi, qv = jsynth.make_queries(3, DS, 4, pad=24)
    for kprime in (60, 224):                          # 224: the -inf tail
        _check_search(J, T, qi, qv, k=12, kprime=kprime)


def test_single_insert_delete_and_overwrite():
    idx, val = jsynth.make_corpus(8, DS, 12, pad=48)
    js, ts = _specs(32, m=16, h=2)
    J, T = jeng.SinnamonIndex(js), teng.SinnamonIndex(ts, device="cpu")
    big = [2**31 + 5, 2**40 + 7, 2**62 + 123, 3]
    for index in (J, T):
        for e, i, v in zip(big, idx[:4], val[:4]):
            index.insert(e, i[:30], v[:30])
        index.delete(2**40 + 7)
        index.insert_many([3, 9, 9], idx[4:7], val[4:7])   # overwrite + dup
    _assert_state_equal(J.state, T.state)
    assert T.doc_ids() == J.doc_ids() and T.size == J.size
    assert 2**40 + 7 not in T and 2**62 + 123 in T
    qi, qv = jsynth.make_queries(9, DS, 1, pad=24)
    ids, _ = T.search(qi[0], qv[0], k=4, kprime=8)
    jids, _ = J.search(qi[0], qv[0], k=4, kprime=8)
    np.testing.assert_array_equal(ids, jids)


def test_delete_many_matches_single_deletes():
    """One batched ``delete_many`` leaves the state, free list and id map
    of the reference index's one-by-one deletes; then both re-insert into
    the same dirty slots."""
    J, T = _churned(SPECS["plain"])
    gone = [d for d in J.doc_ids() if d % 5 == 1]
    for d in gone:
        J.delete(d)
    T.delete_many(gone + gone[:3])                     # repeats: one deletion
    _assert_state_equal(J.state, T.state)
    assert J._free == T._free and J._id2slot == T._id2slot
    with pytest.raises(KeyError):
        T.delete_many([gone[0], J.doc_ids()[0]])
    assert J._free == T._free and J._id2slot == T._id2slot
    idx, val = jsynth.make_corpus(9, DS, len(gone), pad=48)
    for index in (J, T):
        index.insert_many(gone, idx, val)
    _assert_state_equal(J.state, T.state)


def test_sketch_only_search_matches():
    J, T = _churned(SPECS["plain"])
    qi, qv = jsynth.make_queries(4, DS, 5, pad=24)
    jids, jub = J.search_many_sketch(qi, qv, k=10, backend="reference")
    for backend in BACKENDS:
        ids, ub = T.search_many_sketch(qi, qv, k=10, backend=backend)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(ub, jub, rtol=1e-5, atol=1e-6)


def test_memory_bytes_accounting():
    J, T = _churned(SPECS["plain"])
    jm, tm = J.memory_bytes(), T.memory_bytes()
    assert tm["sketch"] == jm["sketch"]
    assert tm["inverted_index"] == jm["inverted_index"]
    assert tm["storage"] == jm["storage"]


def test_batch_mutation_oracle_single_vs_batched():
    """The batched insert of a block equals inserting its docs one by one
    (the port's analogue of the reference's scan-oracle test)."""
    idx, val = jsynth.make_corpus(5, DS, 24, pad=48)
    _, ts = _specs(64, m=16, h=2, index_buckets=40)
    a = teng.SinnamonIndex(ts, device="cpu")
    b = teng.SinnamonIndex(ts, device="cpu")
    a.insert_many(list(range(24)), idx, val)
    for e in range(24):
        b.insert(e, idx[e], val[e])
    for x, y in ((a.state.sketch, b.state.sketch), (a.state.bits, b.state.bits),
                 (a.state.ids, b.state.ids)):
        assert torch.equal(tsk.cell_bits(x) if x.is_floating_point() else x,
                           tsk.cell_bits(y) if y.is_floating_point() else y)


@pytest.mark.parametrize("spec_kw", [SPECS["plain"], SPECS["buckets"]],
                         ids=["plain", "buckets"])
def test_masked_batch_mutations_match(spec_kw):
    """The functional masked forms: masked-off entries are exact no-ops in
    both packages and the kept ones land identically."""
    rng = np.random.default_rng(7)
    idx, val = jsynth.make_corpus(5, DS, 16, pad=48)
    J, T = _churned(spec_kw, n_docs=96, capacity=160, seed=4)
    free = np.asarray([J._free[-(i + 1)] for i in range(16)], np.int32)
    eids = rng.integers(0, 2**62, 16).astype(np.int64)
    mask = rng.random(16) < 0.6
    js = jeng.insert_batch_masked(
        J.state, J.spec, jnp.asarray(free), jnp.asarray(jeng.pack_ids64(eids)),
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mask))
    teng.insert_batch_masked(
        T.state, T.spec, torch.from_numpy(free), torch.from_numpy(eids),
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(mask))
    _assert_state_equal(js, T.state)
    live = np.asarray([J._id2slot[d] for d in list(J._id2slot)[:16]],
                      np.int32)
    dmask = rng.random(16) < 0.7
    js = jeng.delete_batch_masked(js, J.spec, jnp.asarray(live),
                                  jnp.asarray(dmask))
    teng.delete_batch_masked(T.state, T.spec, torch.from_numpy(live),
                             torch.from_numpy(dmask))
    _assert_state_equal(js, T.state)


def test_single_query_scores_and_sparse_rerank_match():
    """``score`` / ``score_grouped`` of one query and the sparse rerank
    primitive against the reference's."""
    from repro.storage import vecstore as jvs
    from repro_torch.storage import vecstore as tvs

    J, T = _churned(SPECS["buckets"])
    qi, qv = jsynth.make_queries(6, DS, 1, pad=24)
    qi, qv = qi[0], qv[0]
    for jfn, tfn in ((jeng.score, teng.score),
                     (jeng.score_grouped, teng.score_grouped)):
        want = np.asarray(jfn(J.state, J.spec, jnp.asarray(qi),
                              jnp.asarray(qv), 5))
        got = tfn(T.state, T.spec, torch.from_numpy(qi), torch.from_numpy(qv),
                  5).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    slots = np.arange(0, 192, 5, dtype=np.int32)
    want = jvs.exact_scores_sparse(J.state.store, jnp.asarray(slots),
                                   jnp.asarray(qi), jnp.asarray(qv))
    got = tvs.exact_scores_sparse(T.state.store, torch.from_numpy(slots).long(),
                                  torch.from_numpy(qi), torch.from_numpy(qv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
