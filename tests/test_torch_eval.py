"""The evaluation path against the JAX reference.

* ``core.theory``: every function equal to ``repro.core.theory``'s to 1e-12.
* ``LinScanIndex`` / ``WandIndex``: the same ids.
* ``eval.recall.exact_topk_ids`` (kernel B's twin + ``topk_desc``): the
  reference oracle's ids on a tie-free corpus.
* ``eval.recall.frontier``: recall, MRR and bytes equal per point (latency
  is measured, not compared); the bound check's dict within 1e-6.
* ``churn_overestimate`` dicts within 1e-6; ``fresh_sketch``,
  ``slot_drift`` and ``compact_state`` leaves bit-equal after churn.
* ``eval.tune.tune``: its frontier's recall, bytes and ``feasible`` flags;
  the choice on a grid with one feasible point.
* The launcher with ``--auto-tune`` and with the lever flags, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import engine as jeng  # noqa: E402
from repro.core import linscan as jlinscan  # noqa: E402
from repro.core import sketch as jsk  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core import wand as jwand  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.eval import bounds as jbounds  # noqa: E402
from repro.eval import recall as jrecall  # noqa: E402
from repro.eval import tune as jtune  # noqa: E402
from repro_torch import eval as teval  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import linscan as tlinscan  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.core import theory as ttheory  # noqa: E402
from repro_torch.core import wand as twand  # noqa: E402

DS = jsynth.SparseDatasetSpec("t", n=300, psi_doc=30, psi_query=12,
                              value_dist="gaussian")
DOCS, K = 256, 10

#: the port's name of each reference backend
BACKEND = {"pallas": "fused", "reference": "reference"}


@pytest.fixture(scope="module")
def corpus():
    idx, val = jsynth.make_corpus(0, DS, DOCS, pad=48)
    qi, qv = jsynth.make_queries(1, DS, 8, pad=24)
    return idx, val, qi, qv


def _close(a, b, tol=1e-6, path="") -> None:
    """Nested dicts / lists equal, floats within ``tol``."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], tol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, float):
        assert b == pytest.approx(a, abs=tol, rel=tol), path
    else:
        assert a == b, path


def test_theory_matches_reference():
    deltas = np.linspace(0.0, 2.0, 9)
    dists = [("uniform_dist", ()), ("gaussian_dist", (0.2, 1.3)),
             ("lognormal_dist", (0.6,)), ("zeta_dist", (1.1,))]
    for name, args in dists:
        jd, td = getattr(jtheory, name)(*args), getattr(ttheory, name)(*args)
        np.testing.assert_array_equal(td[2], jd[2])
        for fn, extra in (("prob_overestimate", (119.0, 64, 1)),
                          ("error_cdf", None), ("expected_error", None)):
            if fn == "error_cdf":
                want = jtheory.error_cdf(deltas, *jd, 43.0, 32, 2)
                got = ttheory.error_cdf(deltas, *td, 43.0, 32, 2)
            elif fn == "expected_error":
                want = jtheory.expected_error(*jd, 43.0, 32, 2, n_delta=50)
                got = ttheory.expected_error(*td, 43.0, 32, 2, n_delta=50)
            else:
                want = getattr(jtheory, fn)(*jd, *extra)
                got = getattr(ttheory, fn)(*td, *extra)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}.{fn}")
    for fn, args in (("prob_overestimate_gaussian_closed", (64, 2, 30000,
                                                            0.004)),
                     ("error_cdf_gaussian_closed", (deltas, 1.0, 64, 2,
                                                    30000, 0.004)),
                     ("required_m", (0.5, 0.05, 2, 30000, 0.004, 1.0)),
                     ("unconditional_moments", (0.01, 0.3, 0.2))):
        np.testing.assert_allclose(getattr(ttheory, fn)(*args),
                                   getattr(jtheory, fn)(*args), rtol=1e-12,
                                   atol=1e-12, err_msg=fn)
    err = np.linspace(-1, 3, 7)
    np.testing.assert_allclose(
        ttheory.z_statistic(err, np.arange(1.0, 5.0), 0.01, 0.3, 0.2),
        jtheory.z_statistic(err, np.arange(1.0, 5.0), 0.01, 0.3, 0.2),
        rtol=1e-12, atol=1e-12)


def test_linscan_and_wand_ids_match(corpus):
    idx, val, qi, qv = corpus
    jl, tl = jlinscan.LinScanIndex(DS.n), tlinscan.LinScanIndex(DS.n)
    jw, tw = jwand.WandIndex(DS.n), twand.WandIndex(DS.n)
    for ls in (jl, tl):
        ls.insert_many(range(DOCS), idx, val)
        ls.delete(3)
    jw.build(range(DOCS), idx, val)
    tw.build(range(DOCS), idx, val)
    for b in range(len(qi)):
        for kw in ({}, dict(kprime=40, posting_budget=60)):
            np.testing.assert_array_equal(tl.search(qi[b], qv[b], K, **kw)[0],
                                          jl.search(qi[b], qv[b], K, **kw)[0])
        np.testing.assert_array_equal(tw.search(qi[b], qv[b], K)[0],
                                      jw.search(qi[b], qv[b], K)[0])
        np.testing.assert_array_equal(
            tlinscan.brute_force_topk(idx, val, qi[b], qv[b], DS.n, K)[0],
            jlinscan.brute_force_topk(idx, val, qi[b], qv[b], DS.n, K)[0])
    assert tl.memory_bytes() == jl.memory_bytes()
    assert tw.memory_bytes() == jw.memory_bytes()


def test_exact_topk_ids_match(corpus):
    idx, val, qi, qv = corpus
    want = jrecall.exact_topk_ids(idx, val, qi, qv, DS.n, K)
    got = teval.exact_topk_ids(idx, val, qi, qv, DS.n, K, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    got_t = teval.exact_topk_ids(torch.from_numpy(idx), torch.from_numpy(val),
                                 torch.from_numpy(qi), torch.from_numpy(qv),
                                 DS.n, K, device="cpu")
    np.testing.assert_array_equal(got_t, want)


POINTS = [dict(m=32, sketch_kind="full", kprime=60),
          dict(m=32, sketch_kind="lite", kprime=60),
          dict(m=16, cell_dtype="f8", kprime=60, budget=5)]

_SERVED = ("recall_at_k", "mrr", "sketch_bytes", "index_bytes", "m",
           "sketch_kind", "cell_dtype", "kprime", "budget", "k")


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_frontier_matches_reference(corpus, backend):
    idx, val, qi, qv = corpus
    want = jrecall.frontier(
        idx, val, qi, qv, DS.n, POINTS, k=K, backend=backend, reps=1,
        bounds_params=dict(value_dist=jtheory.gaussian_dist()))
    got = teval.frontier(
        idx, val, qi, qv, DS.n, POINTS, k=K, backend=BACKEND[backend],
        reps=1, bounds_params=dict(value_dist=ttheory.gaussian_dist()),
        device="cpu")
    for g, w in zip(got, want):
        assert {k: g[k] for k in _SERVED} == {k: w[k] for k in _SERVED}
        assert g["p50_ms"] > 0
        _close(g["bounds"], w["bounds"])
    with pytest.raises(ValueError, match="unknown lever"):
        teval.frontier(idx[:64], val[:64], qi[:2], qv[:2], DS.n,
                       [dict(m=16, sketchkind="lite")], device="cpu")


def _churned_pair(spec_kw, n_docs=120, capacity=160):
    idx, val = jsynth.make_corpus(4, DS, n_docs + 16, pad=48)
    common = dict(n=DS.n, capacity=capacity, max_nnz=48, seed=3, **spec_kw)
    J = jeng.SinnamonIndex(jeng.EngineSpec(**common))
    T = teng.SinnamonIndex(teng.EngineSpec(**common), device="cpu")
    for index in (J, T):
        index.insert_many(list(range(n_docs)), idx[:n_docs], val[:n_docs])
        for d in range(0, n_docs, 5):
            index.delete(d)
        index.insert_many(list(range(n_docs, n_docs + 16)), idx[n_docs:],
                          val[n_docs:])
    return J, T


def _cells_equal(t, j):
    assert (t is None) == (j is None)
    if j is not None:
        j = np.asarray(j)
        np.testing.assert_array_equal(
            tsk.cell_bits(t.contiguous()).numpy().view(
                {1: np.uint8, 2: np.uint16, 4: np.uint32}[j.dtype.itemsize]),
            j.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[j.dtype.itemsize]))


@pytest.mark.parametrize("spec_kw", [
    dict(m=16, h=2), dict(m=16, h=1, dtype="f8"),
    dict(m=16, h=2, sketch_kind="lite", value_dtype="float32")],
    ids=["bf16", "f8", "lite-f32store"])
def test_compaction_and_drift_bit_equal(spec_kw):
    J, T = _churned_pair(spec_kw)
    ju, jl = jeng.fresh_sketch(J.state, J.spec)
    tu, tl = teng.fresh_sketch(T.state, T.spec)
    _cells_equal(tu, ju)
    _cells_equal(tl, jl)
    np.testing.assert_array_equal(T.slot_drift(), J.slot_drift())
    assert T.slot_drift().max() > 0
    assert T.compact() == J.compact() > 0
    _cells_equal(T.state.u, J.state.u)
    _cells_equal(T.state.l, J.state.l)
    np.testing.assert_array_equal(T.state.dirty.numpy(),
                                  np.asarray(J.state.dirty))
    np.testing.assert_array_equal(T.slot_drift(), J.slot_drift())
    assert T.compact() == 0


def test_decode_vector_matches_reference():
    J, T = _churned_pair(dict(m=16, h=3))
    slots = np.arange(0, 160, 9)
    idx = np.asarray(J.state.store.indices)[slots]
    for s, row in zip(slots, idx):
        ju, jl = jsk.decode_vector(J.state.mappings, J.state.u[:, s],
                                   J.state.l[:, s], jnp.asarray(row))
        tu, tl = tsk.decode_vector(T.state.mappings, T.state.u[:, s],
                                   T.state.l[:, s], torch.from_numpy(row))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_bounds_and_churn_match_reference(corpus):
    idx, val, _, _ = corpus
    kw = dict(m=32, cell_dtype="bf16")
    jspec = jrecall.lever_spec(DS.n, 192, idx.shape[1], **kw)
    tspec = teval.lever_spec(DS.n, 192, idx.shape[1], **kw)
    J = jrecall.build_index(jspec, idx[:192], val[:192])
    T = teval.build_index(tspec, idx[:192], val[:192], device="cpu")
    for max_docs in (4096, 50):                  # the sample is numpy's draw
        np.testing.assert_array_equal(
            teval.per_coordinate_overestimate(T, max_docs=max_docs),
            jbounds.per_coordinate_overestimate(J, max_docs=max_docs))
    _close(teval.check_upper_bounds(T, value_dist=ttheory.gaussian_dist(),
                                    max_docs=80),
           jbounds.check_upper_bounds(J, value_dist=jtheory.gaussian_dist(),
                                      max_docs=80))
    want = jbounds.churn_overestimate(jspec, idx[:192], val[:192], rounds=2,
                                      frac=0.2, max_docs=100)
    got = teval.churn_overestimate(tspec, idx[:192], val[:192], rounds=2,
                                   frac=0.2, max_docs=100, device="cpu")
    _close(got, want)
    assert got["compacted"]["drift_max"] == 0.0 < got["churned"]["drift_max"]


def test_tune_matches_reference(corpus):
    idx, val, qi, qv = corpus
    grid = dict(k=K, ms=(16, 32), sketch_kinds=("full", "lite"),
                cell_dtypes=("bf16",), sample_docs=192, sample_queries=6,
                target_docs=4096)
    sizes = sorted(teval.spec_index_bytes(teval.lever_spec(
        DS.n, 4096, idx.shape[1], m=m, sketch_kind=kind))
        for m in (16, 32) for kind in ("full", "lite"))
    assert sizes == sorted(jtune.spec_index_bytes(jrecall.lever_spec(
        DS.n, 4096, idx.shape[1], m=m, sketch_kind=kind))
        for m in (16, 32) for kind in ("full", "lite"))
    # a memory budget that admits exactly one point: the choice is fixed
    budget = (sizes[0] + sizes[1]) / 2
    want = jtune.tune(idx, val, qi, qv, DS.n, memory_budget_bytes=budget,
                      recall_floor=0.0, **grid)
    got = teval.tune.tune(idx, val, qi, qv, DS.n, memory_budget_bytes=budget,
                          recall_floor=0.0, device="cpu", **grid)
    keys = ("m", "sketch_kind", "recall_at_k", "mrr", "index_bytes",
            "predicted_index_bytes", "feasible")
    assert [{k: p[k] for k in keys} for p in got.frontier] == \
        [{k: p[k] for k in keys} for p in want.frontier]
    assert got.feasible and want.feasible
    assert sum(p["feasible"] for p in got.frontier) == 1
    assert (got.spec.m, got.spec.sketch_kind, got.spec.capacity) == \
        (want.spec.m, want.spec.sketch_kind, want.spec.capacity)
    assert got.kprime == want.kprime and got.budget == want.budget


def test_launcher_auto_tune_and_lever_flags(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--docs", "300", "--queries", "8", "--query-batch", "4",
                   "--device", "cpu", "--auto-tune", "--tune-memory-mb", "2",
                   "--recall-floor", "0.5", "--m", "32"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("auto-tune:"))
    assert "meets constraints" in line and "m=" in line
    assert "indexed 300 docs over 1 shard(s)" in out
    assert 0.5 <= float(out.split("recall@10=")[1].split()[0]) <= 1.0
    launcher.main(["--docs", "300", "--queries", "8", "--query-batch", "4",
                   "--device", "cpu", "--m", "32", "--budget", "8",
                   "--sketch-kind", "lite", "--value-dtype", "f8",
                   "--index-buckets", "4096", "--score-backend", "reference"])
    out = capsys.readouterr().out
    assert "indexed 300 docs over 1 shard(s)" in out
    assert 0.3 <= float(out.split("recall@10=")[1].split()[0]) <= 1.0
