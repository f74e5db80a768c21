"""Kernel C and the ``score_fn`` hook against the JAX reference.

* ``sinnamon_score_plain`` (kernel C's twin) against ``repro``'s Pallas
  ``sinnamon_score(interpret=True)`` at the shapes of
  tests/test_kernels.py::test_sinnamon_score_sweep: f32 and bf16 cells,
  with and without L, with a budget; rtol=atol=1e-6 (both add in the same
  order).
* The twin is bit-equal to the port's ``engine.score_batch(grouped=False)``
  (the ``reference`` backend) on the same state.
* ``search_batch(score_fn=make_engine_score_fn())`` on a state carried over
  from a JAX index (``convert``) against JAX's ``search_batch`` with its
  kernel-backed ``score_fn``: ids equal, exact scores within rtol=1e-5,
  atol=1e-6 (the rerank sums in another order).
* ``QueryServer(score_fn=...)``: label ``custom``, no staged trace, no
  sketch-only answer; ids equal the JAX server's at every degrade level.

Kernel C itself is held against the twin on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.core import engine as jeng  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sinnamon_score as jsinn  # noqa: E402
from repro.obs import metrics as obs_metrics  # noqa: E402
from repro.serving.serve import QueryServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import sketch as tsk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sinnamon_score as tsinn  # noqa: E402
from repro_torch.serving.serve import QueryServer as TServer  # noqa: E402

DS = jsynth.SparseDatasetSpec("t", n=500, psi_doc=24, psi_query=12,
                              value_dist="gaussian")

SPECS = {
    "plain": dict(m=16, h=2),
    "buckets": dict(m=16, h=1, index_buckets=96),
    "f8": dict(m=16, h=2, dtype="f8"),
    "lite": dict(m=16, h=2, sketch_kind="lite"),
}


@pytest.mark.parametrize("with_l", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,h,m,C", [(1, 4, 1, 8, 128), (2, 7, 2, 16, 256),
                                       (3, 5, 3, 8, 384)])
def test_plain_matches_pallas_kernel(rng, dtype, with_l, B, L, h, m, C):
    nrows = 12
    qv = rng.normal(0, 1, (B, L)).astype(np.float32)
    qv[:, -1] = 0.0                               # a valid coordinate with q = 0
    rows = rng.integers(0, m, (B, L, h)).astype(np.int32)
    bits = rng.integers(0, 2**32, (nrows, C // 32), dtype=np.uint32)
    brows = rng.integers(-1, nrows, (B, L)).astype(np.int32)
    qbits = np.where((brows >= 0)[..., None], bits[np.maximum(brows, 0)],
                     0).astype(np.uint32)
    ju = jnp.asarray(rng.normal(0, 1, (m, C)), jnp.float32).astype(dtype)
    jl = jnp.asarray(rng.normal(0, 1, (m, C)) - 1, jnp.float32).astype(dtype)
    cell = getattr(torch, dtype)
    tu = convert.cells_from_numpy(np.asarray(ju), cell)
    tl = convert.cells_from_numpy(np.asarray(jl), cell)
    if with_l:
        skm = torch.cat([tsk.cell_bits(tu), tsk.cell_bits(tl)]).view(cell)
        prow = np.where((qv > 0)[..., None], rows, rows + m).astype(np.int32)
    else:
        skm, prow = tu, rows
    for budget in (None, 3):
        s = slice(None, budget)
        want = jsinn.sinnamon_score(
            jnp.asarray(qv[:, s]), jnp.asarray(rows[:, s]),
            jnp.asarray(qbits[:, s]), ju, jl if with_l else None,
            tile_c=128, interpret=True)
        got = tsinn.sinnamon_score_plain(
            torch.from_numpy(np.ascontiguousarray(qv[:, s])),
            torch.from_numpy(np.ascontiguousarray(prow[:, s])),
            torch.from_numpy(np.ascontiguousarray(brows[:, s])),
            torch.from_numpy(bits.view(np.int32)), skm, one_sided=with_l)
        assert got.shape == (B, C)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(budget))


def _pair(spec_kw, n_docs=140, capacity=192):
    """A JAX index after inserts, deletes and re-inserts into dirty slots,
    and the port index carried over from its state."""
    idx, val = jsynth.make_corpus(0, DS, n_docs + 20, pad=48)
    common = dict(n=DS.n, capacity=capacity, max_nnz=48,
                  value_dtype="float32", seed=3, **spec_kw)
    J = jeng.SinnamonIndex(jeng.EngineSpec(**common))
    J.insert_many(list(range(n_docs)), idx[:n_docs], val[:n_docs])
    for d in range(0, n_docs, 7):
        J.delete(d)
    J.insert_many(list(range(n_docs, n_docs + 20)), idx[n_docs:],
                  val[n_docs:])
    st = J.state
    leaves = {"mappings": np.asarray(st.mappings), "u": np.asarray(st.u),
              "l": None if st.l is None else np.asarray(st.l),
              "bits": np.asarray(st.bits),
              "store_indices": np.asarray(st.store.indices),
              "store_values": np.asarray(st.store.values),
              "active": np.asarray(st.active), "ids": np.asarray(st.ids),
              "dirty": np.asarray(st.dirty)}
    T = teng.SinnamonIndex.from_numpy(teng.EngineSpec(**common), leaves,
                                      J._free, J._id2slot, device="cpu")
    return J, T


@pytest.mark.parametrize("spec_kw", list(SPECS.values()), ids=list(SPECS))
def test_plain_bit_equal_to_reference_backend(spec_kw):
    _, T = _pair(spec_kw)
    qi, qv = jsynth.make_queries(1, DS, 6, pad=24)
    qi, qv = torch.from_numpy(qi), torch.from_numpy(qv)
    fn = tops.make_engine_score_fn()
    for budget in (None, 5):
        got = fn(T.state, T.spec, qi, qv, budget)
        want = teng.score_batch(T.state, T.spec, qi, qv, budget)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("spec_kw", list(SPECS.values()), ids=list(SPECS))
@pytest.mark.parametrize("budget", [None, 5])
def test_search_batch_score_fn_matches_reference(spec_kw, budget):
    J, T = _pair(spec_kw)
    qi, qv = jsynth.make_queries(2, DS, 6, pad=24)
    jids, jsc, _ = jeng.search_batch(
        J.state, J.spec, jnp.asarray(qi), jnp.asarray(qv), 10, 60, budget,
        score_fn=jops.make_engine_score_fn(tile_c=128, interpret=True))
    ids, sc, _ = teng.search_batch(
        T.state, T.spec, torch.from_numpy(qi), torch.from_numpy(qv), 10, 60,
        budget, score_fn=tops.make_engine_score_fn())
    np.testing.assert_array_equal(ids.numpy(),
                                  jeng.unpack_ids64(np.asarray(jids)))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-5,
                               atol=1e-6)


def test_query_server_score_fn_matches_reference():
    J, T = _pair(SPECS["plain"])
    qi, qv = jsynth.make_queries(3, DS, 8, pad=24)
    js = JServer(J, k=10, kprime=80, registry=obs_metrics.NULL_REGISTRY,
                 score_fn=jops.make_engine_score_fn(tile_c=128,
                                                    interpret=True))
    ts = TServer(T, k=10, kprime=80, score_fn=tops.make_engine_score_fn(),
                 trace_every=1)
    answers = {}
    for degrade in (0, 1, 2):
        jr = js.query_many(qi, qv, degrade=degrade)
        tr = ts.query_many(qi, qv, degrade=degrade)
        assert tr.backend == "custom" == jr.backend
        assert tr.degraded == (degrade > 0)
        np.testing.assert_array_equal(tr.ids, jr.ids, err_msg=str(degrade))
        np.testing.assert_allclose(tr.scores, jr.scores, rtol=1e-5,
                                   atol=1e-6)
        answers[degrade] = tr
    assert ts.last_trace is None                  # never the staged path
    # degrade=2 under a score_fn reranks over k'/4, as degrade=1 does: exact
    # scores, not the sketch-only upper bounds
    np.testing.assert_array_equal(answers[2].ids, answers[1].ids)
    np.testing.assert_array_equal(answers[2].scores, answers[1].scores)
    _, ub = T.search_many_sketch(qi, qv, k=10)
    assert not np.array_equal(answers[2].scores, ub)
    one = ts.query(qi[0], qv[0])
    assert one.backend == "custom"
    np.testing.assert_array_equal(one.ids, js.query(qi[0], qv[0]).ids)


def test_dense_wrapper_dispatch_on_cpu():
    """CPU tensors run the twin and count no launch; asking for the kernel
    on CPU tensors raises."""
    ops = (torch.zeros((1, 2)), torch.zeros((1, 2, 1), dtype=torch.int32),
           torch.zeros((1, 2), dtype=torch.int32),
           torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 32)))
    before = tsinn.sinnamon_score.launches
    assert tsinn.sinnamon_score(*ops).shape == (1, 32)
    assert tsinn.sinnamon_score.launches == before
    with pytest.raises(ValueError):
        tsinn.sinnamon_score(*ops, use_kernel=True)
    from repro_torch import kernels
    assert "sinnamon_score" in kernels.launch_counts()


def test_backend_env_default(monkeypatch):
    monkeypatch.setenv(tops.SCORE_BACKEND_ENV, "grouped")
    assert tops.resolve_backend(None) == "grouped"
    assert tops.resolve_backend("reference") == "reference"
    _, T = _pair(SPECS["plain"])
    assert TServer(T)._backend_label() == "grouped"
    monkeypatch.setenv(tops.SCORE_BACKEND_ENV, "pallas")
    assert tops.resolve_backend(None) == "fused"
    monkeypatch.setenv(tops.SCORE_BACKEND_ENV, "tpu")
    with pytest.raises(ValueError):
        tops.resolve_backend(None)


@pytest.mark.parametrize("cell_bytes", [4, 2, 1])
@pytest.mark.parametrize("m", [16, 32, 64, 96])
def test_dense_tile_fits_two_blocks_per_sm(m, cell_bytes):
    """Kernel C's tile for a one-sided sketch (R = 2m rows): the widest
    tile whose block fits twice on an SM, sized as the kernel lays out its
    shared memory (checked against the kernel itself on the card)."""
    R = 2 * m
    for h in (1, 3):
        words, smem = tsinn.dense_tile(R, cell_bytes, h)
        assert smem == tsinn._dense_smem(R, cell_bytes, words, h)
        assert smem <= tsinn._DENSE_SMEM_TWO_PER_SM
        assert all(tsinn._dense_smem(R, cell_bytes, w, h)
                   > tsinn._DENSE_SMEM_TWO_PER_SM
                   for w in tsinn._DENSE_WORDS if w > words)
    # the main path (m=64, bf16) and the tuner's largest sketch (m=96, f32)
    assert tsinn.dense_tile(128, 2)[0] * 32 == 256
    assert tsinn.dense_tile(192, 4)[0] * 32 == 64


@pytest.mark.parametrize("cell_bytes,r_max", [(4, 1_720), (2, 3_440),
                                               (1, 6_880)])
def test_dense_tile_limit(cell_bytes, r_max):
    """Above two blocks per SM the tile is 32 slots at one block per SM; R
    rows of 32 slots that do not fit one block's shared memory raise."""
    words, smem = tsinn.dense_tile(r_max, cell_bytes)
    assert words == 1
    assert tsinn._DENSE_SMEM_TWO_PER_SM < smem <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        tsinn.dense_tile(r_max + 1, cell_bytes)
