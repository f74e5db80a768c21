"""Serving-surface parity and the port's package boundary.

* ``open_index(device="cpu")`` + ``QueryServer.query_many`` end to end
  against ``repro``'s: ids equal (degrade levels and the staged path too).
* ``convert.state_from_numpy`` of a JAX-built index searches to the same
  ids.
* ``repro_torch`` and every submodule import with ``jax`` and ``repro``
  blocked.
* ``open_index()`` without a device means the CUDA card.
"""

import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the suite runs it)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro import api as japi  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.obs import metrics as obs_metrics  # noqa: E402
from repro.serving.serve import QueryServer as JServer  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.serving.results import QueryResult  # noqa: E402
from repro_torch.serving.serve import QUERY_STAGES  # noqa: E402
from repro_torch.serving.serve import QueryServer as TServer  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DS = jsynth.SparseDatasetSpec("t", n=600, psi_doc=30, psi_query=12,
                              value_dist="gaussian")


def _pair(cell="bf16", n_docs=300, capacity=320):
    idx, val = jsynth.make_corpus(2, DS, n_docs, pad=64)
    kw = dict(n=DS.n, capacity=capacity, m=24, h=2, max_nnz=64,
              cell_dtype=cell, store_dtype="float32", seed=1)
    J = japi.open_index(japi.IndexConfig(**kw, backend="reference"))
    T = tapi.open_index(tapi.IndexConfig(**kw), device="cpu")
    for index in (J, T):
        index.insert_many(list(range(n_docs)), idx, val)
        for d in range(0, n_docs, 9):
            index.delete(d)
        index.insert_many(list(range(0, n_docs, 9)), idx[::9], val[::9])
    return J, T


@pytest.mark.parametrize("cell", ["bf16", "f8"])
def test_query_many_matches_reference(cell):
    J, T = _pair(cell)
    qi, qv = jsynth.make_queries(3, DS, 12, pad=24)
    js = JServer(J, k=10, kprime=80, registry=obs_metrics.NULL_REGISTRY)
    ts = TServer(T, k=10, kprime=80)
    for degrade in (0, 1, 2):
        jr = js.query_many(qi, qv, degrade=degrade)
        tr = ts.query_many(qi, qv, degrade=degrade)
        assert isinstance(tr, QueryResult) and tr.backend == "fused"
        assert tr.degraded == (degrade > 0) and tr.ids.shape == (12, 10)
        np.testing.assert_array_equal(tr.ids, jr.ids, err_msg=str(degrade))
        np.testing.assert_allclose(tr.scores, jr.scores, rtol=1e-5,
                                   atol=1e-6)
    one = ts.query(qi[0], qv[0])
    np.testing.assert_array_equal(one.ids, js.query(qi[0], qv[0]).ids)
    assert ts.stats["queries"] == 3 * 12 + 1
    pct = ts.latency_percentiles()
    assert set(pct) == {"p50", "p90", "p99"} and pct["p50"] >= 0
    ts.reset_stats()
    assert ts.latency_percentiles() == {} and ts.stats["queries"] == 0


@pytest.mark.parametrize("backend", ["fused", "reference"])
def test_staged_path_matches_production(backend):
    _, T = _pair()
    qi, qv = jsynth.make_queries(4, DS, 8, pad=24)
    staged = TServer(T, k=10, kprime=80, score_backend=backend,
                     trace_every=1)
    res = staged.query_many(qi, qv)
    assert [s.name for s in staged.last_trace.spans] == list(QUERY_STAGES)
    plain = TServer(T, k=10, kprime=80, score_backend=backend)
    np.testing.assert_array_equal(res.ids, plain.query_many(qi, qv).ids)
    assert res.row(2, k=3).ids.shape == (3,)


@pytest.mark.parametrize("cell", ["bf16", "f8", "f32"])
def test_state_from_numpy_searches_like_reference(cell):
    J, _ = _pair(cell)
    st = J.state
    leaves = {"mappings": np.asarray(st.mappings), "u": np.asarray(st.u),
              "l": None if st.l is None else np.asarray(st.l),
              "bits": np.asarray(st.bits),
              "store_indices": np.asarray(st.store.indices),
              "store_values": np.asarray(st.store.values),
              "active": np.asarray(st.active), "ids": np.asarray(st.ids),
              "dirty": np.asarray(st.dirty)}
    assert set(leaves) == set(convert.LEAVES)
    spec = teng.EngineSpec(n=DS.n, capacity=320, m=24, h=2, max_nnz=64,
                           dtype=cell, value_dtype="float32", seed=1)
    T = teng.SinnamonIndex.from_numpy(spec, leaves, J._free, J._id2slot,
                                      device="cpu")
    assert T.size == J.size and T.doc_ids() == J.doc_ids()
    qi, qv = jsynth.make_queries(5, DS, 10, pad=24)
    want, wsc = J.search_many(qi, qv, k=10, kprime=80, backend="reference")
    got, gsc = T.search_many(qi, qv, k=10, kprime=80)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gsc, wsc, rtol=1e-5, atol=1e-6)
    # the carried-over index keeps streaming like the reference
    idx, val = jsynth.make_corpus(9, DS, 5, pad=64)
    for index in (J, T):
        index.insert_many([1000 + i for i in range(5)], idx, val)
    want, _ = J.search_many(qi, qv, k=10, kprime=80, backend="reference")
    np.testing.assert_array_equal(T.search_many(qi, qv, k=10, kprime=80)[0],
                                  want)


def test_open_index_defaults_to_cuda():
    cfg = tapi.IndexConfig(n=100, capacity=64, m=8)
    if torch.cuda.is_available():
        assert tapi.open_index(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.open_index(cfg)
    index = tapi.open_index(cfg, device="cpu")
    assert index.device.type == "cpu" and index.config is cfg


def test_open_index_unported_rows_raise(tmp_path):
    """Every row of the reference's routing table opens its index now: the
    tiered rows (ROADMAP item 10) and the sharded rows (item 11); durable +
    sharded + tiered raises, as in the reference."""
    from repro_torch.persist import durable
    from repro_torch.serving import sharded
    dur = tapi.DurabilityConfig(wal_dir=str(tmp_path / "wal"))
    with pytest.raises(NotImplementedError, match="durability"):
        tapi.open_index(tapi.IndexConfig(n=100, capacity=64, shards=2,
                                         durability=dur,
                                         device_budget_mb=8.0),
                        device="cpu")
    for kw, cls in ((dict(device_budget_mb=8.0), teng.TieredSinnamonIndex),
                    (dict(device_budget_mb=8.0, durability=dur),
                     durable.DurableTieredSinnamonIndex),
                    (dict(shards=2), sharded.ShardedSinnamonIndex),
                    (dict(shards=2, durability=tapi.DurabilityConfig(
                        wal_dir=str(tmp_path / "wal2"))),
                     durable.DurableShardedSinnamonIndex),
                    (dict(shards=2, device_budget_mb=8.0),
                     sharded.TieredShardedSinnamonIndex)):
        index = tapi.open_index(tapi.IndexConfig(n=100, capacity=64, **kw),
                                device="cpu")
        assert type(index) is cls
        assert getattr(index, "n_shards", 1) == kw.get("shards", 1)
    with pytest.raises(ValueError):
        tapi.IndexConfig(n=100, capacity=64, backend="tpu")


def _pallas_pair(how, monkeypatch):
    """A reference and a port index over the same corpus, with the fused
    backend named ``pallas`` by config or by ``REPRO_SCORE_BACKEND``."""
    idx, val = jsynth.make_corpus(2, DS, 300, pad=64)
    kw = dict(n=DS.n, capacity=320, m=24, h=2, max_nnz=64,
              cell_dtype="bf16", store_dtype="float32", seed=1)
    if how == "config":
        kw["backend"] = "pallas"
    else:
        monkeypatch.setenv("REPRO_SCORE_BACKEND", "pallas")
    J = japi.open_index(japi.IndexConfig(**kw))
    T = tapi.open_index(tapi.IndexConfig(**kw), device="cpu")
    for index in (J, T):
        index.insert_many(list(range(300)), idx, val)
        for d in range(0, 300, 7):
            index.delete(d)
    return J, T


@pytest.mark.parametrize("how", ["config", "env"])
def test_pallas_backend_name_serves_like_reference(how, monkeypatch):
    """``pallas`` (the reference's name for the fused backend) works in the
    port by config and by environment: the same ids as ``repro`` on the
    same corpus, the same ids as ``fused``, and results labelled
    ``fused``."""
    J, T = _pallas_pair(how, monkeypatch)
    qi, qv = jsynth.make_queries(6, DS, 8, pad=24)
    jr = JServer(J, k=10, kprime=80,
                 registry=obs_metrics.NULL_REGISTRY).query_many(qi, qv)
    assert jr.backend == "pallas"
    tr = TServer(T, k=10, kprime=80).query_many(qi, qv)
    assert tr.backend == "fused"
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.scores, jr.scores, rtol=1e-5, atol=1e-6)
    for name in ("fused", "pallas"):
        res = TServer(T, k=10, kprime=80, score_backend=name).query_many(qi,
                                                                         qv)
        assert res.backend == "fused"
        np.testing.assert_array_equal(res.ids, tr.ids)
    got, _ = T.search_many(qi, qv, k=10, kprime=80, backend="pallas")
    np.testing.assert_array_equal(got, tr.ids)


def test_unknown_backend_name_raises(monkeypatch):
    from repro_torch.kernels import ops as tops
    assert tops.resolve_backend("pallas") == "fused"
    assert tops.resolve_backend("fused") == "fused"
    for bad in ("tpu", "Pallas", ""):
        with pytest.raises(ValueError, match="unknown score backend"):
            tops.resolve_backend(bad)
    monkeypatch.setenv("REPRO_SCORE_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown score backend"):
        tops.resolve_backend()
    monkeypatch.setenv("REPRO_SCORE_BACKEND", "pallas")
    assert tops.resolve_backend() == "fused"


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "repro", "ml_dtypes")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
import repro_torch.checkpoint.ckpt, repro_torch.fault, repro_torch.obs
import repro_torch.persist
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for pkg in ("obs", "fault", "checkpoint", "persist", "serving.frontend",
            "serving.loadgen", "storage.tiered", "serving.sharded",
            "distributed.mesh", "distributed.topk"):
    assert f"repro_torch.{pkg}" in names, pkg
assert not any(k.split(".")[0] in BLOCKED for k in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.abspath(SRC)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 62


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--docs", "300", "--queries", "8", "--query-batch", "4",
                   "--device", "cpu", "--m", "32"])
    out = capsys.readouterr().out
    assert "indexed 300 docs over 1 shard(s)" in out
    recall = float(out.split("recall@10=")[1].split()[0])
    assert 0.5 <= recall <= 1.0


def test_launcher_accepts_pallas_backend(capsys):
    """``--score-backend pallas``, as written for the reference launcher,
    serves through the port's fused backend."""
    from repro_torch.launch import serve as launcher
    assert launcher.parse_args(["--score-backend", "pallas"]).score_backend \
        == "pallas"
    launcher.main(["--docs", "300", "--queries", "8", "--query-batch", "4",
                   "--device", "cpu", "--m", "32", "--score-backend",
                   "pallas"])
    out = capsys.readouterr().out
    assert "indexed 300 docs over 1 shard(s)" in out
    recall = float(out.split("recall@10=")[1].split()[0])
    assert 0.5 <= recall <= 1.0
