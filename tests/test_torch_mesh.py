"""The mesh tooling of the port (``repro_torch.distributed.rules``, the mesh
helpers, each family's abstract parameters and logical axes,
``launch/cells.py`` and ``launch/dryrun.py``) against the reference's.

* The reference's own rule cases (``tests/test_distributed.py``) on the
  port, and the rule tables equal.
* ``spec_for`` parity, cell by cell: for every arch and on mesh shapes of
  1×1, 16×16 and 2×16×16 (mesh-shaped objects without devices, as the
  reference's tests use), the port's spec of every leaf of the parameters
  (and so of the AdamW moments, placed alike), of the batch, of the decode
  cache and of the retrieval state equals the reference's
  ``tuple(PartitionSpec)``.
* ``abstract_params`` / ``abstract_cache``: shapes and dtypes equal
  ``jax.eval_shape`` of the reference's for every arch's full config, on
  ``meta`` (nothing allocated).
* ``constrain`` returns its input without a mesh and on a one-device mesh;
  ``placements_for`` gives each rank the block a ``PartitionSpec`` gives
  it over a tuple of axes.
* The cells' ``meta`` equals the reference's ``cells.build(...).meta``.
* One subprocess (the fake process group is process-global) dry-runs a few
  cells: argument bytes per device equal the reference's local shard bytes
  from its ``spec_for`` on the same mesh shape, a 1×1 mesh issues no
  collective, the retrieval cell's all-gathers are exactly the merge's, and
  the depth extrapolation equals a full-depth run in argument bytes, FLOPs
  and collective counts.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import mesh as jmesh  # noqa: E402
from repro.distributed import rules as JR  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import sharded as jsharded  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.distributed import rules as R  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import sharded as tsharded  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class FakeMesh:
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"1x1": FakeMesh({"data": 1, "model": 1}),
          "16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _jpaths(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): v for path, v in flat}


def _jaxes(tree) -> dict:
    return _jpaths(tree, lambda x: isinstance(x, JR.L))


def _spec(p) -> tuple:
    return tuple(p)


# ---------------------------------------------------------------------------
# The reference's rule cases
# ---------------------------------------------------------------------------

def test_rules_tables_equal_reference():
    for ours, ref in ((R.TRAIN_RULES, JR.TRAIN_RULES),
                      (R.SERVE_RULES, JR.SERVE_RULES)):
        assert {k: [tuple(c) for c in v] for k, v in ours.items()} == \
            {k: [tuple(c) for c in v] for k, v in ref.items()}


def test_rules_divisibility_fallback():
    mesh = MESHES["1x1"]
    spec = R.spec_for(mesh, (64, 128), ("batch", "mlp"))
    assert spec == ("data", "model")
    assert spec == _spec(JR.spec_for(mesh, (64, 128), ("batch", "mlp")))


def test_rules_fallback_chain():
    mesh = MESHES["16x16"]
    # kv_heads=8 not divisible by 16 -> kv_seq takes (data, model)
    assert R.spec_for(mesh, (8, 32768, 128),
                      ("kv_heads", "kv_seq", None)) == (None,
                                                        ("data", "model"))
    assert R.spec_for(mesh, (128, 16, 32768, 128),
                      ("batch", "kv_heads", "kv_seq", None)) == ("data",
                                                                 "model")
    # a dimension of size 0 is replicated
    assert R.spec_for(mesh, (0, 64), ("batch", "mlp")) == (None, "model")


def test_corpus_and_batch_axes():
    mesh = FakeMesh({"pod": 1, "data": 1, "model": 1})
    assert tmesh.corpus_axes(mesh) == jmesh.corpus_axes(mesh) == ("pod",
                                                                  "model")
    assert tmesh.batch_axes(mesh) == jmesh.batch_axes(mesh) == ("data",)
    mesh = MESHES["2x16x16"]
    assert tmesh.n_shards(mesh, ("pod", "model")) == 32


# ---------------------------------------------------------------------------
# spec_for parity, cell by cell
# ---------------------------------------------------------------------------

def _param_cases(arch):
    """[(shape, port axes, reference axes)] of every parameter leaf."""
    tmod, jmod = registry.get(arch), jreg.get(arch)
    fam = tmod.FAMILY
    if fam == "retrieval":
        return []
    if fam == "gnn":
        shape = tmod.SHAPES["full_graph_sm"]
        tcfg, jcfg = tmod.full_config(shape), jmod.full_config(shape)
        tax, jax_ = tgnn.logical_axes(tcfg), jgnn.logical_axes(jcfg)
        jab = jgnn.abstract_params(jcfg)
    elif fam == "lm":
        tcfg, jcfg = tmod.full_config(), jmod.full_config()
        tax, jax_ = ttr.logical_axes(tcfg), jtr.logical_axes(jcfg)
        jab = jtr.abstract_params(jcfg)
    else:
        tcfg, jcfg = tmod.full_config(), jmod.full_config()
        tax, jax_ = trecsys.logical_axes(tcfg), jrecsys.logical_axes(jcfg)
        jab = jrecsys.abstract_params(jcfg)
    tflat, jflat, shapes = R.flat_axes(tax), _jaxes(jax_), _jpaths(jab)
    assert list(tflat) == list(jflat)
    return [(shapes[k].shape, tflat[k].axes, jflat[k].axes) for k in tflat]


def _batch_cases(arch):
    tmod = registry.get(arch)
    out = []
    for name, shape in tmod.SHAPES.items():
        if tmod.FAMILY == "lm":
            B, S = shape["batch"], shape["seq"]
            if shape["kind"] == "lm_decode":
                cfg = tmod.full_config()
                c = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
                out.append((c, ttr.cache_logical_axes()["k"].axes,
                            jtr.cache_logical_axes()["k"].axes))
                out.append(((B, 1), ("batch", None), ("batch", None)))
            else:
                out.append(((B, S), ("batch", "seq"), ("batch", "seq")))
        elif tmod.FAMILY == "recsys":
            cfg, B = tmod.full_config(), shape["batch"]
            shapes = ((B, cfg.n_dense), (B, cfg.n_sparse, cfg.multi_hot),
                      (B, cfg.seq_len), (B,), (B,))
            for s, t, j in zip(shapes, trecsys.batch_logical_axes(),
                               jrecsys.batch_logical_axes()):
                out.append((s, t.axes, j.axes))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_spec_for_parity(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cases = _param_cases(arch) + _batch_cases(arch)
    for shape, tax, jax_ in cases:
        assert tax == jax_
        assert R.spec_for(mesh, shape, tax) == \
            _spec(JR.spec_for(mesh, shape, jax_)), (shape, tax)
        for rules, jrules in ((R.SERVE_RULES, JR.SERVE_RULES),):
            assert R.spec_for(mesh, shape, tax, rules) == \
                _spec(JR.spec_for(mesh, shape, jax_, jrules))
    if registry.get(arch).FAMILY == "retrieval":
        ts = tsharded.state_pspecs(mesh)
        js = jsharded.state_pspecs(mesh)
        trim = lambda p: tuple(_spec(p)[:1]) if len(_spec(p)) == 2 and \
            _spec(p)[1] is None else _spec(p)                  # noqa: E731
        assert ts.mappings == _spec(js.mappings)
        assert ts.sketch == _spec(js.u) == _spec(js.l)
        assert ts.bits == _spec(js.bits)
        assert ts.store.indices == _spec(js.store.indices)
        assert ts.store.values == _spec(js.store.values)
        assert ts.active == _spec(js.active) and ts.dirty == _spec(js.dirty)
        assert ts.ids == trim(js.ids)         # int64[C] vs uint32[C, 2]
    else:
        assert cases


# ---------------------------------------------------------------------------
# Abstract parameters and caches
# ---------------------------------------------------------------------------

def _jdtype(x) -> str:
    return str(jnp.dtype(x.dtype))


def _tdtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", [a for a in registry.ARCHS
                                  if a != "sinnamon-engine"])
def test_abstract_params_match_eval_shape(arch):
    tmod, jmod = registry.get(arch), jreg.get(arch)
    fam = tmod.FAMILY
    if fam == "lm":
        tcfg, jcfg = tmod.full_config(), jmod.full_config()
        model, jab = ttr.abstract_params(tcfg), jtr.abstract_params(jcfg)
        S = tmod.SHAPES["decode_32k"]
        tc = ttr.abstract_cache(tcfg, S["batch"], S["seq"])
        jc = _jpaths(jtr.abstract_cache(jcfg, S["batch"], S["seq"]))
        for k, t in tc.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == jc[k].shape
            assert _tdtype(t) == _jdtype(jc[k])
        bf = ttr.abstract_params(tcfg, torch.bfloat16)
        assert all(t.dtype == torch.bfloat16 for t in bf.leaves().values())
    elif fam == "gnn":
        shape = tmod.SHAPES["full_graph_sm"]
        tcfg, jcfg = tmod.full_config(shape), jmod.full_config(shape)
        model, jab = tgnn.abstract_params(tcfg), jgnn.abstract_params(jcfg)
        assert tgnn.graph_logical_axes()._fields == \
            jgnn.graph_logical_axes()._fields
    else:
        tcfg, jcfg = tmod.full_config(), jmod.full_config()
        model = trecsys.abstract_params(tcfg)
        jab = jrecsys.abstract_params(jcfg)
    jflat = _jpaths(jab)
    leaves = model.leaves()
    assert list(leaves) == list(jflat)
    for k, t in leaves.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == jflat[k].shape, k
        assert _tdtype(t) == _jdtype(jflat[k]), k


# ---------------------------------------------------------------------------
# constrain and placements
# ---------------------------------------------------------------------------

def test_constrain_is_identity_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert R.constrain(x, None, ("batch", "mlp")) is x
    assert R.constrain(x, MESHES["1x1"], ("batch", "mlp")) is x
    assert R.gathered(x, None, ("fsdp", "mlp")) is x
    assert R.settled(x) is x


def test_placements_give_partitionspec_blocks():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_block

    mesh = FakeMesh({"pod": 2, "data": 4, "model": 2})
    shape = (16, 8, 6)
    spec = (("pod", "data"), "model")
    pl = R.placements_for(mesh, spec)
    assert pl == (Shard(0), Shard(0), Shard(1))
    sizes = (2, 4, 2)
    seen = set()
    for coord in np.ndindex(*sizes):
        loc, off = local_block(shape, sizes, list(coord), pl)
        assert tuple(loc) == R.local_shape(mesh, shape, spec) == (2, 4, 6)
        assert tuple(off) == R.block_offsets(mesh, shape, spec, coord)
        # the reference's linear index over (pod, data), major-to-minor
        assert off[0] == (coord[0] * 4 + coord[1]) * 2
        seen.add(tuple(off))
    assert len(seen) == 16
    assert R.placements_for(mesh, ()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        R.placements_for(mesh, (("data", "pod"),))


def test_param_axes_follow_the_dimension():
    """DLRM's MLP weights are [out, in] nn.Linear weights: each parameter
    takes its leaf's axes reversed."""
    cfg = registry.get("dlrm-rm2").smoke_config()
    model = trecsys.abstract_params(cfg)
    axes = {"tables": R.L("fields", "table_rows", None),
            "bot": {f"w{i}": R.L("fsdp", "mlp") if i == 0 else R.L(None, None)
                    for i in range(len(cfg.bot_mlp))} | {
                f"b{i}": R.L(None) for i in range(len(cfg.bot_mlp))},
            "top": trecsys.logical_axes(cfg)["top"]}
    from repro_torch.models import param_axes
    got = param_axes(model, axes)
    assert got["bot.0.weight"].axes == ("mlp", "fsdp")
    assert got["tables"].axes == ("fields", "table_rows", None)


# ---------------------------------------------------------------------------
# meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCHS)
def test_cell_meta_equals_reference(arch):
    jm = jmesh.single_device_mesh(("data", "model"))
    mod = registry.get(arch)
    for name, shape in mod.SHAPES.items():
        ref = jcells.build(arch, name, jm).meta
        assert cells.meta_for(mod, shape) == ref, name


def test_gnn_cells_wait_for_item_12b():
    """Item 12b's GNN cells: ``meta_for`` is the reference's (6 · edges ·
    (rotations + SO(2) products) · layers, tokens = edges) for every
    shape, and the sharded GNN's parameter specs are the reference's
    ``_param_pspecs``."""
    from repro.models import gnn_sharded as jgs
    from repro_torch.models import gnn_sharded as tgs

    mod = registry.get("equiformer-v2")
    for name, shape in mod.SHAPES.items():
        meta = cells.meta_for(mod, shape)
        assert meta["arch_kind"] == "gnn_train", name
        assert meta["tokens"] == shape["n_edges"], name
    cfg = mod.full_config(mod.SHAPES["ogb_products"])
    want = _jpaths(jgs._param_pspecs(cfg),
                   lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tgs.param_pspecs(cfg)
    assert set(got) == set(want)
    for k, spec in want.items():
        spec = list(_spec(spec))
        while spec and spec[-1] is None:        # canonical: trailing Nones
            spec.pop()
        assert got[k] == tuple(spec), k


def test_gnn_waits_raise_their_own_class():
    """What waited for item 12b places: the SO(2) weights' rows over
    ``model`` (``Shard(1)``), every other leaf and the data axes'
    placements replicated; the edges split over the data axes major to
    minor (``("pod", "data")`` on the multi-pod mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import gnn_sharded as tgs

    cfg = registry.get("equiformer-v2").smoke_config()
    for name in ("16x16", "2x16x16"):
        mesh = MESHES[name]
        sh = tgs.param_shardings(cfg, mesh)
        model_dim = mesh.axis_names.index("model")
        for k, pl in sh.items():
            want = [Replicate()] * len(mesh.axis_names)
            if k.startswith("layers/so2/"):
                want[model_dim] = Shard(1)
            assert list(pl) == want, (name, k)
        assert tgs.data_axes(mesh) == tuple(
            a for a in mesh.axis_names if a != "model")


@pytest.mark.parametrize("raised,tag,code", [
    (ValueError("12288 edges do not split over 7"), "[FAIL]", 1),
    (NotImplementedError("Operator aten.index_add.default does not have a "
                         "sharding strategy registered"), "[FAIL]", 1),
    (RuntimeError("a broken cell"), "[FAIL]", 1)])
def test_dryrun_cli_waits_only_for_item_12b(monkeypatch, capsys, raised, tag,
                                            code):
    """Nothing waits any more: any error of a cell (a GNN cell's among
    them, and DTensor's ``NotImplementedError`` for a missing sharding
    strategy) is a ``[FAIL]`` and makes the run exit 1."""
    from repro_torch.launch import dryrun

    def run_cell(*a, **k):
        raise raised

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    try:
        dryrun.main(["--arch", "dlrm-rm2", "--shape", "serve_p99"])
        got = 0
    except SystemExit as e:
        got = e.code
    out = capsys.readouterr().out
    assert got == code
    assert f"{tag} dlrm-rm2/serve_p99/16x16" in out


# ---------------------------------------------------------------------------
# The dry run, in one subprocess
# ---------------------------------------------------------------------------

_DRYRUN = r"""
import json, sys, types
import torch
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.distributed import rules as R

out = {}
for name, ms in (("16x16", ((16, 16), ("data", "model"))),
                 ("1x1", ((1, 1), ("data", "model")))):
    r = dryrun.run_cell("dlrm-rm2", "serve_p99", mesh_shape=ms)
    out["dlrm_" + name] = {"arg": r["arg_bytes"],
                           "counts": r["collectives"]["counts"]}
r = dryrun.run_cell("sinnamon-engine", "serve_msmarco")
out["retrieval"] = {"arg": r["arg_bytes"],
                    "counts": r["collectives"]["counts"]}
r = dryrun.run_cell("sinnamon-engine", "serve_msmarco", multi_pod=True)
out["retrieval_mp"] = {"arg": r["arg_bytes"],
                       "counts": r["collectives"]["counts"]}

def depth(arch, shape):
    mod = registry.get(arch)
    small = types.SimpleNamespace(FAMILY="lm", full_config=mod.smoke_config)
    ms = ((2, 2), ("data", "model"))
    ext, _, d = dryrun.trace(small, shape, *ms)
    full, _, _ = dryrun.trace(small, shape, *ms, full_depth=True)
    return {"ext": ext, "full": full, "traced": d["traced"]}

mod = registry.get("equiformer-v2")
fig, meta, _ = dryrun.trace(mod, mod.SHAPES["molecule"], (16, 16),
                            ("data", "model"), n_layers=1)
out["gnn"] = {"arg": fig["arg_bytes"], "temp": fig["temp_bytes"],
              "counts": fig["collectives"]["counts"], "meta": meta}

out["depth_train"] = depth("stablelm-12b",
                           {"kind": "lm_train", "batch": 4, "seq": 64})
out["depth_gemma"] = depth("gemma3-27b",
                           {"kind": "lm_decode", "batch": 4, "seq": 64})
print("JSON" + json.dumps(out))
"""


def _ref_local_bytes(mesh, tree_abs: dict, tree_axes: dict) -> int:
    total = 0
    for k, ab in tree_abs.items():
        spec = JR.spec_for(mesh, ab.shape, tree_axes[k].axes)
        n = 1
        for d, e in zip(ab.shape, tuple(spec) + (None,) * len(ab.shape)):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= d // math.prod(mesh.shape[a] for a in axes)
        total += n * jnp.dtype(ab.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def dryrun_out():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _DRYRUN], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


def _dlrm_ref_bytes(mesh) -> int:
    cfg = jreg.get("dlrm-rm2").full_config()
    B = jreg.get("dlrm-rm2").SHAPES["serve_p99"]["batch"]
    params = _jpaths(jrecsys.abstract_params(cfg))
    axes = _jaxes(jrecsys.logical_axes(cfg))
    batch = jcells._recsys_batch_abs(cfg, B)
    bax = jrecsys.batch_logical_axes()
    return (_ref_local_bytes(mesh, params, axes)
            + _ref_local_bytes(mesh, dict(zip(batch._fields, batch)),
                               dict(zip(bax._fields, bax))))


@pytest.mark.parametrize("mesh_name", ["16x16", "1x1"])
def test_dryrun_arg_bytes_equal_reference_shards(dryrun_out, mesh_name):
    got = dryrun_out["dlrm_" + mesh_name]
    assert got["arg"] == _dlrm_ref_bytes(MESHES[mesh_name])
    if mesh_name == "1x1":
        assert sum(got["counts"].values()) == 0


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
def test_dryrun_retrieval_gathers_are_the_merge(dryrun_out, mesh_name):
    got = dryrun_out["retrieval" if mesh_name == "16x16"
                     else "retrieval_mp"]
    mesh = MESHES[mesh_name]
    corpus = [a for a in tmesh.corpus_axes(mesh) if mesh.shape[a] > 1]
    # values, ids and locators, one all-gather each per corpus axis
    assert got["counts"] == {"all-gather": 3 * len(corpus),
                             "all-reduce": 0, "reduce-scatter": 0,
                             "all-to-all": 0, "collective-permute": 0}
    # the state's local shards, as the reference's state_pspecs place its
    # leaves (u and l are the port's sketch rows, the uint32[C, 2] ids its
    # int64[C]), and the data-sharded queries
    mod = jreg.get("sinnamon-engine")
    shape = mod.SHAPES["serve_msmarco"]
    n = jmesh.n_shards(mesh, jmesh.corpus_axes(mesh))
    spec = mod.full_config(shape, n)
    C = spec.capacity * n
    sp = jsharded.state_pspecs(mesh)
    leaves = [((spec.h, spec.n), 4, sp.mappings), ((spec.m, C), 2, sp.u),
              ((spec.m, C), 2, sp.l), ((spec.n, C // 32), 4, sp.bits),
              ((C, spec.max_nnz), 4, sp.store.indices),
              ((C, spec.max_nnz), 2, sp.store.values), ((C,), 1, sp.active),
              ((C, 2), 4, sp.ids), ((C,), 1, sp.dirty)]
    ref = 0
    for shp, size, p in leaves:
        n_el = 1
        for d, e in zip(shp, tuple(p) + (None,) * len(shp)):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            n_el *= d // math.prod(mesh.shape[a] for a in axes)
        ref += n_el * size
    B, Lq = shape["batch"], shape["psi_q"]
    ref += 2 * (B // mesh.shape["data"]) * Lq * 4
    assert got["arg"] == ref


@pytest.mark.parametrize("case", ["depth_train", "depth_gemma"])
def test_dryrun_depth_extrapolation_equals_full_depth(dryrun_out, case):
    got = dryrun_out[case]
    ext, full = got["ext"], got["full"]
    assert ext["arg_bytes"] == full["arg_bytes"]
    assert ext["flops"] == full["flops"]
    assert ext["collectives"]["counts"] == full["collectives"]["counts"]
    assert ext["collectives"]["total"] == full["collectives"]["total"]
    if case == "depth_gemma":
        assert got["traced"] == ["1", "2", "1 global"]


def test_dryrun_gnn_cell(dryrun_out):
    """equiformer-v2 ``molecule`` through ``cells.build_gnn`` on a 16x16
    fake world at 1 layer: argument bytes are the local shards of the
    reference's placements (the sharded GNN's parameter specs, moments
    alike, the node tensors whole and the edges over ``data``); the layer
    gathers its carry once, again in its recompute and once in the
    reduce-scatter's backward (3 all-gathers), reduce-scatters ``w_out``'s
    product alike (3); the device holds well under 80 GB."""
    from repro.models import gnn_sharded as jgs

    got = dryrun_out["gnn"]
    mod = jreg.get("equiformer-v2")
    shape = mod.SHAPES["molecule"]
    cfg = dataclasses.replace(mod.full_config(shape), n_layers=1)
    mesh = MESHES["16x16"]
    specs = _jpaths(jgs._param_pspecs(cfg),
                    lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = _jpaths(jgnn.abstract_params(cfg))
    state = 0
    for k, ab in params.items():
        n = ab.size // math.prod(mesh.shape[a] for a in _spec(specs[k])
                                 if a is not None)
        state += n * (ab.dtype.itemsize + 8)        # parameter, m and v
    pn, pe, G = shape["pad_nodes"], shape["pad_edges"], shape["batch_graphs"]
    graph = (pn * shape["d_feat"] * 4 + pn * 3 * 4 + pn * 4 + G * 4
             + (pe // mesh.shape["data"]) * (4 + 4 + 12))
    assert got["arg"] == state + 4 + graph
    assert got["counts"]["all-gather"] == 3
    assert got["counts"]["reduce-scatter"] == 3
    assert got["arg"] + got["temp"] < 80e9
    assert got["meta"] == jcells.build("equiformer-v2", "molecule",
                                       jmesh.single_device_mesh(
                                           ("data", "model"))).meta
