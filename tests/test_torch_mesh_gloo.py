"""The models' mesh paths on real values: four CPU processes in a ``gloo``
process group, a 2×2 ``("data", "model")`` mesh, each path with ``mesh``
against the same path with ``mesh=None`` on the same inputs.

The dry run (``launch/dryrun.py``) runs the mesh paths on fake tensors,
and a one-device mesh skips them, so this is where their arithmetic is
checked: attention and decode attention on each device's local block,
the FSDP weights gathered at use, the vocab-parallel cross-entropy, MoE
routing on each device's groups, DLRM's bags on each device's row block
(and the Gram pairs on its batch rows), AdamW on local blocks with one
all-reduce for the global norm, and the mesh search step's all-gathers
over two corpus shards.  The cases:

* stablelm and moonshot (MoE) smoke configs at 2 layers in f32: the loss,
  every leaf's gradient, and one train step (the loss, the global norm,
  the parameters and both AdamW moments after it);
* a decode step whose cache falls back from ``kv_heads`` to ``kv_seq``
  (3 KV heads do not split over ``model``=2, so the cache's sequence is
  sharded): the logits and the cache after the write;
* dlrm-rm2's smoke config, the same train quantities; and a multi-hot
  variant with pads on a ``("pod", "model")`` mesh, where the tables'
  rows split over both axes and the batch over ``pod`` (the indices are
  all-gathered over ``pod`` and the bags reduce-scattered back);
* ``make_search_step`` over two corpus shards against
  ``ShardedSinnamonIndex`` with two shards: ids, scores and locators
  bit-equal on every rank's rows.

Tolerance: the mesh paths sum the same f32 products in another order
(contractions split over two shards, then all-reduced), so each tensor is
held within ``TOL`` = 1e-5 of its largest magnitude under ``mesh=None``
(the runs here stay below 1.5e-6: about ten f32 ulps of the scale).  The
search step computes each shard exactly as the index does, so it is held
bit for bit.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
TOL = 1e-5

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import registry
from repro_torch.core import engine as eng
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed import rules as R
from repro_torch.models import param_axes, recsys
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.serving import sharded
from repro_torch.train import loop

MESH = meshlib.make_mesh((2, 2), ("data", "model"), "cpu")
res = {}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def place(t, logical, mesh):
    return distribute_tensor(t.detach().clone(), mesh,
                             R.sharding_for(mesh, t.shape, logical))


def place_model(model, axes, mesh):
    by_name = param_axes(model, axes)
    for name, p in list(model.named_parameters()):
        owner = model
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, nn.Parameter(
            place(p, by_name[name].axes, mesh), requires_grad=True))
    return model


def err(a, b):
    a, b = full(a).detach().double(), full(b).detach().double()
    assert a.shape == b.shape, (a.shape, b.shape)
    return {"err": float((a - b).abs().max()) if a.numel() else 0.0,
            "scale": float(b.abs().max()) if b.numel() else 0.0}


def leaf_errs(ma, mb, grad):
    la, lb = ma.leaves(grad=grad), mb.leaves(grad=grad)
    return {k: err(la[k], lb[k]) for k in lb}


def train_case(name, make, axes, loss_fn, batch, batch_axes, mesh):
    plain, meshed = make(), place_model(make(), axes, mesh)
    bm = [place(t, a, mesh) for t, a in zip(batch, batch_axes)]
    bm = type(batch)(*bm) if hasattr(batch, "_fields") else tuple(bm)
    out = {}
    with implicit_replication():
        lp, _ = loss_fn(plain, batch, None)
        lp.backward()
        lm, _ = loss_fn(meshed, bm, mesh)
        lm.backward()
        out["loss"] = err(lm, lp)
        out["grads"] = leaf_errs(meshed, plain, True)
        for m in (plain, meshed):
            for t in m.parameters():
                t.grad = None
        sp = loop.TrainState(plain, adamw.init(plain.leaves()), None)
        ax = R.flat_axes(axes)
        lv = meshed.leaves()
        zero = lambda k: place(torch.zeros(lv[k].shape), ax[k].axes, mesh)
        sm = loop.TrainState(meshed, adamw.OptState(
            m={k: zero(k) for k in lv}, v={k: zero(k) for k in lv},
            step=place(torch.zeros((), dtype=torch.int32), (), mesh)), None)
        step = lambda m: loop.make_train_step(
            lambda p, b: loss_fn(p, b, m), adamw.AdamWConfig())
        sp, mp = step(None)(sp, batch)
        sm, mm = step(mesh)(sm, bm)
        out["step_loss"] = err(mm["loss"], mp["loss"])
        out["grad_norm"] = err(mm["grad_norm"], mp["grad_norm"])
        out["params"] = leaf_errs(meshed, plain, False)
        out["m"] = {k: err(sm.opt.m[k], sp.opt.m[k]) for k in sp.opt.m}
        out["v"] = {k: err(sm.opt.v[k], sp.opt.v[k]) for k in sp.opt.v}
    res[name] = out


def lm_cfg(arch, **kw):
    return dataclasses.replace(registry.get(arch).smoke_config(),
                               dtype="float32", n_layers=2, **kw)


# -- LM train: dense and MoE -----------------------------------------------------
for arch in ("stablelm-12b", "moonshot-v1-16b-a3b"):
    cfg = lm_cfg(arch)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65))).int()

    def lm_loss(p, b, m, cfg=cfg):
        return tr.lm_loss(p, b[0], b[1], cfg, mesh=m)

    train_case(arch, lambda cfg=cfg: tr.init_params(
        torch.Generator().manual_seed(1), cfg, device="cpu"),
        tr.logical_axes(cfg), lm_loss,
        (toks[:, :-1].contiguous(), toks[:, 1:].contiguous()),
        (("batch", "seq"),) * 2, MESH)

# -- LM decode with the cache's sequence sharded (kv_heads -> kv_seq) --------
cfg = lm_cfg("stablelm-12b", n_kv_heads=3)
make = lambda: tr.init_params(torch.Generator().manual_seed(3), cfg,
                              device="cpu")
plain, meshed = make(), place_model(make(), tr.logical_axes(cfg), MESH)
rng = np.random.default_rng(4)
B, S, pos = 4, 64, 50
cache = {k: torch.from_numpy(rng.standard_normal(
    (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)).astype(np.float32))
    for k in ("k", "v")}
cax = tr.cache_logical_axes()
tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).int()
with implicit_replication():
    lp, cp = tr.decode_step(plain, {k: v.clone() for k, v in cache.items()},
                            tok, pos, cfg)
    lm, cm = tr.decode_step(
        meshed, {k: place(v, cax[k].axes, MESH) for k, v in cache.items()},
        place(tok, ("batch", None), MESH), pos, cfg, mesh=MESH)
res["decode"] = {
    "cache_spec": list(map(str, R.spec_for(MESH, cache["k"].shape,
                                           cax["k"].axes))),
    "logits": err(lm, lp), "k": err(cm["k"], cp["k"]),
    "v": err(cm["v"], cp["v"])}

# -- DLRM: one-hot on (data, model), multi-hot with pads on (pod, model) ----
def dlrm_case(name, cfg, mesh):
    rng = np.random.default_rng(6)
    B = 8
    sparse = rng.integers(0, cfg.vocab_per_field,
                          (B, cfg.n_sparse, cfg.multi_hot))
    if cfg.multi_hot > 1:
        sparse[rng.random(sparse.shape) < 0.3] = -1
    batch = recsys.RecsysBatch(
        dense=torch.from_numpy(
            rng.standard_normal((B, cfg.n_dense)).astype(np.float32)),
        sparse=torch.from_numpy(sparse).int(),
        hist=torch.zeros((B, 1), dtype=torch.int32),
        target=torch.zeros((B,), dtype=torch.int32),
        labels=torch.from_numpy(rng.integers(0, 2, B).astype(np.float32)))
    axes = recsys.logical_axes(cfg)
    train_case(name, lambda: recsys.init_params(
        torch.Generator().manual_seed(5), cfg, device="cpu"), axes,
        lambda p, b, m: (recsys.loss(p, b, cfg, mesh=m), {}), batch,
        [a.axes for a in recsys.batch_logical_axes()], mesh)
    res[name]["table_spec"] = list(map(str, R.spec_for(
        mesh, (cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim),
        axes["tables"].axes)))


cfg = registry.get("dlrm-rm2").smoke_config()
dlrm_case("dlrm-rm2", cfg, MESH)
dlrm_case("dlrm-rm2-multihot", dataclasses.replace(cfg, multi_hot=3),
          meshlib.make_mesh((2, 2), ("pod", "model"), "cpu"))

# -- the mesh search step against the one-process sharded index ----------------
spec = eng.EngineSpec(n=400, m=16, capacity=64, max_nnz=48, h=2, seed=3,
                      value_dtype="float32")
rng = np.random.default_rng(7)


def sparse_rows(n_rows, nnz_max, pad):
    idx = np.full((n_rows, pad), -1, np.int32)
    val = np.zeros((n_rows, pad), np.float32)
    for r in range(n_rows):
        nnz = rng.integers(1, nnz_max + 1)
        idx[r, :nnz] = np.sort(rng.choice(spec.n, nnz, replace=False))
        val[r, :nnz] = rng.random(nnz).astype(np.float32)
    return idx, val


idx, val = sparse_rows(100, 40, 48)
qi, qv = sparse_rows(4, 16, 24)
index = sharded.ShardedSinnamonIndex(spec, "cpu", n_shards=2)
index.insert_many(np.arange(100) * 7 + 3, idx, val)
shard = meshlib.linear_index(MESH, meshlib.corpus_axes(MESH))
st = index.shards[shard].state
specs = sharded.state_pspecs(MESH)


def glob(t, pspec, slot_dim):
    shape = list(t.shape)
    if slot_dim is not None:
        shape[slot_dim] *= 2
    return DTensor.from_local(t, MESH, R.placements_for(MESH, pspec),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape).stride())


state = eng.SinnamonState(
    mappings=glob(st.mappings, specs.mappings, None),
    sketch=glob(st.sketch, specs.sketch, 1),
    bits=glob(st.bits, specs.bits, 1),
    store=type(st.store)(glob(st.store.indices, specs.store.indices, 0),
                         glob(st.store.values, specs.store.values, 0)),
    active=glob(st.active, specs.active, 0),
    ids=glob(st.ids, specs.ids, 0), dirty=glob(st.dirty, specs.dirty, 0),
    m=st.m)
q = tuple(place(torch.from_numpy(a), ("batch", None), MESH) for a in (qi, qv))
d = MESH.get_local_rank(0)
rows = slice(2 * d, 2 * d + 2)
res["search"] = {}
for k, kl in ((10, 40), (25, 16)):
    ids_p, sc_p, loc_p = index.search_many(qi, qv, k, kprime=kl,
                                           return_locators=True)
    sc, ids, loc = sharded.make_search_step(MESH, spec, k=k,
                                            kprime_local=kl)(state, *q)
    res["search"][f"k{k}_kprime{kl}"] = {
        "got": [sc.tolist(), ids.tolist(), loc.tolist()],
        "want": [sc_p[rows].tolist(), ids_p[rows].tolist(),
                 loc_p[rows].tolist()]}

with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (a list of WORLD dicts)."""
    out = str(tmp_path_factory.mktemp("gloo") / "rank")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(WORLD), port, out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, e = p.communicate(timeout=600)
            errs.append(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-4000:]}"
    res = []
    for r in range(WORLD):
        with open(f"{out}.{r}") as f:
            res.append(json.load(f))
    return res


def _within(e: dict, what: str) -> None:
    assert e["err"] <= TOL * max(e["scale"], 1e-30), (what, e)


TRAIN = ("stablelm-12b", "moonshot-v1-16b-a3b", "dlrm-rm2",
         "dlrm-rm2-multihot")


@pytest.mark.parametrize("case", TRAIN)
@pytest.mark.parametrize("what", ["loss", "step_loss", "grad_norm"])
def test_train_scalars_match_without_mesh(ranks, case, what):
    for r, res in enumerate(ranks):
        _within(res[case][what], f"rank {r} {case} {what}")


@pytest.mark.parametrize("case", TRAIN)
@pytest.mark.parametrize("what", ["grads", "params", "m", "v"])
def test_train_leaves_match_without_mesh(ranks, case, what):
    """Every leaf's gradient, and the parameters and AdamW moments after
    one step."""
    for r, res in enumerate(ranks):
        leaves = res[case][what]
        assert leaves, case
        for k, e in leaves.items():
            _within(e, f"rank {r} {case} {what} {k}")


def test_dlrm_tables_split_as_intended(ranks):
    assert ranks[0]["dlrm-rm2"]["table_spec"] == ["None", "model"]
    assert ranks[0]["dlrm-rm2-multihot"]["table_spec"] == [
        "None", "('pod', 'model')"]


@pytest.mark.parametrize("what", ["logits", "k", "v"])
def test_decode_with_sequence_sharded_cache(ranks, what):
    for r, res in enumerate(ranks):
        # the cache really fell back to its sequence axis
        assert res["decode"]["cache_spec"] == ["None", "data", "None",
                                               "model"]
        _within(res["decode"][what], f"rank {r} decode {what}")


@pytest.mark.parametrize("search", ["k10_kprime40", "k25_kprime16"])
def test_search_step_equals_sharded_index(ranks, search):
    """Scores, ids and (shard, slot) locators of every rank's query rows,
    bit for bit."""
    for r, res in enumerate(ranks):
        got = res["search"][search]
        assert got["got"] == got["want"], f"rank {r}"
