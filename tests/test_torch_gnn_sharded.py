"""The sharded GNN (``repro_torch.models.gnn_sharded``), ``compressed_psum``
and the compressed train step on real values.

Four CPU processes in a ``gloo`` process group run the port; one JAX
process with four forced host devices runs the reference
(``repro.models.gnn_sharded``, ``repro.optim.compress`` under
``shard_map``).  Both read the same seeded numpy inputs: a 16-node,
32-edge geometric graph (``node_class``) and four 4-atom molecules
(``energy_force``), the reference test's config (c=8, l_max=2, m_max=1,
2 layers, edge chunk 8), parameters drawn with numpy by the reference's
law.  The cases:

* the port's ``loss_fn_sharded`` against its ``gnn.loss_fn(mesh=None)``,
  both tasks, H=2, on a 2x2 ``(data, model)`` mesh and a 2x2x1
  ``(pod, data, model)`` mesh (the data axes two): the loss, every
  gradient leaf, and the parameters and both AdamW moments after one
  step, within ``TOL`` = 1e-5 of each tensor's largest magnitude (the
  mesh sums the same f32 terms in another order, as in
  ``tests/test_torch_mesh_gloo.py``); plain parameters that every rank
  holds whole (energy_force, 2x2), and ``gnn.loss_fn(mesh)`` (DTensor
  parameters and batch) on the 2x2 mesh, likewise;
* H=1, where the reference's sharded GNN computes its one-device
  function: the port's sharded loss and gradients against the
  reference's ``loss_fn_sharded`` on 2x2, within ``TOL``; H=2: the
  port's sharded GNN against the reference's one-device ``gnn.loss_fn``
  (run in this process), within ``TOL``;
* the reference's two head faults (ROADMAP.md Queue 3 item 4): H=2 on
  4x1 with the drawn ``w_out`` (it mixes each edge's channels before
  their heads' weights) and H=2 on 2x2 with ``w_out`` the identity (it
  gives local channel j the head j // (Cl/H)): the reference's sharded
  loss is off its one-device loss by more than 1e-5 of the loss, the
  port's is not;
* ``compressed_psum`` over ``("pod",)`` of 4 against the reference's
  under ``shard_map``, bit for bit, and within a quantisation step of
  the exact mean (the reference's own test);
* 3 compressed train steps of the small GNN on ``("pod",)`` of 4 (each
  rank its own graph): every rank's parameters alike, and the residuals
  and parameters equal to the same steps computed on the host from the
  ranks' gradients (the quantisation in numpy, bit for bit; the update by
  the reference's AdamW, within 1e-6 of scale).
"""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.models import gnn as jgnn  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.convert import flatten_tree, unflatten_tree  # noqa: E402
from repro_torch.data import graph as graphdata  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
TOL = 1e-5
CFG = dict(n_layers=2, c=8, l_max=2, m_max=1, n_rbf=4, f_in=5,
           edge_chunk=8)
STEPS = 3
LR = 1e-2


def _cfg(H, task="node_class"):
    return tgnn.GNNConfig(n_heads=H, task=task,
                          n_out=3 if task == "node_class" else 1, **CFG)


def _draw(cfg, seed, eye_out=False) -> dict:
    """Parameters by the reference's law (N(0, 1) / sqrt(fan_in), ``ln``
    at 1), drawn with numpy; ``eye_out``: each degree's ``w_out`` the
    identity."""
    rng = np.random.default_rng(seed)
    nrm = lambda shape, fan: rng.standard_normal(shape) / math.sqrt(fan)
    out = {"embed_in": nrm((cfg.f_in, cfg.c), cfg.f_in)}
    for path, (shape, fan) in tgnn._layer_shapes(cfg).items():
        full = (cfg.n_layers, *shape)
        out[f"layers/{path}"] = np.ones(full) if fan is None else \
            nrm(full, fan)
    out.update(ro1=nrm((cfg.c, cfg.c), cfg.c),
               ro2=nrm((cfg.c, cfg.n_out), cfg.c),
               force_w=nrm((cfg.c, 1), cfg.c))
    if eye_out:
        out["layers/w_out"] = np.broadcast_to(
            np.eye(cfg.c), out["layers/w_out"].shape).copy()
    return {k: v.astype(np.float32) for k, v in out.items()}


PARAMS = {"h2_node_class": (2, "node_class", 1, False),
          "h2_energy_force": (2, "energy_force", 2, False),
          "h1": (1, "node_class", 3, False),
          "eye": (2, "node_class", 4, True)}


def _graphs() -> dict:
    return {"node_class": graphdata.random_geometric_graph(0, 16, 32, 5, 3),
            "energy_force": graphdata.molecule_batch(0, 4, 4, 8, 5)}


def _inputs(path: str) -> None:
    arrays = {}
    for name, (H, task, seed, eye) in PARAMS.items():
        for k, v in _draw(_cfg(H, task), seed, eye).items():
            arrays[f"{name}/{k}"] = v
    for task, g in _graphs().items():
        for k, v in g._asdict().items():
            arrays[f"graph_{task}/{k}"] = np.asarray(v)
    rng = np.random.default_rng(9)
    arrays["compress/a"] = rng.normal(0, 1, (WORLD, 64)).astype(np.float32)
    arrays["compress/ra"] = rng.normal(0, 0.01, (WORLD, 64)).astype(
        np.float32)
    arrays["compress/b"] = rng.normal(0, 3, (WORLD, 3, 5)).astype(np.float32)
    arrays["compress/b"][:, 0, :2] = [127.5, -0.0]
    arrays["compress/rb"] = np.zeros((WORLD, 3, 5), np.float32)
    np.savez(path, **arrays)


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed import mesh as meshlib
from repro.models import gnn, gnn_sharded
from repro.optim import compress

D = np.load(sys.argv[1])
CFG = dict(n_layers=2, c=8, l_max=2, m_max=1, n_rbf=4, f_in=5, n_out=3,
           edge_chunk=8, remat=False)


def tree(prefix):
    out = {}
    for k in D.files:
        if k.startswith(prefix + "/"):
            node = out
            *parents, leaf = k[len(prefix) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(D[k])
    return out


gt = tree("graph_node_class")
g = gnn.GraphBatch(**{k: v for k, v in gt.items() if k != "n_graphs"},
                   n_graphs=1)
out = {}


def sharded(params, H, shape, grad=False):
    cfg = gnn.GNNConfig(n_heads=H, **CFG)
    mesh = meshlib.make_mesh(shape, ("data", "model"))
    f = lambda p: gnn_sharded.loss_fn_sharded(p, g, cfg, mesh)[0]
    with mesh:
        return jax.jit(jax.value_and_grad(f) if grad else f)(params)


def one(params, H):
    cfg = gnn.GNNConfig(n_heads=H, **CFG)
    return jax.jit(lambda p: gnn.loss_fn(p, g, cfg)[0])(params)


loss, grads = sharded(tree("h1"), 1, (2, 2), grad=True)
out["h1/loss"] = np.asarray(loss)
for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    key = "/".join(str(getattr(p, "key", p)) for p in path)
    out["h1/grad/" + key] = np.asarray(leaf)
out["fault_a/sharded"] = np.asarray(sharded(tree("h2_node_class"), 2,
                                            (4, 1)))
out["fault_a/one"] = np.asarray(one(tree("h2_node_class"), 2))
out["fault_b/sharded"] = np.asarray(sharded(tree("eye"), 2, (2, 2)))
out["fault_b/one"] = np.asarray(one(tree("eye"), 2))

mesh = meshlib.make_mesh((4,), ("pod",))


def f(a, ra, b, rb):
    o, r = compress.compressed_psum({"a": a[0], "b": b[0]},
                                    {"a": ra[0], "b": rb[0]}, "pod")
    return o["a"][None], r["a"][None], o["b"][None], r["b"][None]


fn = shard_map(f, mesh=mesh, in_specs=(P("pod"),) * 4,
               out_specs=(P("pod"),) * 4)
res = fn(*(jnp.asarray(D["compress/" + k]) for k in ("a", "ra", "b", "rb")))
for k, v in zip(("mean_a", "res_a", "mean_b", "res_b"), res):
    out["compress/" + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""

_WORKER = f"STEPS, LR = {STEPS}, {LR}\n" + r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch import nn

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import convert
from repro_torch.data import graph as graphdata
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed import rules as R
from repro_torch.models import gnn, param_axes
from repro_torch.models import gnn_sharded as gs
from repro_torch.optim import adamw, compress
from repro_torch.train import loop

D = np.load(inp)
CFG = dict(n_layers=2, c=8, l_max=2, m_max=1, n_rbf=4, f_in=5,
           edge_chunk=8)
MESHES = {name: meshlib.make_mesh(shape, axes, "cpu") for name, shape, axes
          in (("2x2", (2, 2), ("data", "model")),
              ("2x2x1", (2, 2, 1), ("pod", "data", "model")),
              ("4x1", (4, 1), ("data", "model")),
              ("pod4", (4,), ("pod",)))}
res = {}


def cfg_of(H, task="node_class"):
    return gnn.GNNConfig(n_heads=H, task=task,
                         n_out=3 if task == "node_class" else 1, **CFG)


def arrays(prefix):
    return {k[len(prefix) + 1:]: D[k] for k in D.files
            if k.startswith(prefix + "/")}


def graph(task):
    a = arrays("graph_" + task)
    return gnn.GraphBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in a.items() if k != "n_graphs"},
                          n_graphs=int(a["n_graphs"]))


def model(name, cfg):
    return convert.gnn_params_from_numpy(arrays(name), cfg, device="cpu")


def swap(m, make):
    for name, p in list(m.named_parameters()):
        owner = m
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, nn.Parameter(make(name, p)))
    return m


def sharded_model(m, cfg, mesh):
    sh = gs.param_shardings(cfg, mesh)
    return swap(m, lambda n, p: distribute_tensor(
        p.detach().clone(), mesh, sh[n.replace(".", "/")]))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(a, b):
    a, b = full(a).detach().double(), full(b).detach().double()
    assert a.shape == b.shape, (a.shape, b.shape)
    return {"err": float((a - b).abs().max()) if a.numel() else 0.0,
            "scale": float(b.abs().max()) if b.numel() else 0.0}


def leaf_errs(ma, mb, grad):
    la, lb = ma.leaves(grad=grad), mb.leaves(grad=grad)
    return {k: err(la[k], lb[k]) for k in lb}


def values(m, grad):
    return {k: full(t).detach().numpy().ravel().tolist()
            for k, t in m.leaves(grad=grad).items()}


def sharded_case(pname, H, task, mesh_name, step=True, whole=False):
    cfg, g, mesh = cfg_of(H, task), graph(task), MESHES[mesh_name]
    plain = model(pname, cfg)
    meshed = model(pname, cfg) if whole else \
        sharded_model(model(pname, cfg), cfg, mesh)
    lp, _ = gnn.loss_fn(plain, g, cfg)
    lp.backward()
    lm, _ = gs.loss_fn_sharded(meshed, g, cfg, mesh)
    lm.backward()
    out = {"loss": err(lm, lp), "grads": leaf_errs(meshed, plain, True),
           "loss_value": float(lm), "plain_loss": float(lp),
           "grad_values": values(meshed, True)}
    if not step:
        return out
    for m in (plain, meshed):
        for t in m.parameters():
            t.grad = None
    sp = loop.TrainState(plain, adamw.init(plain.leaves()), None)
    sh = gs.param_shardings(cfg, mesh)
    lv = meshed.leaves()
    zero = lambda k: distribute_tensor(torch.zeros(lv[k].shape), mesh, sh[k])
    sm = loop.TrainState(meshed, adamw.OptState(
        m={k: zero(k) for k in lv}, v={k: zero(k) for k in lv},
        step=distribute_tensor(torch.zeros((), dtype=torch.int32), mesh,
                               R.placements_for(mesh, ()))), None)
    cfg_o = adamw.AdamWConfig()
    sp, mp = loop.make_train_step(
        lambda p, b: gnn.loss_fn(p, b, cfg), cfg_o)(sp, g)
    sm, mm = loop.make_train_step(
        lambda p, b: gs.loss_fn_sharded(p, b, cfg, mesh), cfg_o)(sm, g)
    out["step_loss"] = err(mm["loss"], mp["loss"])
    out["params"] = leaf_errs(meshed, plain, False)
    out["m"] = {k: err(sm.opt.m[k], sp.opt.m[k]) for k in sp.opt.m}
    out["v"] = {k: err(sm.opt.v[k], sp.opt.v[k]) for k in sp.opt.v}
    return out


for task in ("node_class", "energy_force"):
    for mesh_name in ("2x2", "2x2x1"):
        res[f"h2/{task}/{mesh_name}"] = sharded_case(f"h2_{task}", 2, task,
                                                     mesh_name)
res["h1"] = sharded_case("h1", 1, "node_class", "2x2", step=False)
res["whole"] = sharded_case("h2_energy_force", 2, "energy_force", "2x2",
                            step=False, whole=True)
res["fault_a"] = sharded_case("h2_node_class", 2, "node_class", "4x1",
                              step=False)
res["fault_b"] = sharded_case("eye", 2, "node_class", "2x2", step=False)

# gnn.loss_fn on DTensors (the GSPMD-automatic path) on 2x2
cfg, mesh = cfg_of(2), MESHES["2x2"]
plain = model("h2_node_class", cfg)
by = param_axes(plain, gnn.logical_axes(cfg))
place = lambda t, ax: distribute_tensor(
    t.detach().clone(), mesh, R.sharding_for(mesh, t.shape, ax))
meshed = swap(model("h2_node_class", cfg), lambda n, p: place(p, by[n].axes))
g = graph("node_class")
gax = gnn.graph_logical_axes()
gm = g._replace(**{k: place(getattr(g, k), getattr(gax, k).axes)
                   for k in g._fields if k != "n_graphs"})
with implicit_replication():
    lp, _ = gnn.loss_fn(plain, g, cfg)
    lp.backward()
    lm, _ = gnn.loss_fn(meshed, gm, cfg, mesh=mesh)
    lm.backward()
res["auto"] = {"loss": err(lm, lp), "grads": leaf_errs(meshed, plain, True)}

# compressed_psum over ("pod",) of 4
pod = MESHES["pod4"]
g = {"a": torch.from_numpy(D["compress/a"][rank]),
     "b": torch.from_numpy(D["compress/b"][rank])}
r = {"a": torch.from_numpy(D["compress/ra"][rank]),
     "b": torch.from_numpy(D["compress/rb"][rank])}
mean, new_r = compress.compressed_psum(g, r, "pod", pod)
res["compress"] = {k: {"mean": mean[k].numpy().ravel().tolist(),
                       "res": new_r[k].numpy().ravel().tolist()}
                   for k in g}

# 3 compressed train steps, each rank its own graph
cfg = cfg_of(2)
net = model("h2_node_class", cfg)
hg = graphdata.random_geometric_graph(10 + rank, 16, 32, 5, 3)
g = graphdata.to_device(hg, "cpu")
loss_fn = lambda p, b: gnn.loss_fn(p, b, cfg)
step = loop.make_train_step(loss_fn, adamw.AdamWConfig(lr=LR, warmup_steps=0),
                            compress_axis="pod", mesh=pod)
state = loop.init_state(net, use_compression=True)
grads = []
for _ in range(STEPS):
    for t in net.parameters():
        t.grad = None
    loss_fn(net, g)[0].backward()
    grads.append({k: t.numpy().ravel().tolist()
                  for k, t in net.leaves(grad=True).items()})
    state, _ = step(state, g)
res["steps"] = {"grads": grads, "params": values(net, False),
                "residual": {k: t.numpy().ravel().tolist()
                             for k, t in state.ef_residual.items()}}

with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the reference's arrays, the inputs)."""
    tmp = tmp_path_factory.mktemp("gnn_sharded")
    inp, ref, out = (str(tmp / "inputs.npz"), str(tmp / "ref.npz"),
                     str(tmp / "rank"))
    _inputs(inp)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, inp, ref],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    port = str(_free_port())
    procs += [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                                str(WORLD), port, inp, out], env=env,
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
    for i, p in enumerate(procs):
        assert p.returncode == 0, (f"{'reference' if i == 0 else i - 1}: "
                                   f"{errs[i][-4000:]}")
    ranks = []
    for r in range(WORLD):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    return ranks, dict(np.load(ref)), dict(np.load(inp))


def _within(e: dict, what: str, tol: float = TOL) -> None:
    assert e["err"] <= tol * max(e["scale"], 1e-30), (what, e)


def _close(got, want, what: str, tol: float = TOL) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    _within({"err": float(np.abs(got - want).max()),
             "scale": float(np.abs(want).max())}, what, tol)


CASES = [f"h2/{t}/{m}" for t in ("node_class", "energy_force")
         for m in ("2x2", "2x2x1")]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("what", ["loss", "step_loss"])
def test_sharded_scalars_match_one_device(runs, case, what):
    for r, res in enumerate(runs[0]):
        _within(res[case][what], f"rank {r} {case} {what}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("what", ["grads", "params", "m", "v"])
def test_sharded_leaves_match_one_device(runs, case, what):
    """Every leaf's gradient, and the parameters and AdamW moments after
    one step, against ``gnn.loss_fn(mesh=None)``'s."""
    for r, res in enumerate(runs[0]):
        leaves = res[case][what]
        assert len(leaves) == 14, case
        for k, e in leaves.items():
            _within(e, f"rank {r} {case} {what} {k}")


def test_every_rank_agrees(runs):
    """The loss and the gradients are the same value on every rank."""
    ranks = runs[0]
    for case in CASES + ["h1"]:
        for res in ranks[1:]:
            assert res[case]["loss_value"] == ranks[0][case]["loss_value"]
            for k, v in res[case]["grad_values"].items():
                _close(v, ranks[0][case]["grad_values"][k], f"{case} {k}",
                       1e-6)


def test_whole_parameters_on_every_rank(runs):
    """Plain (not DTensor) parameters, each rank holding the whole model:
    each rank's gradients are the whole gradients (summed over every
    axis), energy_force on 2x2."""
    for r, res in enumerate(runs[0]):
        _within(res["whole"]["loss"], f"rank {r} whole loss")
        assert len(res["whole"]["grads"]) == 14
        for k, e in res["whole"]["grads"].items():
            _within(e, f"rank {r} whole grads {k}")


@pytest.mark.parametrize("what", ["loss", "grads"])
def test_auto_path_on_mesh_matches_one_device(runs, what):
    """``gnn.loss_fn(mesh)`` on DTensors (the edge loop on whole local
    tensors, the node update on DTensors) against ``mesh=None``."""
    for r, res in enumerate(runs[0]):
        got = res["auto"][what]
        for k, e in (got.items() if what == "grads" else [("", got)]):
            _within(e, f"rank {r} auto {what} {k}")


def test_one_head_matches_reference_sharded(runs):
    """H=1 on 2x2: the port's ``loss_fn_sharded`` against the reference's
    (where the reference agrees with its own one-device model)."""
    ranks, ref, _ = runs
    got = ranks[0]["h1"]
    _close(got["loss_value"], ref["h1/loss"], "h1 loss")
    keys = [k for k in ref if k.startswith("h1/grad/")]
    assert len(keys) == 14
    for k in keys:
        _close(got["grad_values"][k[len("h1/grad/"):]], ref[k].ravel(), k)


def _jax_one_device(inputs: dict, pname: str, H: int):
    cfg = _cfg(H)
    jcfg = jgnn.GNNConfig(**dataclasses.asdict(cfg))
    params = jax.tree.map(jnp.asarray, unflatten_tree(
        {k[len(pname) + 1:]: v for k, v in inputs.items()
         if k.startswith(pname + "/")}))
    a = {k[len("graph_node_class/"):]: v for k, v in inputs.items()
         if k.startswith("graph_node_class/")}
    g = jgnn.GraphBatch(**{k: jnp.asarray(v) for k, v in a.items()
                           if k != "n_graphs"}, n_graphs=1)
    loss, grads = jax.value_and_grad(
        lambda p: jgnn.loss_fn(p, g, jcfg)[0])(params)
    return float(loss), {k: np.asarray(v).ravel()
                         for k, v in flatten_tree(grads).items()}


def test_two_heads_match_reference_one_device(runs):
    """H=2 on 2x2: the port's sharded loss and every gradient against the
    reference's one-device ``gnn.loss_fn``."""
    ranks, _, inputs = runs
    loss, grads = _jax_one_device(inputs, "h2_node_class", 2)
    got = ranks[0]["h2/node_class/2x2"]
    _close(got["loss_value"], loss, "h2 loss")
    assert len(grads) == 14
    for k, v in grads.items():
        _close(got["grad_values"][k], v, f"h2 grad {k}")


@pytest.mark.parametrize("fault", ["fault_a", "fault_b"])
def test_reference_head_faults_kept_out(runs, fault):
    """ROADMAP.md Queue 3 item 4.  (a) H=2 on 4x1, drawn ``w_out``: the
    reference folds ``w_out`` into each edge's message before the heads'
    weights.  (b) H=2 on 2x2, ``w_out`` the identity: the reference
    gives local channel j the head j // (Cl/H).  Its sharded loss is off
    its one-device loss by more than 1e-5 of the loss; the port's sharded
    loss is within 1e-5 of the port's and of the reference's one-device
    loss."""
    ranks, ref, _ = runs
    one, sharded = float(ref[f"{fault}/one"]), float(ref[f"{fault}/sharded"])
    assert abs(sharded - one) > TOL * abs(one), (fault, sharded, one)
    got = ranks[0][fault]
    assert abs(got["loss_value"] - got["plain_loss"]) <= TOL * abs(one)
    assert abs(got["loss_value"] - one) <= TOL * abs(one)


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_psum_bit_equal_to_reference(runs, leaf):
    """Each rank's mean and new residual are the reference's under
    ``shard_map`` over ``("pod",)``, bit for bit; the mean is within one
    quantisation step of the exact mean of g (the residuals are
    small)."""
    ranks, ref, inputs = runs
    for r, res in enumerate(ranks):
        got = res["compress"][leaf]
        for k in ("mean", "res"):
            want = ref[f"compress/{k}_{leaf}"][r].ravel()
            np.testing.assert_array_equal(
                np.asarray(got[k], np.float32).view(np.int32),
                want.astype(np.float32).view(np.int32), f"rank {r} {k}")
    x = inputs[f"compress/{leaf}"] + inputs[f"compress/r{leaf}"]
    step = np.abs(x).max() / 127
    exact = x.mean(0).ravel()
    assert np.abs(np.asarray(ranks[0]["compress"][leaf]["mean"])
                  - exact).max() <= step


def _host_compressed(grads: list, res: list):
    """compressed_psum over the ranks' gradients, in numpy f32."""
    x = [g + r for g, r in zip(grads, res)]
    amax = np.float32(max(np.abs(v).max() for v in x))
    scale = np.maximum(amax / np.float32(127), np.float32(1e-12))
    q = [np.clip(np.round(v / scale), -127, 127).astype(np.int8) for v in x]
    new = [v - qq.astype(np.float32) * scale for v, qq in zip(x, q)]
    total = np.sum([qq.astype(np.int32) for qq in q], axis=0)
    return (total.astype(np.float32) * scale) / np.float32(len(x)), new


def test_compressed_train_steps_match_host(runs):
    """3 steps of ``make_train_step(compress_axis="pod")``: every rank's
    parameters alike; each rank's residual equal, bit for bit, to the
    quantisation of its gradients computed in numpy; the parameters
    within 1e-6 of scale of the reference's AdamW over those means."""
    ranks, _, inputs = runs
    params = {k[len("h2_node_class/"):]: v for k, v in inputs.items()
              if k.startswith("h2_node_class/")}
    shapes = {k: v.shape for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, unflatten_tree(params))
    opt = jadamw.init(jp)
    jcfg = jadamw.AdamWConfig(lr=LR, warmup_steps=0)
    res = [{k: np.zeros(s, np.float32) for k, s in shapes.items()}
           for _ in ranks]
    for t in range(STEPS):
        mean = {}
        for k, s in shapes.items():
            gs = [np.asarray(r["steps"]["grads"][t][k], np.float32).reshape(s)
                  for r in ranks]
            mean[k], new = _host_compressed(gs, [x[k] for x in res])
            for x, n in zip(res, new):
                x[k] = n
        jp, opt, _ = jadamw.update(
            jax.tree.map(jnp.asarray, unflatten_tree(mean)), opt, jp, jcfg)
    want = flatten_tree(jax.tree.map(np.asarray, jp))
    for r, rk in enumerate(ranks):
        for k in shapes:
            got = np.asarray(rk["steps"]["params"][k], np.float32)
            np.testing.assert_array_equal(
                got, np.asarray(ranks[0]["steps"]["params"][k], np.float32))
            _close(got, want[k].ravel(), f"rank {r} params {k}", 1e-6)
            np.testing.assert_array_equal(
                np.asarray(rk["steps"]["residual"][k], np.float32),
                res[r][k].ravel(), f"rank {r} residual {k}")
