"""The GNN family of the port against ``repro.models.gnn``, ``repro.models.sh``
and ``repro.data.graph``.

* ``sh``: the numpy parts (``real_sh_numpy``, ``fit_wigner_numpy``,
  ``j_matrices``, ``_dz_masks`` / ``_dz_consts``) bit-equal; ``dz_block``,
  ``wigner_blocks`` and both forms of ``apply_blocks`` for l_max 0..6 within
  rtol = atol = 2e-6 (f32 trigonometry and products of up to four 13 × 13
  matrices, summed in another order).
* Graph data: ``random_geometric_graph``, ``molecule_batch`` and
  ``NeighborSampler.sample`` bit-equal, pads included.
* The model, on the smoke config and on a narrow one at l_max 6, m_max 2
  (c=16, 2 layers), with the reference's weights carried by
  ``convert.gnn_params_from_numpy``: ``so2_conv``, ``mp_layer``,
  ``forward``, ``predict`` and ``loss_fn`` for both tasks, and every leaf's
  gradient (through the hand-written backward of the edge loop) against
  ``jax.grad``, within rtol 1e-4 and atol 1e-5 of the largest |value| of the
  reference's tensor (the tolerance of the reference's own chunking test:
  f32 sums in another order, the softmax's running sums among them).
* Edge cases of the edge loop (a node with no incoming edge, a chunk of
  nothing but pads, E not a multiple of ``edge_chunk``, ``edge_chunk`` >
  E), ``remat`` on and off, the reference's form of the loop
  (``edge_attention_reference``) against the autograd.Function.
* The reference's equivariance, padded-edge and chunking properties
  (``tests/test_gnn.py``) on the port, at its tolerances.
* Configs and ``GNN_SHAPES`` equal to the reference's, leaf paths and the
  init law, ``gnn_params_*`` round trip, train steps of both packages,
  GNN train states interchanged bit for bit, and each launcher resuming
  the other's GNN checkpoint.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import common as jcommon  # noqa: E402
from repro.configs import equiformer_v2 as jeq  # noqa: E402
from repro.data import graph as jgraph  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import sh as jsh  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.configs import equiformer_v2 as teq  # noqa: E402
from repro_torch.data import graph as tgraph  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from repro_torch.models import sh as tsh  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5           # ATOL as a share of the largest |value|
SH_TOL = 2e-6

NARROW = dataclasses.replace(teq.smoke_config(), name="equiformer-v2-narrow",
                             l_max=6, c=16, n_heads=4)
CONFIGS = {"smoke": teq.smoke_config(), "narrow": NARROW}


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- sh ---------------------------------------------------------------------

def test_sh_numpy_parts_bit_equal():
    gen = np.random.default_rng(0)
    pts = gen.normal(size=(40, 3))
    _bits(tsh.real_sh_numpy(6, pts), jsh.real_sh_numpy(6, pts))
    Q, _ = np.linalg.qr(gen.normal(size=(3, 3)))
    for l in range(7):
        _bits(tsh.fit_wigner_numpy(l, Q), jsh.fit_wigner_numpy(l, Q))
        for a, b in zip(tsh._dz_masks(l), jsh._dz_masks(l)):
            _bits(a, b)
        for a, b in zip(tsh._dz_consts(l), jsh._dz_consts(l)):
            _bits(a, b)
    for a, b in zip(tsh.j_matrices(6), jsh.j_matrices(6)):
        _bits(a, b)
    assert tsh.num_coef(6) == 49 and tsh.l_slice(3) == jsh.l_slice(3)


@pytest.mark.parametrize("l_max", range(7))
def test_wigner_blocks_match_reference(l_max):
    gen = np.random.default_rng(l_max)
    vec = gen.normal(size=(2, 5, 3)).astype(np.float32)
    vec[0, 0] = (0.0, 0.0, 2.0)          # on the axis: θ = 0
    vec[0, 1] = (0.0, 0.0, -1.0)         # θ = π
    gamma = gen.normal(size=(7,)).astype(np.float32)
    feats = gen.normal(size=(2, 5, (l_max + 1) ** 2, 6)).astype(np.float32)
    @jax.jit
    def reference(gamma, vec, feats):
        blocks = jsh.wigner_blocks(l_max, vec)
        return ([jsh.dz_block(l, gamma) for l in range(l_max + 1)], blocks,
                [jsh.apply_blocks(blocks, feats, t) for t in (False, True)])

    jdz, jb, japply = reference(gamma, vec, feats)
    for l in range(l_max + 1):
        _close(tsh.dz_block(l, torch.from_numpy(gamma)), jdz[l], f"dz {l}")
    tb = tsh.wigner_blocks(l_max, torch.from_numpy(vec))
    assert len(tb) == len(jb) == l_max + 1
    for l, (a, b) in enumerate(zip(tb, jb)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=SH_TOL,
                                   atol=SH_TOL, err_msg=f"D_{l}")
    for transpose, want in zip((False, True), japply):
        got = tsh.apply_blocks(tb, torch.from_numpy(feats), transpose)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=SH_TOL,
                                   atol=SH_TOL * 10)


# -- graph data ---------------------------------------------------------------

def _same_batch(t, j):
    assert type(t) is tgnn.GraphBatch and t._fields == j._fields
    for name in j._fields:
        if name == "n_graphs":
            assert t.n_graphs == j.n_graphs
        else:
            _bits(getattr(t, name), getattr(j, name), name)


@pytest.mark.parametrize("pads", [(0, 0), (48, 320)])
def test_random_geometric_graph_bit_equal(pads):
    _same_batch(tgraph.random_geometric_graph(3, 40, 300, 7, 4, *pads),
                jgraph.random_geometric_graph(3, 40, 300, 7, 4, *pads))


def test_molecule_batch_bit_equal():
    _same_batch(tgraph.molecule_batch(5, 6, 9, 20, 16),
                jgraph.molecule_batch(5, 6, 9, 20, 16))


@pytest.mark.parametrize("positions", [False, True])
def test_neighbor_sampler_bit_equal(positions):
    gen = np.random.default_rng(2)
    n, e = 120, 700
    src = gen.integers(0, n, e)
    dst = (src + gen.integers(1, n, e)) % n
    dst[:30] = 7                          # a node of high in-degree
    feats = gen.normal(size=(n, 5)).astype(np.float32)
    labels = gen.integers(0, 4, n).astype(np.int32)
    pos = gen.normal(size=(n, 3)).astype(np.float32) if positions else None
    ts = tgraph.NeighborSampler(1, n, np.stack([src, dst]), feats, labels,
                                pos)
    js = jgraph.NeighborSampler(1, n, np.stack([src, dst]), feats, labels,
                                pos)
    for seeds, pad_e in ((np.arange(8), 400), (np.array([7, 3, 99]), 40)):
        _same_batch(ts.sample(seeds, (4, 3), 128, pad_e),
                    js.sample(seeds, (4, 3), 128, pad_e))


def test_to_device_keeps_dtypes():
    g = tgraph.molecule_batch(0, 2, 5, 6, 3)
    t = tgraph.to_device(g, "cpu")
    assert t.n_graphs == 2 and isinstance(t.n_graphs, int)
    for name in g._fields[:-1]:
        assert _np(getattr(t, name)).dtype == getattr(g, name).dtype
        _bits(_np(getattr(t, name)), getattr(g, name))


# -- the model against the reference -------------------------------------------

def _jcfg(cfg):
    return jgnn.GNNConfig(**dataclasses.asdict(cfg))


def _pair(cfg, seed=1):
    """(port model, reference params) from the reference's draws."""
    params = jgnn.init_params(jax.random.PRNGKey(seed), _jcfg(cfg))
    model = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return model, params


def _graphs(cfg, task, seed=0):
    """(port batch, reference batch) of one host graph for ``task``."""
    if task == "energy_force":
        hg = tgraph.molecule_batch(seed, 4, 10, 24, cfg.f_in)
    else:
        hg = tgraph.random_geometric_graph(seed, 40, 200, cfg.f_in,
                                           cfg.n_out, 48, 224)
    return _both(hg)


def _both(hg):
    jb = jgnn.GraphBatch(*[jnp.asarray(x) for x in hg[:-1]], hg.n_graphs)
    return tgraph.to_device(hg, "cpu"), jb


def _task(cfg, task):
    return dataclasses.replace(cfg, task=task,
                               n_out=1 if task == "energy_force" else cfg.n_out)


def _grads_close(model, jgrads):
    want = convert.flatten_tree(jax.tree.map(np.asarray, jgrads))
    got = model.leaves(grad=True)
    assert list(got) == list(want)
    nonzero = 0
    for k, g in got.items():
        _close(_np(g), want[k], k)
        nonzero += bool(np.abs(want[k]).max() > 0)
    return nonzero


def _reference(params, jb, jcfg):
    """The reference's forward, predict, (loss, metrics) and loss gradient,
    in one compiled call (the batch closed over: ``n_graphs`` is static)."""
    def run(p):
        return (jgnn.forward(p, jb, jcfg), jgnn.predict(p, jb, jcfg),
                jax.value_and_grad(lambda q: jgnn.loss_fn(q, jb, jcfg),
                                   has_aux=True)(p))
    return jax.jit(run)(params)


@pytest.mark.parametrize("task", ["node_class", "energy_force"])
@pytest.mark.parametrize("size", list(CONFIGS))
def test_model_matches_reference(size, task):
    """forward, predict, loss_fn and every leaf's gradient."""
    cfg = _task(CONFIGS[size], task)
    model, params = _pair(cfg)
    g, jb = _graphs(cfg, task)
    jf, want, ((jl, jm), jg) = _reference(params, jb, _jcfg(cfg))
    _close(_np(tgnn.forward(model, g, cfg)), jf, "forward")
    with torch.no_grad():
        got = tgnn.predict(model, g, cfg)
    for a, b in zip(got if task == "energy_force" else [got],
                    want if task == "energy_force" else [want]):
        _close(_np(a), b, "predict")
    loss, metrics = tgnn.loss_fn(model, g, cfg)
    loss.backward()
    _close(_np(loss), jl, "loss")
    assert metrics.keys() == jm.keys()
    for k in jm:
        _close(_np(metrics[k]), jm[k], k)
    nonzero = _grads_close(model, jg)
    # At 2 layers both packages leave the m = 2 weights without gradient
    # (layer 0's input is l = 0 only; the last layer's m = 2 rows reach no
    # readout), and node_class also force_w and the m = 1 weights (its
    # readout reads l = 0 alone).
    assert nonzero == (14 if task == "energy_force" else 11)


@pytest.mark.parametrize("size", list(CONFIGS))
def test_blocks_match_reference(size):
    """so2_conv and mp_layer on layer 1 of the model, from an input with
    every degree filled."""
    cfg = CONFIGS[size]
    jcfg = _jcfg(cfg)
    model, params = _pair(cfg)
    g, jb = _graphs(cfg, "node_class")
    gen = np.random.default_rng(4)
    f = gen.normal(size=(48, cfg.k, cfg.c)).astype(np.float32)
    names, per_layer = model.layer_weights()
    lp = tgnn._nest(names, per_layer[1])
    jlp = jax.tree.map(lambda x: x[1], params["layers"])
    fr = gen.normal(size=(30, cfg.k, cfg.c)).astype(np.float32)
    jconv, jlayer = jax.jit(lambda: (
        jgnn.so2_conv(jnp.asarray(fr), jlp["so2"], jcfg),
        jgnn.mp_layer(jlp, jnp.asarray(f), jb, jcfg)))()
    _close(_np(tgnn.so2_conv(torch.from_numpy(fr), lp["so2"], cfg)), jconv,
           "so2_conv")
    _close(_np(tgnn.mp_layer(lp, torch.from_numpy(f), g, cfg)), jlayer,
           "mp_layer")


def _edge_case(case):
    """A node-class graph (N=12) and its config for one edge case."""
    gen = np.random.default_rng(7)
    cfg = dataclasses.replace(teq.smoke_config(), edge_chunk=16)
    N, E = 12, 48
    src = gen.integers(0, 8, E).astype(np.int32)
    dst = ((src + gen.integers(1, 8, E)) % 8).astype(np.int32)
    if case == "no_incoming_edge":       # nodes 8..11 receive nothing
        src[:5] = 9
    elif case == "chunk_of_pads":        # the middle chunk is all pads
        src[16:32] = -1
        dst[16:32] = -1
    elif case == "ragged_chunks":        # E = 45: chunks of 15
        src, dst = src[:45], dst[:45]
        src[-2:] = -1
    else:                                # edge_chunk > E
        cfg = dataclasses.replace(cfg, edge_chunk=64)
    pos = gen.normal(size=(N, 3)).astype(np.float32)
    vec = (pos[np.maximum(src, 0)] - pos[np.maximum(dst, 0)])
    vec[src < 0] = 1.0
    hg = tgnn.GraphBatch(gen.normal(size=(N, cfg.f_in)).astype(np.float32),
                         src, dst, vec.astype(np.float32),
                         gen.integers(-1, cfg.n_out, N).astype(np.int32),
                         np.zeros((N, 3), np.float32),
                         np.zeros(N, np.int32), 1)
    return cfg, hg


@pytest.mark.parametrize("case", ["no_incoming_edge", "chunk_of_pads",
                                  "ragged_chunks", "chunk_beyond_e"])
def test_edge_cases_match_reference(case):
    cfg, hg = _edge_case(case)
    cfg = dataclasses.replace(cfg, n_layers=3)     # m >= 1 weights get grads
    model, params = _pair(cfg, seed=2)
    g, jb = _both(hg)
    jf, _, (_, jg) = _reference(params, jb, _jcfg(cfg))
    _close(_np(tgnn.forward(model, g, cfg)), jf, "forward")
    if case == "no_incoming_edge":
        assert not np.isin(np.arange(8, 12), hg.edge_dst[hg.edge_src >= 0]).any()
    loss, _ = tgnn.loss_fn(model, g, cfg)
    loss.backward()
    assert _grads_close(model, jg) == 15       # all but force_w


def test_edge_loop_backward_equals_reference_form():
    """The autograd.Function's gradients (input and every edge weight)
    against autograd through the reference's form of the loop, for a
    random upstream gradient, with a chunk of pads and a node without
    edges."""
    cfg, hg = _edge_case("chunk_of_pads")
    cfg = dataclasses.replace(cfg, l_max=6, m_max=2)
    model, _ = _pair(cfg)
    g = tgraph.to_device(hg, "cpu")
    gen = np.random.default_rng(5)
    f = torch.from_numpy(gen.normal(size=(12, cfg.k, cfg.c)).astype(
        np.float32)).requires_grad_()
    up = torch.from_numpy(gen.normal(size=(12, cfg.k, cfg.c)).astype(
        np.float32))
    names, per_layer = model.layer_weights()
    lp = tgnn._nest(names, [w.detach().requires_grad_()
                            for w in per_layer[0]])
    ws = [*lp["so2"].values(), lp["rad1"], lp["rad2"], lp["wa1"], lp["wa2"]]
    out = tgnn.edge_attention(f, lp, g, cfg)
    ref = tgnn.edge_attention_reference(f, lp, g, cfg)
    _close(_np(out), _np(ref), "output")
    got = torch.autograd.grad(out, (f, *ws), up)
    want = torch.autograd.grad(ref, (f, *ws), up)
    for a, b in zip(got, want):
        _close(_np(a), _np(b), "gradient")
    assert float(got[0].abs().max()) > 0


def test_remat_on_and_off_equal():
    cfg = _task(NARROW, "energy_force")
    g, _ = _graphs(cfg, "energy_force")
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model, _ = _pair(c)
        loss, _ = tgnn.loss_fn(model, g, c)
        loss.backward()
        grads.append({k: _np(t).copy()
                      for k, t in model.leaves(grad=True).items()})
    for k in grads[0]:
        _bits(grads[0][k], grads[1][k], k)


# -- the reference's properties, on the port ------------------------------------

def _rand_rot(gen):
    Q, _ = np.linalg.qr(gen.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32)


def test_equivariance_padding_and_chunking():
    """tests/test_gnn.py's three properties at its tolerances: l=0 outputs
    invariant and l=1 rows rotating with D₁(R) under a rotation of
    edge_vec; padded edges' payloads inert; the output independent of the
    chunk size; also the energy invariant and the forces rotating with R
    (energy_force)."""
    gen = np.random.default_rng(11)
    cfg = dataclasses.replace(teq.smoke_config(), f_in=5, n_out=3,
                              edge_chunk=16)
    model, _ = _pair(cfg, seed=0)
    _, hg = _edge_case("ragged_chunks")
    hg = hg._replace(node_feat=hg.node_feat[:, :5])
    g = tgraph.to_device(hg, "cpu")
    R = _rand_rot(gen)
    g_rot = g._replace(edge_vec=g.edge_vec @ torch.from_numpy(R).T)
    with torch.no_grad():
        f1 = tgnn.forward(model, g, cfg)
        f2 = tgnn.forward(model, g_rot, cfg)
        scale = max(float(f1.abs().max()), 1.0)
        assert float((f1[:, 0] - f2[:, 0]).abs().max()) < 1e-3 * scale
        D1 = torch.from_numpy(tsh.fit_wigner_numpy(1, R).astype(np.float32))
        pred = torch.einsum("ij,njc->nic", D1, f1[:, 1:4])
        assert float((pred - f2[:, 1:4]).abs().max()) < 2e-3 * scale

        vec2 = g.edge_vec.clone()
        vec2[g.edge_src < 0] = 123.0
        f3 = tgnn.forward(model, g._replace(edge_vec=vec2), cfg)
        np.testing.assert_allclose(_np(f3), _np(f1), atol=1e-6)

        f4 = tgnn.forward(model, g, dataclasses.replace(cfg, edge_chunk=8))
        np.testing.assert_allclose(_np(f4), _np(f1), rtol=1e-4, atol=1e-5)

        ef = _task(cfg, "energy_force")
        mol = tgraph.to_device(tgraph.molecule_batch(1, 3, 8, 20, 5), "cpu")
        mol_rot = mol._replace(edge_vec=mol.edge_vec @ torch.from_numpy(R).T)
        model_ef, _ = _pair(ef, seed=0)
        e1, F1 = tgnn.predict(model_ef, mol, ef)
        e2, F2 = tgnn.predict(model_ef, mol_rot, ef)
        assert float((e1 - e2).abs().max()) < 1e-3 * max(
            float(e1.abs().max()), 1.0)
        assert float((F1 @ D1.T - F2).abs().max()) < 2e-3 * max(
            float(F1.abs().max()), 1.0)


# -- configs, leaves, params ----------------------------------------------------

def test_configs_and_shapes_equal_reference():
    assert tcommon.GNN_SHAPES == jcommon.GNN_SHAPES
    assert teq.SHAPES == jeq.SHAPES and (teq.ARCH, teq.FAMILY) == (
        jeq.ARCH, jeq.FAMILY)
    for shape in [None, *jcommon.GNN_SHAPES.values()]:
        t, j = teq.full_config(shape), jeq.full_config(shape)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.k == j.k
    assert dataclasses.asdict(teq.smoke_config()) == dataclasses.asdict(
        jeq.smoke_config())
    assert dataclasses.asdict(tgnn.GNNConfig()) == dataclasses.asdict(
        jgnn.GNNConfig())
    assert tgnn.NEG == jgnn.NEG
    for m in range(-2, 3):
        _bits(tgnn._m_indices(6, m), jgnn._m_indices(6, m))


@pytest.mark.parametrize("size", list(CONFIGS))
def test_leaves_shapes_and_init_law(size):
    cfg = CONFIGS[size]
    model = tgnn.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    want = convert.flatten_tree(jax.eval_shape(
        lambda: jgnn.init_params(jax.random.PRNGKey(0), _jcfg(cfg))))
    got = model.leaves()
    assert list(got) == list(want)        # the reference's tree order
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape and t.dtype == torch.float32
    ln = got["layers/ln"]
    assert torch.equal(ln, torch.ones_like(ln))
    n0 = cfg.l_max + 1
    fans = {"embed_in": cfg.f_in, "layers/so2/w0": n0 * cfg.c,
            "layers/so2/w2r": (n0 - 2) * cfg.c, "layers/rad1": cfg.n_rbf,
            "layers/gate": cfg.c, "layers/w_out": cfg.c, "ro1": cfg.c}
    for k, fan in fans.items():
        std = float(got[k].detach().std())
        assert abs(std * np.sqrt(fan) - 1) < 0.15, (k, std, fan)
    again = tgnn.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    for k, t in again.leaves().items():
        assert torch.equal(t, got[k]), k


def test_params_round_trip():
    model, params = _pair(NARROW)
    back = convert.flatten_tree(convert.gnn_params_to_numpy(model))
    want = convert.flatten_tree(jax.tree.map(np.asarray, params))
    assert back.keys() == want.keys()
    for k, a in want.items():
        _bits(back[k], a, k)
    with pytest.raises(ValueError):
        convert.gnn_params_from_numpy({"embed_in": want["embed_in"]}, NARROW,
                                      device="cpu")


def test_entry_points_need_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgnn.init_params(None, teq.smoke_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgraph.to_device(tgraph.molecule_batch(0, 2, 5, 6, 3))
    with pytest.raises(ValueError, match="float32"):
        cfg = dataclasses.replace(teq.smoke_config(), dtype="bfloat16")
        g, _ = _graphs(cfg, "node_class")
        tgnn.forward(_pair(teq.smoke_config())[0], g, cfg)


# -- train steps, train states and the launchers ------------------------------

OPT = dict(lr=1e-3, warmup_steps=10, decay_steps=12)


@pytest.mark.parametrize("task", ["node_class", "energy_force"])
def test_train_step_matches_reference(task):
    """The launcher's AdamW through both packages' train steps for 3 steps:
    the loss of every step within rtol 1e-5, the grad norm within 1e-4,
    the lr within 1e-6."""
    cfg = _task(teq.smoke_config(), task)
    jcfg = _jcfg(cfg)
    model, params = _pair(cfg)
    g, jb = _graphs(cfg, task)
    step = jloop.make_train_step(lambda p, b: jgnn.loss_fn(p, b, jcfg),
                                 jadamw.AdamWConfig(**OPT))
    jstep = jax.jit(lambda state: step(state, jb))   # n_graphs static
    tstep = tloop.make_train_step(lambda p, b: tgnn.loss_fn(p, b, cfg),
                                  tadamw.AdamWConfig(**OPT))
    js = jloop.init_state(params)
    ts = tloop.init_state(model)
    for s in range(3):
        js, jm = jstep(js)
        ts, tm = tstep(ts, g)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {s}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


def _key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def test_train_state_checkpoints_interchange(tmp_path):
    """A port GNN train state (two launcher steps) restores in JAX bit for
    bit, and a JAX one in the port."""
    params, loss_fn, batch_at, _ = tlaunch.build("equiformer-v2", 1, "cpu")
    state = tloop.init_state(params)
    step = tloop.make_train_step(loss_fn, tadamw.AdamWConfig(**OPT))
    for s in range(2):
        state, metrics = step(state, batch_at(s))
        assert np.isfinite(float(metrics["loss"]))
        assert {"xent", "grad_norm", "lr"} <= set(metrics)
    tlaunch.save(str(tmp_path / "t"), 2, state)
    cfg = teq.smoke_config()
    template = jloop.init_state(jgnn.init_params(jax.random.PRNGKey(3),
                                                 _jcfg(cfg)))
    jstate, at, _ = jckpt.restore(str(tmp_path / "t"), template)
    arrays, _ = convert.train_state_to_numpy(state)
    assert at == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        _bits(np.asarray(leaf), arrays[_key(path)])

    jckpt.save(str(tmp_path / "j"), 4, template)
    back = tloop.init_state(tgnn.init_params(None, cfg, device="cpu"))
    back, at = tlaunch.restore(str(tmp_path / "j"), back)
    mine, _ = convert.train_state_to_numpy(back)
    flat = jax.tree_util.tree_flatten_with_path(template)[0]
    assert at == 4 and len(flat) == len(mine)
    for path, leaf in flat:
        _bits(mine[_key(path)], np.asarray(leaf))


def test_launchers_resume_each_others_gnn_checkpoints(tmp_path, capsys,
                                                      monkeypatch):
    arch = "equiformer-v2"
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")

    def jax_launcher(*argv):
        monkeypatch.setattr(sys, "argv", ["train", *argv])
        jlaunch.main()

    tlaunch.main(["--arch", arch, "--steps", "10", "--device", "cpu",
                  "--ckpt-dir", port_dir, "--ckpt-every", "5"])
    port_lines = capsys.readouterr().out.splitlines()
    assert port_lines[0].startswith(f"[{arch}] step    1 loss=")
    assert port_lines[1].startswith(f"[{arch}] step   10 loss=")
    assert tckpt.latest_step(port_dir) == 10
    jax_launcher("--arch", arch, "--steps", "12", "--ckpt-dir", port_dir,
                 "--resume")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 10"
    assert out[1].startswith(f"[{arch}] step   11 loss=")

    jax_launcher("--arch", arch, "--steps", "10", "--ckpt-dir", jax_dir,
                 "--ckpt-every", "10")
    jax_lines = capsys.readouterr().out.splitlines()
    # the same graph, but each package's own seed-0 weights
    assert jax_lines[0].startswith(f"[{arch}] step    1 loss=")
    tlaunch.main(["--arch", arch, "--steps", "12", "--device", "cpu",
                  "--ckpt-dir", jax_dir, "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 10"
    assert out[1].startswith(f"[{arch}] step   11 loss=")
