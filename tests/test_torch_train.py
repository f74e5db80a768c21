"""Recsys training in the port against the JAX package: kernel D's
backward, AdamW, compression, the train step, train-state checkpoints and
the launcher.

* ``embed_bag_backward_plain`` (the backward kernel's twin) against
  ``jax.grad`` of the reference's vmapped ``embedding_bag`` with respect
  to the tables: bit-equal where every row is named at most once, within
  atol = 1e-6 otherwise (XLA's scatter-add may add a row's terms in
  another order).  ``ops.embed_bag`` and DLRM's ``InteractionInput`` give
  their tables the twin's gradient bit for bit on the CPU.
* ``adamw.update`` / ``schedule`` / ``clip_by_global_norm`` against the
  reference over 3 steps: rtol = 1e-6, atol = 1e-7 (f32 reductions,
  ``pow`` and ``cos`` of another library); the chunked update bit-equal
  to the unchunked one.  ``quantize_int8`` / ``ef_compress_tree``: q
  bit-equal, scales and residuals within rtol = 1e-6.
* ``make_train_step`` over 5 steps on each recsys smoke config, with 1 and
  2 microbatches: the loss of every step within rtol = 1e-5, the final
  parameters within rtol = 1e-4, atol = 2·(the steps' summed lr), the most
  Adam's normalised steps can drift a parameter whose gradient is at
  rounding level.
* Train-state checkpoints: each package restores the other's bit for bit;
  the port's 3 steps + save + restore + 3 steps equal 6 straight steps
  bitwise; the launcher resumes from its last checkpoint.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data import loaders as jloaders  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import loaders as tloaders  # noqa: E402
from repro_torch.kernels import embed_bag as tbag  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

ARCHS = ("din", "sasrec", "mind", "dlrm-rm2")


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


# -- 1. kernel D's backward ---------------------------------------------------

def _jax_table_grad(tables, idx, upstream):
    """d(sum(bags * upstream)) / d(tables) of the reference's vmapped
    ``embedding_bag`` (flat: one table)."""
    if tables.ndim == 2:
        f = lambda t: jnp.sum(jrs.embedding_bag(t, idx) * upstream)  # noqa
    else:
        lookup = jax.vmap(jrs.embedding_bag, in_axes=(0, 1), out_axes=1)
        f = lambda t: jnp.sum(lookup(t, idx) * upstream)  # noqa: E731
    return np.asarray(jax.grad(f)(jnp.asarray(tables)))


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("unique", [True, False])
def test_backward_twin_matches_jax_grad(stacked, unique):
    rng = np.random.default_rng(3 + stacked + 2 * unique)
    F, V, D, B, hot = (4, 300, 16, 40, 3) if stacked else (1, 300, 16, 60, 4)
    shape = (B, F, hot) if stacked else (B, hot)
    if unique:          # every row named at most once in each field
        idx = np.stack([rng.permutation(V)[:B * hot].reshape(B, hot)
                        for _ in range(F)], axis=1).astype(np.int32)
        idx = idx.reshape(shape)
    else:
        idx = rng.integers(0, 20, shape).astype(np.int32)
    idx[rng.random(shape) < 0.2] = -1
    tables = rng.normal(0, 1, (F, V, D) if stacked else (V, D)).astype(
        np.float32)
    upstream = rng.normal(0, 1, shape[:-1] + (D,)).astype(np.float32)
    want = _jax_table_grad(tables, jnp.asarray(idx), jnp.asarray(upstream))
    got = tbag.embed_bag_backward_plain(torch.from_numpy(upstream),
                                        torch.from_numpy(idx), V).numpy()
    if unique:
        _bits(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_backward_wrapper_on_cpu_is_the_twin_and_counts_nothing():
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(-1, 50, (30, 3, 2)).astype(np.int32))
    buf = torch.from_numpy(rng.normal(0, 1, (30, 4, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (30, 3, 2)).astype(np.float32))
    tkernels.reset_launch_counts()
    got = tops.embed_bag_backward(buf[:, 1:], idx, 50, w)
    _bits(got.numpy(), tbag.embed_bag_backward_plain(
        buf[:, 1:].contiguous(), idx, 50, w).numpy())
    assert got.shape == (3, 50, 8)
    assert tkernels.launch_counts()["embed_bag_backward"] == 0
    with pytest.raises(ValueError):
        tbag.embed_bag_backward(buf[:, 1:], idx, 50, use_kernel=True)
    keys, slots = tbag.backward_operands(idx, 50)
    assert keys.dtype == torch.int32 and slots.dtype == torch.int64
    flat = torch.where(idx >= 0, idx + torch.arange(3)[None, :, None] * 50,
                       150).reshape(-1)
    assert torch.equal(keys, torch.sort(flat, stable=True).values)
    assert torch.equal(flat[slots], keys)


@pytest.mark.parametrize("F,V,D", [(26, 1_000_000, 64), (1, 7, 64),
                                   (3, 300, 18), (4, 900, 100),
                                   (2, 500, 260), (1, 129, 8),
                                   (1, 3, 20_000)])
def test_backward_plan_spans_cover_rows_and_fit_shared_memory(F, V, D):
    """The plan's spans, dealt over a persistent grid as the kernel deals
    them (block k takes spans k, k + g, k + 2g, ...), cover [0, F·V)
    exactly once; a span is 16 KB of output or one row; its R run heads
    fit a block's static shared memory; a group's lanes cover a row in
    whole passes."""
    p = tbag.backward_plan(65_536, F, 1, V, D)
    for grid in (1, 7, 132 * 8):
        g = min(grid, p.n_spans)
        rows = np.zeros(F * V + 1, dtype=np.int64)
        for k in range(g):
            for s in range(k, p.n_spans, g):
                rows[s * p.span_rows] += 1
                rows[min((s + 1) * p.span_rows, F * V)] -= 1
        assert (np.cumsum(rows)[:-1] == 1).all()
    assert (p.n_spans - 1) * p.span_rows < F * V <= p.n_spans * p.span_rows
    assert p.span_rows == max(1, tbag.SPAN_FLOATS // D)
    assert p.smem_bytes == 8 * p.span_rows <= 48 * 1024
    assert p.group in (1, 2, 4, 8, 16, 32)
    lanes = D // 4 if p.vec4 else D
    assert p.group >= min(lanes, 32) and (p.group == 32 or
                                          p.group // 2 < lanes)
    assert p.vec4 == p.wide == (D % 4 == 0)
    if (F, V, D) == (26, 1_000_000, 64):
        assert (p.span_rows, p.n_spans, p.group) == (64, 406_250, 16)


@pytest.mark.parametrize("hot", [1, 3])
def test_backward_span_walk_visits_every_run_once(hot):
    """The kernel's walk in plain Python over sorted keys from
    ``backward_operands``: span s's positions run from the first key >=
    s·R to the first key >= (s+1)·R (the pre-pass's binary searches), so
    the spans' positions partition the valid sorted positions and every
    run (a head where the key changes) lies inside its span."""
    rng = np.random.default_rng(40 + hot)
    F, V, B = 3, 700, 500
    idx = rng.integers(0, V, (B, F, hot)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1
    idx[:, 1, 0] = 323                 # row 1,023: a run of B slots on the
                                       # last row of span 7
    keys, _ = tbag.backward_operands(torch.from_numpy(idx), V)
    keys = keys.numpy()
    p = tbag.backward_plan(B, F, hot, V, 64)
    starts = [int(np.searchsorted(keys, min(s * p.span_rows, F * V)))
              for s in range(p.n_spans + 1)]
    seen, runs = [], 0
    for s in range(p.n_spans):
        span = range(starts[s], starts[s + 1])
        seen.extend(span)
        for q in span:
            assert s * p.span_rows <= keys[q] < (s + 1) * p.span_rows
            runs += q == starts[s] or keys[q - 1] != keys[q]
    n_valid = int((idx >= 0).sum())
    assert seen == list(range(n_valid))
    assert runs == len(np.unique(keys[:n_valid]))
    assert (keys[n_valid:] == F * V).all() and starts[-1] == n_valid


def test_backward_plan_raises_past_int32_positions():
    """B·F·hot >= 2**31 slots (the kernel's positions and slot arithmetic
    are 32-bit) and F·V >= 2**31 rows: each a ValueError from shapes
    alone; alignment picks 4-byte loads and stores."""
    tbag.backward_plan(2**31 // 26, 26, 1, 1_000_000, 64)
    for args in ((2**31 // 26 + 1, 26, 1, 1_000_000, 64),
                 (2**30, 1, 2, 10, 8),
                 (4, 26, 1, 2**31 // 26 + 1, 64),
                 (4, 1, 1, 10, 0)):
        with pytest.raises(ValueError):
            tbag.backward_plan(*args)
    assert tbag.backward_plan(4, 1, 1, 10, 64, out_aligned=False).wide == 0
    assert tbag.backward_plan(4, 1, 1, 10, 64, grad_aligned=False).vec4 == 0
    wide_rows = tbag.backward_plan(4, 1, 1, 10, 100_000)
    assert (wide_rows.span_rows, wide_rows.group) == (1, 32)


def test_backward_launch_struct_matches_cuda_source():
    """``_BackwardLaunch._fields_`` against ``struct BackwardLaunch`` of
    ``csrc/embed_bag_backward.cu``: the same names and C types, in order."""
    import re
    src = (tkernels._build.CSRC / "embed_bag_backward.cu").read_text()
    body = re.search(r"struct BackwardLaunch \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = re.match(r"\s*(long long|int)\s+([\w,\s]+);", line)
        if m:
            fields += [(n.strip(), m.group(1)) for n in m.group(2).split(",")]
    ctype = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    assert fields == [(n, ctype[t]) for n, t in tbag._BackwardLaunch._fields_]
    assert ctypes.sizeof(tbag._BackwardLaunch) == 8 * 2 + 4 * 10


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ops_embed_bag_gradient_is_the_backward_twin(weighted, mode):
    rng = np.random.default_rng(5 + weighted)
    table = torch.from_numpy(rng.normal(0, 1, (40, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 40, (25, 5)).astype(np.int32))
    w = torch.from_numpy(rng.normal(0, 1, (25, 5)).astype(np.float32)) \
        if weighted else None
    up = torch.from_numpy(rng.normal(0, 1, (25, 8)).astype(np.float32))
    t = table.clone().requires_grad_(True)
    (tops.embed_bag(t, idx, w, mode=mode) * up).sum().backward()
    ww = w if mode == "sum" else (
        (torch.ones((25, 5)) if w is None else w)
        / (idx >= 0).sum(-1, keepdim=True).clamp_min(1))
    _bits(t.grad.numpy(), tbag.embed_bag_backward_plain(up, idx, 40,
                                                        ww).numpy())
    with pytest.raises(ValueError):
        tops.embed_bag(t, idx, out=torch.empty((25, 8)))
    with pytest.raises(ValueError):
        tops.embed_bag(t, idx, torch.ones((25, 5), requires_grad=True))
    with torch.no_grad():
        out = torch.empty((25, 8))
        assert tops.embed_bag(t, idx, w, mode=mode, out=out) is out


@pytest.mark.parametrize("hot", [1, 4])
def test_dlrm_training_buffer_gradients_equal_twin_program(hot):
    """DLRM's training buffer (``InteractionInput``: x0 copied into row 0,
    the stacked form into rows 1.., the stacked backward) gives every
    parameter the twin program's gradient (``torch.cat`` of x0 and the
    flat twin's bags, the flat backward) bit for bit, and the same loss."""
    cfg = dataclasses.replace(treg.get("dlrm-rm2").smoke_config(),
                              multi_hot=hot)
    batch = tloaders.recsys_batch(0, 7, 64, cfg, device="cpu")
    out = {}
    for use_kernel in (None, False):
        model = trs.init_params(torch.Generator().manual_seed(8), cfg,
                                device="cpu")
        loss = trs.loss(model, batch, cfg, use_kernel=use_kernel)
        loss.backward()
        out[use_kernel] = (loss.detach(), model.leaves(grad=True))
    _bits(out[None][0].numpy(), out[False][0].numpy())
    for k, g in out[None][1].items():
        _bits(g.contiguous().numpy(), out[False][1][k].contiguous().numpy())


# -- 2. AdamW and compression -------------------------------------------------

def _tree(rng, shapes):
    return {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a/w0": (7, 5), "a/b0": (5,), "t": (30, 4)}


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference_over_three_steps(clip):
    rng = np.random.default_rng(9)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, decay_steps=5, clip_norm=clip,
                  weight_decay=0.1)
    p0 = _tree(rng, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo, to = jadamw.init(jp), tadamw.init(tp)
    for _ in range(3):
        g = _tree(rng, SHAPES)
        g = {k: v * 3 for k, v in g.items()}
        jp, jo, jm = jadamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                   jo, jp, jadamw.AdamWConfig(**cfg_kw))
        tp, to, tm = tadamw.update({k: torch.from_numpy(v)
                                    for k, v in g.items()},
                                   to, tp, tadamw.AdamWConfig(**cfg_kw))
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        for k in SHAPES:
            for a, b in ((tp[k], jp[k]), (to.m[k], jo.m[k]),
                         (to.v[k], jo.v[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7, err_msg=k)
    assert int(to.step) == int(jo.step) == 3 and to.step.dtype == torch.int32


def test_schedule_and_clip_match_reference():
    cfg = dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 200):
        np.testing.assert_allclose(
            float(tadamw.schedule(tadamw.AdamWConfig(**cfg),
                                  torch.tensor(s, dtype=torch.int32))),
            float(jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.int32(s))),
            rtol=1e-6)
    rng = np.random.default_rng(10)
    for scale in (0.01, 10.0):
        g = {k: v * scale for k, v in _tree(rng, SHAPES).items()}
        tg, tn = tadamw.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
        jg, jn = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=1e-6, atol=1e-7)


def test_chunked_update_bit_equal_to_whole(monkeypatch):
    """Leaves updated in chunks (contiguous runs, or rows of a transposed
    view) get the bits of the whole-leaf update (clip off, so no sum of
    squares changes order)."""
    rng = np.random.default_rng(11)
    shapes = {"t": (50, 6), "w": (9, 13)}
    p0, g = _tree(rng, shapes), _tree(rng, shapes)
    cfg = tadamw.AdamWConfig(clip_norm=0.0, lr=1e-2, warmup_steps=0)
    out = []
    for chunk in (1 << 24, 7):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        p = {"t": torch.from_numpy(p0["t"].copy()),
             "w": torch.from_numpy(p0["w"].T.copy()).t()}   # a [9, 13] view
        o = tadamw.init(p)
        for _ in range(2):
            tadamw.update({k: torch.from_numpy(v) for k, v in g.items()},
                          o, p, cfg)
        out.append({k: v.contiguous().numpy() for k, v in p.items()})
    for k in shapes:
        _bits(out[0][k], out[1][k])


def test_compression_matches_reference():
    rng = np.random.default_rng(12)
    x = rng.normal(0, 3, (257,)).astype(np.float32)
    x[:4] = [0.0, 127.5, -127.5, 1e-3]
    tq, ts = tcompress.quantize_int8(torch.from_numpy(x))
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    _bits(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    np.testing.assert_allclose(tcompress.dequantize(tq, ts).numpy(),
                               np.asarray(jcompress.dequantize(jq, js)),
                               rtol=1e-6)
    g, r = _tree(rng, SHAPES), _tree(rng, SHAPES)
    r = {k: v * 0.01 for k, v in r.items()}
    tq, ts, tr = tcompress.ef_compress_tree(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()})
    jq, js, jr = jcompress.ef_compress_tree(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    for k in g:
        _bits(tq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6)
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   rtol=1e-6, atol=1e-7)
    # compressed_psum over an axis of one worker: quantise -> dequantise
    # (the max-reduce and the int32 sum are identities there), bit for bit
    mean, res = tcompress.compressed_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()}, "pod",
        _OneWorker())
    for k in g:
        _bits(mean[k].numpy(),
              tcompress.dequantize(tq[k], ts[k]).numpy())
        _bits(res[k].numpy(), tr[k].numpy())
    with pytest.raises(ValueError, match="mesh"):
        tloop.make_train_step(lambda p, b: (None, {}),
                              tadamw.AdamWConfig(), compress_axis="pod")


class _OneWorker:
    """A mesh of one ``pod`` (an axis of one device issues no
    collective)."""
    axis_names = ("pod",)
    shape = {"pod": 1}


# -- 3. the train step --------------------------------------------------------

def _jax_and_port(arch, seed=0):
    cfg_t = treg.get(arch).smoke_config()
    cfg_j = jrs.RecsysConfig(**dataclasses.asdict(cfg_t))
    params = jrs.init_params(jax.random.PRNGKey(seed), cfg_j)
    model = convert.recsys_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    return cfg_t, cfg_j, params, model


OPT = dict(lr=1e-3, warmup_steps=10, decay_steps=5)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    cfg_t, cfg_j, params, model = _jax_and_port(arch)
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: (jrs.loss(p, b, cfg_j), {}),
        jadamw.AdamWConfig(**OPT), microbatches=microbatches))
    tstep = tloop.make_train_step(
        lambda p, b: (trs.loss(p, b, cfg_t), {}),
        tadamw.AdamWConfig(**OPT), microbatches=microbatches)
    js, ts = jloop.init_state(params), tloop.init_state(model)
    B, lr_sum = 8 * microbatches, 0.0
    for step in range(5):
        js, jm = jstep(js, jax.tree.map(jnp.asarray, jloaders.recsys_batch(
            0, step, B, cfg_j)))
        ts, tm = tstep(ts, tloaders.recsys_batch(0, step, B, cfg_t,
                                                 device="cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        lr_sum += float(tm["lr"])
    # Adam moves a parameter by about lr a step whatever its gradient's
    # size, so one whose gradient is at rounding level may move either way
    # in either package: 2·sum(lr) bounds that drift
    want = convert.flatten_tree(jax.tree.map(np.asarray, js.params))
    for k, t in ts.params.leaves().items():
        np.testing.assert_allclose(t.detach().numpy(), want[k], rtol=1e-4,
                                   atol=2 * lr_sum, err_msg=k)
    assert all(p.grad is None for p in model.parameters())


# -- 4. train-state checkpoints and the launcher ------------------------------

def _port_state(arch, steps, seed=0):
    cfg, _, _, model = _jax_and_port(arch, seed)
    state = tloop.init_state(model)
    step = tloop.make_train_step(lambda p, b: (trs.loss(p, b, cfg), {}),
                                 tadamw.AdamWConfig(**OPT))
    for s in range(steps):
        state, _ = step(state, tloaders.recsys_batch(0, s, 8, cfg,
                                                     device="cpu"))
    return cfg, state, step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_checkpoints_interchange(arch, tmp_path):
    """A port train state saved by ``ckpt.save`` restores in JAX (its
    ``ckpt.restore`` with a ``TrainState`` template) bit for bit, and a
    JAX one in the port."""
    cfg, state, _ = _port_state(arch, 2)
    arrays, dtypes = convert.train_state_to_numpy(state)
    assert ".opt/.step" in arrays and not any(
        k.startswith(".ef_residual") for k in arrays)
    tckpt.save(str(tmp_path / "t"), 2, arrays, dtypes=dtypes)
    _, cfg_j, params, _ = _jax_and_port(arch, seed=3)
    template = jloop.init_state(params)
    jstate, step, _ = jckpt.restore(str(tmp_path / "t"), template)
    assert step == 2
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        _bits(np.asarray(leaf), arrays[key])

    jckpt.save(str(tmp_path / "j"), 4, template)
    back = tloop.init_state(trs.init_params(None, cfg, device="cpu"))
    got, step, _ = tckpt.restore(str(tmp_path / "j"),
                                 convert.train_state_expect(back))
    convert.train_state_from_numpy(got, back)
    mine, _ = convert.train_state_to_numpy(back)
    flat, _ = jax.tree_util.tree_flatten_with_path(template)
    assert step == 4 and len(flat) == len(mine)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        _bits(mine[key], np.asarray(leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_resume_equals_straight_run(arch, tmp_path):
    """3 steps, save, restore into a fresh state, 3 more: the parameters
    and moments of 6 straight steps, bit for bit."""
    cfg, straight, _ = _port_state(arch, 6)
    _, state, step = _port_state(arch, 3)
    tlaunch.save(str(tmp_path), 3, state)
    fresh = tloop.init_state(trs.init_params(None, cfg, device="cpu"))
    resumed, at = tlaunch.restore(str(tmp_path), fresh)
    assert at == 3
    for s in range(3, 6):
        resumed, _ = step(resumed, tloaders.recsys_batch(0, s, 8, cfg,
                                                         device="cpu"))
    a, _ = convert.train_state_to_numpy(straight)
    b, _ = convert.train_state_to_numpy(resumed)
    assert a.keys() == b.keys()
    for k in a:
        _bits(a[k], b[k])


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    tlaunch.main(["--arch", "sasrec", "--steps", "12", "--device", "cpu",
                  "--ckpt-dir", ck, "--ckpt-every", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[sasrec] step    1 loss=")
    assert out[1].startswith("[sasrec] step   10 loss=")
    assert tckpt.latest_step(ck) == 10
    tlaunch.main(["--arch", "sasrec", "--steps", "12", "--device", "cpu",
                  "--ckpt-dir", ck, "--resume", "--microbatches", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 10"
    assert out[1].startswith("[sasrec] step   11 loss=")
    tlaunch.main(["--arch", "gemma3-27b", "--steps", "1", "--device",
                  "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[gemma3-27b] step    1 loss=")
    tlaunch.main(["--arch", "equiformer-v2", "--steps", "1", "--device",
                  "cpu", "--microbatches", "2"])        # the GNN runs one
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[equiformer-v2] step    1 loss=")
    with pytest.raises(ValueError, match="retrieval"):
        tlaunch.main(["--arch", "sinnamon-engine", "--device", "cpu"])
