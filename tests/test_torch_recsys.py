"""Kernel D and the DLRM serving path of the port against the JAX package.

* ``embed_bag_plain`` against the Pallas ``embed_bag`` in interpret mode;
  ``ops.embed_bag`` and ``ref.embed_bag_ref`` against JAX's:
  rtol = atol = 1e-6 (the same products summed in the same order; XLA's
  CPU backend may contract a multiply-add into an FMA).
* ``stacked_embedding_bag`` against ``jax.vmap(recsys.embedding_bag)``:
  bit-equal at hot = 1 (one row plus nothing), rtol = 1e-6 at hot = 4.
* The kernel-path program of the DLRM forward (one stacked call into
  rows 1.. of a [B, F+1, D] buffer, x0 written into row 0 by the bottom
  MLP's last ReLU), run through the stacked form's twin: buffer, bags and
  logits bit-equal to the twin program (``stacked_bag_operands``, the flat
  twin, ``torch.cat``); the buffer against the reference's
  ``jax.vmap(embedding_bag)`` + ``jnp.concatenate`` at hot = 1 and 4:
  bags rtol = atol = 1e-6 (bit-equal at hot = 1), x0 rtol = atol = 1e-5
  (f32 matrix products sum in another order).
* The wrapper's launch plan and its ValueErrors, as plain Python.
* ``loaders.recsys_batch`` bit-equal; configs and shapes equal.
* DLRM ``score`` / ``loss`` / ``user_repr`` / ``item_embeddings`` /
  ``retrieval_scores`` from the same parameters: rtol = atol = 1e-5 (f32
  matrix products sum in another order); top-10 retrieval ids equal.
* The recsys entry points: a model and a config of different models
  raise ``ValueError``; the parameters take gradients, the serving
  entry points record none.
* The model's users served through the port's ``SinnamonIndex`` over the
  sparsified item catalog: ids equal to the JAX index's.

The CUDA kernel itself is held against its twin on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import common as jcommon  # noqa: E402
from repro.configs import dlrm_rm2 as jdlrm  # noqa: E402
from repro.core.engine import EngineSpec as JSpec  # noqa: E402
from repro.core.engine import SinnamonIndex as JIndex  # noqa: E402
from repro.data import loaders as jloaders  # noqa: E402
from repro.kernels import embed_bag as jbag  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import kernels as tkernels  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.configs import dlrm_rm2 as tdlrm  # noqa: E402
from repro_torch.core.engine import EngineSpec as TSpec  # noqa: E402
from repro_torch.core.engine import SinnamonIndex as TIndex  # noqa: E402
from repro_torch.data import loaders as tloaders  # noqa: E402
from repro_torch.kernels import embed_bag as tbag  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402

TABLES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _table(rng, V, D, kind):
    """The same table for both packages: (jax array, torch tensor)."""
    jt = jnp.asarray(rng.normal(0, 1, (V, D)).astype(np.float32),
                     TABLES[kind])
    tt = convert.cells_from_numpy(np.asarray(jt), {
        "f32": torch.float32, "bf16": torch.bfloat16}[kind])
    return jt, tt


def _bags(rng, V, B, F):
    idx = rng.integers(-1, V, (B, F)).astype(np.int32)
    idx[rng.random((B, F)) < 0.2] = -1
    w = rng.normal(0, 1, (B, F)).astype(np.float32)
    return idx, w


# -- 1. the twin against the Pallas kernel -----------------------------------

@pytest.mark.parametrize("kind", list(TABLES))
@pytest.mark.parametrize("V,D,B,F", [(50, 16, 8, 5), (200, 32, 4, 9),
                                     (30, 128, 16, 1), (40, 18, 6, 4)])
def test_embed_bag_twin_matches_pallas_kernel(rng, kind, V, D, B, F):
    jt, tt = _table(rng, V, D, kind)
    idx, w = _bags(rng, V, B, F)
    wz = np.where(idx >= 0, w, 0.0).astype(np.float32)
    want = jbag.embed_bag(jt, jnp.asarray(idx), jnp.asarray(wz),
                          interpret=True)
    got = tbag.embed_bag_plain(tt, torch.from_numpy(idx),
                               torch.from_numpy(wz))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -- 2. ops.embed_bag and the oracle -------------------------------------------

@pytest.mark.parametrize("mode,weighted", [("sum", True), ("mean", True),
                                           ("sum", False), ("mean", False)])
def test_ops_embed_bag_matches_reference(rng, mode, weighted):
    V, D, B, F = 60, 24, 7, 5
    jt, tt = _table(rng, V, D, "f32")
    idx, w = _bags(rng, V, B, F)
    idx[3] = -1                                   # a bag of pads only
    jw = jnp.asarray(w) if weighted else None
    tw = torch.from_numpy(w) if weighted else None
    want = jops.embed_bag(jt, jnp.asarray(idx), jw, mode=mode,
                          interpret=True)
    got = tops.embed_bag(tt, torch.from_numpy(idx), tw, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not got[3].any()


def test_embed_bag_mode_and_oracle(rng):
    jt, tt = _table(rng, 30, 8, "f32")
    idx, w = _bags(rng, 30, 6, 4)
    with pytest.raises(ValueError):
        tops.embed_bag(tt, torch.from_numpy(idx), mode="max")
    want = jref.embed_bag_ref(jt, jnp.asarray(idx), jnp.asarray(w))
    got = tref.embed_bag_ref(tt, torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    twin = tbag.embed_bag_plain(tt, torch.from_numpy(idx),
                                torch.from_numpy(w))
    np.testing.assert_allclose(twin.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- 3. the model's bags --------------------------------------------------------

@pytest.mark.parametrize("hot", [1, 4])
def test_stacked_embedding_bag_matches_vmapped_reference(rng, hot):
    F, V, D, B = 5, 40, 12, 9
    tables = rng.normal(0, 1, (F, V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, F, hot)).astype(np.int32)
    idx[rng.random((B, F, hot)) < 0.25] = -1
    want = jax.vmap(jrs.embedding_bag, (0, 1), 1)(jnp.asarray(tables),
                                                  jnp.asarray(idx))
    got = trs.stacked_embedding_bag(torch.from_numpy(tables),
                                    torch.from_numpy(idx))
    assert got.shape == (B, F, D) and got.dtype == torch.float32
    if hot == 1:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(rng, mode):
    table = rng.normal(0, 1, (30, 8)).astype(np.float32)
    idx = rng.integers(-1, 30, (3, 4, 5)).astype(np.int32)
    want = jrs.embedding_bag(jnp.asarray(table), jnp.asarray(idx), mode)
    got = trs.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                            mode)
    assert got.shape == (3, 4, 8)
    # both divide the bag's sum by its count; XLA may sum the rows in
    # another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_embedding_bag_mean_divides_the_sum(rng):
    """``mean`` is the bag's sum divided by its valid count (at least 1),
    as the reference computes it, bit for bit; other modes raise."""
    table = torch.from_numpy(rng.normal(0, 1, (30, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 30, (6, 5)).astype(np.int32))
    idx[0] = -1
    total = trs.embedding_bag(table, idx, "sum")
    count = (idx >= 0).sum(-1, keepdim=True).clamp_min(1)
    got = trs.embedding_bag(table, idx, "mean")
    assert torch.equal(got, total / count)
    assert torch.equal(got[0], torch.zeros(8))
    with pytest.raises(ValueError):
        trs.embedding_bag(table, idx, "max")


@pytest.mark.parametrize("hot", [1, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_stacked_form_twin_into_buffer(rng, hot, weighted):
    """The stacked form's twin with an output view of stride (F+1)·D: the
    bags land in rows 1.., bit-equal to the flat twin over the field-offset
    operands (the old program), and row 0 keeps its sentinel."""
    F, V, D, B = 6, 50, 16, 11
    tables = torch.from_numpy(rng.normal(0, 1, (F, V, D)).astype(np.float32))
    idx = rng.integers(0, V, (B, F, hot)).astype(np.int32)
    idx[rng.random((B, F, hot)) < 0.25] = -1
    idx = torch.from_numpy(idx)
    w = torch.from_numpy(rng.normal(0, 1, (B, F, hot)).astype(np.float32)) \
        if weighted else None
    vecs = torch.full((B, F + 1, D), -7.0)
    got = tbag.embed_bag(tables, idx, w, out=vecs[:, 1:])
    assert got.data_ptr() == vecs[:, 1:].data_ptr()
    flat, fidx = trs.stacked_bag_operands(tables, idx)
    ones = torch.ones(fidx.shape, dtype=torch.float32)
    want = tbag.embed_bag_plain(flat, fidx,
                                ones if w is None else w.view(-1, hot))
    assert torch.equal(vecs[:, 1:].reshape(-1, D).view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(vecs[:, 0], torch.full((B, D), -7.0))
    alone = tbag.embed_bag(tables, idx, w)
    assert torch.equal(alone.view(torch.int32),
                       vecs[:, 1:].contiguous().view(torch.int32))


@pytest.mark.parametrize("hot", [1, 4])
def test_dlrm_kernel_program_matches_twin_program_and_reference(hot):
    cfg_t = dataclasses.replace(tdlrm.smoke_config(), multi_hot=hot)
    cfg_j = jrs.RecsysConfig(**dataclasses.asdict(cfg_t))
    params = jrs.init_params(jax.random.PRNGKey(4), cfg_j)
    model = convert.recsys_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    tb = tloaders.recsys_batch(1, 2, 24, cfg_t, device="cpu")
    jb = jax.tree.map(jnp.asarray, jloaders.recsys_batch(1, 2, 24, cfg_j))
    with torch.no_grad():               # the serving program
        vecs = model.interaction_input(tb.dense, tb.sparse)
        old = model.interaction_input(tb.dense, tb.sparse, use_kernel=False)
        x0, emb = model.features(tb.dense, tb.sparse)
    assert vecs.shape == (24, cfg_t.n_sparse + 1, cfg_t.embed_dim)
    assert torch.equal(vecs.view(torch.int32), old.view(torch.int32))
    assert emb.data_ptr() == x0.data_ptr() + cfg_t.embed_dim * 4
    assert torch.equal(trs.score(model, tb, cfg_t).view(torch.int32),
                       trs.score(model, tb, cfg_t,
                                 use_kernel=False).view(torch.int32))
    jx0, jemb = jrs._dlrm_features(params, jb, cfg_j)
    want = np.asarray(jnp.concatenate([jx0[:, None, :], jemb], axis=1))
    if hot == 1:
        np.testing.assert_array_equal(vecs[:, 1:].numpy(), want[:, 1:])
    else:
        np.testing.assert_allclose(vecs[:, 1:].numpy(), want[:, 1:],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vecs[:, 0].numpy(), want[:, 0], rtol=1e-5,
                               atol=1e-5)


def _unaligned(t):
    """The same values one element past a 16-byte aligned base."""
    base = torch.empty(t.numel() + 1, dtype=t.dtype)
    base[1:] = t.reshape(-1)
    return base[1:].view(t.shape)


@pytest.mark.parametrize("dtype,D,table_aligned,out_kind,want", [
    # (kind, vec, group)
    (torch.float32, 64, True, "buffer", (0, 4, 16)),
    (torch.bfloat16, 64, True, "buffer", (1, 8, 8)),
    (torch.bfloat16, 64, False, "buffer", (1, 1, 32)),
    (torch.bfloat16, 18, True, "bags", (1, 1, 32)),
    (torch.float32, 4, True, "bags", (0, 4, 1)),
    (torch.float32, 64, False, "buffer", (0, 1, 32)),
    (torch.float32, 64, False, "fresh", (0, 1, 32)),
    (torch.float32, 18, True, "bags", (0, 1, 32)),
    (torch.bfloat16, 8, True, "bags", (1, 8, 1)),
    (torch.float32, 8, True, "bags", (0, 4, 2)),
    (torch.float32, 128, True, "bags", (0, 4, 32)),
    (torch.float32, 256, True, "bags", (0, 4, 32)),
    (torch.float32, 64, True, "odd_stride", (0, 1, 32)),
    (torch.float32, 64, True, "flat", (0, 4, 16)),
    (torch.float32, 64, True, "fresh", (0, 4, 16)),
])
def test_launch_plan(dtype, D, table_aligned, out_kind, want):
    F, V, B = 5, 30, 7
    tables = torch.zeros((F, V, D), dtype=dtype)
    if not table_aligned:
        tables = _unaligned(tables)
    if out_kind == "flat":
        tables = tables[0]
        out = torch.empty((B, D))
    elif out_kind == "buffer":
        out = torch.empty((B, F + 1, D))[:, 1:]
    elif out_kind == "bags":
        out = torch.empty((B, F, D))
    elif out_kind == "fresh":
        out = None
    else:                       # rows 4 B apart from 16-byte multiples
        out = torch.empty((B, F * D + F)).as_strided((B, F, D),
                                                    (F * D + F, D + 1, 1))
    p = tbag.launch_plan(tables, out)
    assert (p.kind, p.vec, p.group) == want
    if out_kind == "flat":
        assert (p.fields, p.field_stride, p.out_bstride) == (1, 0, D)
    elif out_kind == "fresh":
        assert (p.fields, p.field_stride) == (F, V * D)
        assert (p.out_bstride, p.out_fstride) == (F * D, D)
    else:
        assert (p.fields, p.field_stride) == (F, V * D)
        assert (p.out_bstride, p.out_fstride) == out.stride()[:2]
    assert p.group * p.vec >= min(D, 32 * p.vec)


def test_launch_plan_unaligned_output_loads_single_elements():
    """An aligned table into an output view whose base is 4 bytes past a
    16-byte boundary: one element a lane, the view's own strides."""
    tables = torch.zeros((3, 10, 64))
    out = _unaligned(torch.empty((2, 3, 64)))
    assert out.data_ptr() % 16 == 4
    p = tbag.launch_plan(tables, out)
    assert (p.kind, p.vec, p.group) == (0, 1, 32)
    assert (p.out_bstride, p.out_fstride) == (3 * 64, 64)


def _bad_operands():
    tables = torch.zeros((3, 10, 8))
    idx = torch.zeros((4, 3, 2), dtype=torch.int32)
    w = torch.ones((4, 3, 2))
    vecs = torch.zeros((4, 4, 8))
    return {
        "int64_indices": (tables, idx.long(), None, None),
        "indices_f_differs": (tables, idx[:, :2].contiguous(), None, None),
        "indices_not_3d": (tables, idx.view(4, 6), None, None),
        "no_slots": (tables, idx[..., :0].contiguous(), None, None),
        "table_not_contiguous": (tables.transpose(1, 2), idx, None, None),
        "table_int": (tables.int(), idx, None, None),
        "weights_shape": (tables, idx, w[..., :1].contiguous(), None),
        "weights_f64": (tables, idx, w.double(), None),
        "out_too_small": (tables, idx, None, vecs[:3, 1:]),
        "out_too_narrow": (tables, idx, None, vecs[:, 1:, :4]),
        "out_column_stride": (tables, idx, None,
                              vecs.repeat(1, 1, 2)[:, 1:, ::2]),
        "out_bags_overlap": (tables, idx, None, vecs.view(-1).as_strided(
            (4, 3, 8), (8, 4, 1))),
        "out_f64": (tables, idx, None, vecs.double()[:, 1:]),
        "flat_out_overlap": (tables[0], idx[:, 0], None,
                             torch.zeros(64).as_strided((4, 8), (4, 1))),
    }


@pytest.mark.parametrize("case", list(_bad_operands()))
def test_embed_bag_wrapper_rejects_bad_operands(case):
    with pytest.raises(ValueError):
        tbag.check_operands(*_bad_operands()[case])


def test_embed_bag_wrapper_accepts_the_forward_operands():
    tables = torch.zeros((3, 10, 8))
    idx = torch.zeros((4, 3, 1), dtype=torch.int32)
    vecs = torch.zeros((4, 4, 8))
    tbag.check_operands(tables, idx, None, vecs[:, 1:])
    tbag.check_operands(tables, idx, torch.ones((4, 3, 1)), None)
    tbag.check_operands(tables[0], idx[:, 0].contiguous(), None,
                        torch.zeros((4, 8)))


# -- 4. loaders and configs -------------------------------------------------------

@pytest.mark.parametrize("hot", [1, 4])
def test_recsys_batch_bit_equal(hot):
    cfg_t = dataclasses.replace(tdlrm.smoke_config(), multi_hot=hot)
    cfg_j = dataclasses.replace(jdlrm.smoke_config(), multi_hot=hot)
    for seed, step in ((0, 0), (3, 7), (11, 123)):
        got = tloaders.recsys_batch(seed, step, 16, cfg_t, device="cpu")
        want = jloaders.recsys_batch(seed, step, 16, cfg_j)
        assert got._fields == want._fields
        for name, g, w in zip(got._fields, got, want):
            assert g.device.type == "cpu"
            assert g.numpy().dtype == w.dtype, name
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_configs_equal_reference():
    for fn in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(tdlrm, fn)()) == \
            dataclasses.asdict(getattr(jdlrm, fn)())
    assert tcommon.RECSYS_SHAPES == jcommon.RECSYS_SHAPES
    assert tdlrm.SHAPES == jdlrm.SHAPES
    assert (tdlrm.ARCH, tdlrm.FAMILY) == (jdlrm.ARCH, jdlrm.FAMILY)


def test_triu_order_equals_numpy():
    for n in (3, 7, 27):
        iu, ju = torch.triu_indices(n, n, 1)
        niu, nju = np.triu_indices(n, k=1)
        np.testing.assert_array_equal(iu.numpy(), niu)
        np.testing.assert_array_equal(ju.numpy(), nju)
    model = trs.DLRM(tdlrm.smoke_config(), device="cpu")
    niu, nju = np.triu_indices(model.cfg.n_sparse + 1, k=1)
    np.testing.assert_array_equal(model.iu.numpy(), niu)
    np.testing.assert_array_equal(model.ju.numpy(), nju)


# -- 5. the model against the reference -----------------------------------------

def _full_width():
    """rm2 at full MLP and embedding width, vocab cut to 1,000."""
    cfg = tdlrm.full_config()
    return dataclasses.replace(cfg, vocab_per_field=1000, n_items=1000)


CONFIGS = {
    "smoke": (tdlrm.smoke_config(), 16),
    "multi_hot4": (dataclasses.replace(tdlrm.smoke_config(), multi_hot=4),
                   16),
    "full_width": (_full_width(), 8),
}


def _pair(name):
    """(port cfg, JAX cfg, port model, JAX params, port batch, JAX batch)."""
    cfg_t, B = CONFIGS[name]
    cfg_j = jrs.RecsysConfig(**dataclasses.asdict(cfg_t))
    params = jrs.init_params(jax.random.PRNGKey(2), cfg_j)
    model = convert.recsys_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    jb = jax.tree.map(jnp.asarray, jloaders.recsys_batch(0, 5, B, cfg_j))
    tb = tloaders.recsys_batch(0, 5, B, cfg_t, device="cpu")
    return cfg_t, cfg_j, model, params, tb, jb


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dlrm_matches_reference(name):
    cfg_t, cfg_j, model, params, tb, jb = _pair(name)
    np.testing.assert_array_equal(model.tables.detach().numpy(),
                                  np.asarray(params["tables"]))
    close = dict(rtol=1e-5, atol=1e-5)
    for fn in ("score", "loss", "user_repr", "retrieval_scores"):
        got = getattr(trs, fn)(model, tb, cfg_t)
        want = getattr(jrs, fn)(params, jb, cfg_j)
        assert tuple(got.shape) == tuple(want.shape), fn
        assert torch.isfinite(got).all(), fn
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **close, err_msg=fn)
    np.testing.assert_array_equal(trs.item_embeddings(model, cfg_t).numpy(),
                                  np.asarray(jrs.item_embeddings(params,
                                                                 cfg_j)))
    got = torch.topk(trs.retrieval_scores(model, tb, cfg_t), 10).indices
    want = jax.lax.top_k(jrs.retrieval_scores(params, jb, cfg_j), 10)[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_law_and_dtype(dtype):
    """Weights drawn with the reference's law (normal / sqrt(fan_in), zero
    biases) in the asked dtype; a bf16 model serves through kernel D's
    twin with a bf16 table."""
    cfg = dataclasses.replace(tdlrm.smoke_config(), vocab_per_field=4000)
    gen = torch.Generator().manual_seed(3)
    model = trs.init_params(gen, cfg, dtype, device="cpu")
    t = model.tables.to(torch.float32)
    assert model.tables.dtype == getattr(torch, dtype)
    assert abs(float(t.std()) * np.sqrt(cfg.embed_dim) - 1) < 0.01
    assert abs(float(t.mean())) < 0.01
    for lin in (*model.bot, *model.top):
        w = lin.weight.to(torch.float32)
        assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.1
        assert not lin.bias.any()
    assert all(p.requires_grad for p in model.parameters())
    logits = trs.score(model, tloaders.recsys_batch(0, 1, 8, cfg,
                                                    device="cpu"), cfg)
    assert logits.shape == (8,) and torch.isfinite(logits).all()


# -- 6. retrieval through the port index -------------------------------------------

def test_retrieval_through_port_index_matches_jax():
    cfg_t, cfg_j, model, params, tb, jb = _pair("smoke")
    D, t = cfg_t.embed_dim, 8
    items = trs.item_embeddings(model, cfg_t)
    idx, val = trs.sparsify_items(items, t)
    # the example's numpy construction (examples/recsys_retrieval.py)
    np_items = np.asarray(jrs.item_embeddings(params, cfg_j))
    order = np.argsort(-np.abs(np_items), axis=1)[:, :t]
    np_idx = np.sort(order, axis=1).astype(np.int32)
    np.testing.assert_array_equal(idx.numpy(), np_idx)
    np.testing.assert_array_equal(
        val.numpy(), np.take_along_axis(np_items, np_idx, axis=1))

    cap = ((cfg_t.n_items + 31) // 32) * 32
    kw = dict(n=D, m=8, capacity=cap, max_nnz=t, h=1, value_dtype="float32")
    jindex, tindex = JIndex(JSpec(**kw)), TIndex(TSpec(**kw), device="cpu")
    for lo in range(0, cfg_t.n_items, 256):
        hi = min(lo + 256, cfg_t.n_items)
        jindex.insert_many(list(range(lo, hi)), idx[lo:hi].numpy(),
                           val[lo:hi].numpy())
        tindex.insert_many(list(range(lo, hi)), idx[lo:hi], val[lo:hi])
    users = np.array(jrs.user_repr(params, jb, cfg_j))
    q_idx = np.tile(np.arange(D, dtype=np.int32), (users.shape[0], 1))
    want, _ = jindex.search_many(q_idx, users, k=10, kprime=200)
    got, _ = tindex.search_many(q_idx, users, k=10, kprime=200)
    np.testing.assert_array_equal(got, np.asarray(want))
    port_users = trs.user_repr(model, tb, cfg_t).numpy()
    np.testing.assert_allclose(port_users, users, rtol=1e-5, atol=1e-5)


# -- 7. dispatch rules -------------------------------------------------------------

def test_dispatch_rules(rng):
    tkernels.reset_launch_counts()
    _, tt = _table(rng, 20, 8, "f32")
    idx, w = _bags(rng, 20, 4, 3)
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    with pytest.raises(ValueError):
        tbag.embed_bag(tt, ti, tw, use_kernel=True)
    with pytest.raises(ValueError):
        tops.embed_bag(tt, ti, tw, use_kernel=True)
    tbag.embed_bag(tt, ti, tw)
    cfg = tdlrm.smoke_config()
    model = trs.DLRM(cfg, device="cpu")
    trs.score(model, tloaders.recsys_batch(0, 0, 4, cfg, device="cpu"), cfg)
    assert tkernels.launch_counts()["embed_bag"] == 0
    din = dataclasses.replace(cfg, model="din")
    for fn in (trs.score, trs.user_repr):
        with pytest.raises(ValueError, match="'dlrm' model cannot run"):
            fn(model, None, din)
    with pytest.raises(ValueError):
        trs.DLRM(din, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dlrm_gradients_match_jax_grad(name):
    """The DLRM loss's gradient through kernel D's twins (forward and
    backward) against ``jax.grad`` of the reference's loss: rtol = 1e-4,
    atol = 1e-6 (sums in another order; atol for entries near 0)."""
    cfg_t, cfg_j, model, params, tb, jb = _pair(name)
    want = convert.flatten_tree(jax.tree.map(
        np.asarray, jax.grad(lambda p: jrs.loss(p, jb, cfg_j))(params)))
    trs.loss(model, tb, cfg_t).backward()
    got = model.leaves(grad=True)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_dlrm_serving_path_unchanged_under_no_grad():
    """Without gradients DLRM serves through the one-buffer form (x0
    written by the last ReLU, no autograd node); with them the buffer is
    ``InteractionInput``'s; both hold the same bits."""
    cfg = tdlrm.smoke_config()
    model = trs.DLRM(cfg, device="cpu")
    b = tloaders.recsys_batch(0, 2, 16, cfg, device="cpu")
    with torch.no_grad():
        served = model.interaction_input(b.dense, b.sparse)
    trained = model.interaction_input(b.dense, b.sparse)
    assert served.grad_fn is None
    assert type(trained.grad_fn).__name__ == "InteractionInputBackward"
    assert torch.equal(served.view(torch.int32),
                       trained.detach().view(torch.int32))
