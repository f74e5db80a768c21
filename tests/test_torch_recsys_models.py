"""DIN, SASRec and MIND of the port against the JAX package, and the
recsys configs and arch registry.

* ``score`` / ``loss`` / ``user_repr`` / ``retrieval_scores`` of each model
  (DLRM too) from the same parameters (``convert.recsys_params_from_numpy``
  of the reference's ``init_params``) on the same batches
  (``loaders.recsys_batch``), at the smoke config and at full width with
  the vocabulary cut to 1,000 items: rtol = atol = 1e-5 (f32 matrix
  products, softmaxes and norms sum in another order).
* The gradient of each model's loss against ``jax.grad``: rtol = 1e-4,
  atol = 1e-6 (the backward sums in another order again; atol for the
  entries near 0).
* The negative-sampling hashes' uint32 wrapping arithmetic, including a
  pad (-1 → 2**32 - 1), bit-equal to numpy's uint32.
* Leaf paths, shapes and the init law; ``recsys_params_to_numpy`` the
  inverse of ``recsys_params_from_numpy``; configs, ``ARCHS``,
  ``ASSIGNED``, ``get`` and ``all_cells`` equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import registry as jreg  # noqa: E402
from repro.data import loaders as jloaders  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import loaders as tloaders  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402

ARCHS = ("din", "sasrec", "mind", "dlrm-rm2")
CLOSE = dict(rtol=1e-5, atol=1e-5)
GRAD_CLOSE = dict(rtol=1e-4, atol=1e-6)


def _cfg(arch, size):
    cfg = treg.get(arch).smoke_config() if size == "smoke" \
        else treg.get(arch).full_config()
    if size == "full_width":
        cfg = dataclasses.replace(cfg, n_items=1000, vocab_per_field=1000)
    return cfg


def _pair(arch, size, B=8, seed=1, step=3):
    """(port cfg, JAX cfg, port model, JAX params, port batch, JAX batch)."""
    cfg_t = _cfg(arch, size)
    cfg_j = jrs.RecsysConfig(**dataclasses.asdict(cfg_t))
    params = jrs.init_params(jax.random.PRNGKey(seed), cfg_j)
    model = convert.recsys_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg_t, device="cpu")
    jb = jax.tree.map(jnp.asarray, jloaders.recsys_batch(0, step, B, cfg_j))
    tb = tloaders.recsys_batch(0, step, B, cfg_t, device="cpu")
    return cfg_t, cfg_j, model, params, tb, jb


@pytest.mark.parametrize("size", ["smoke", "full_width"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, size):
    cfg_t, cfg_j, model, params, tb, jb = _pair(arch, size)
    for fn in ("score", "loss", "user_repr", "retrieval_scores"):
        got = getattr(trs, fn)(model, tb, cfg_t)
        want = np.asarray(getattr(jrs, fn)(params, jb, cfg_j))
        assert tuple(got.shape) == want.shape, fn
        assert torch.isfinite(got).all(), fn
        np.testing.assert_allclose(got.detach().numpy(), want, **CLOSE,
                                   err_msg=fn)
    np.testing.assert_array_equal(
        trs.item_embeddings(model, cfg_t).numpy(),
        np.asarray(jrs.item_embeddings(params, cfg_j)))


@pytest.mark.parametrize("size", ["smoke", "full_width"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_grad(arch, size):
    cfg_t, cfg_j, model, params, tb, jb = _pair(arch, size, step=4)
    want = convert.flatten_tree(jax.tree.map(
        np.asarray, jax.grad(lambda p: jrs.loss(p, jb, cfg_j))(params)))
    trs.loss(model, tb, cfg_t).backward()
    got = model.leaves(grad=True)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **GRAD_CLOSE,
                                   err_msg=k)


def test_serving_entry_points_record_no_graph():
    cfg_t, _, model, _, tb, _ = _pair("sasrec", "smoke")
    assert all(p.requires_grad for p in model.parameters())
    for fn in ("score", "user_repr", "retrieval_scores"):
        assert not getattr(trs, fn)(model, tb, cfg_t).requires_grad
    assert not trs.item_embeddings(model, cfg_t).requires_grad
    assert trs.loss(model, tb, cfg_t).requires_grad


@pytest.mark.parametrize("c", [2654435761, 12345, 1, 0xFFFFFFFF])
def test_uint32_hash_arithmetic_wraps_like_numpy(c):
    rng = np.random.default_rng(c % 1000)
    x = rng.integers(-1, 2**31 - 1, 4096).astype(np.int32)
    x[:3] = [-1, 0, 2**31 - 1]
    want = x.astype(np.uint32) * np.uint32(c)
    got = trs._mul_u32(trs._u32(torch.from_numpy(x)), c)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sasrec_negatives_of_pads_match_reference():
    """The negative items the reference draws for a padded history, -1
    pads included, are the port's (the loss masks the pads, so only the
    hash itself can show it)."""
    hist = np.array([[-1, 5, 0, 999_999, -1]], np.int32)
    want = ((hist.astype(np.uint32) * np.uint32(2654435761)
             + np.uint32(12345)) % np.uint32(1_000_000)).astype(np.int64)
    neg = (trs._mul_u32(trs._u32(torch.from_numpy(hist)), 2654435761)
           + 12345) & 0xFFFFFFFF
    np.testing.assert_array_equal((neg % 1_000_000).numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_shapes_and_init_law(arch):
    """Leaf paths and shapes are the reference's, in its tree order; the
    drawn weights follow its law (normal / sqrt(fan_in) for tables and
    MLP weights of 1,000 elements or more, zero biases, unit norms, pos at
    0.02)."""
    cfg = _cfg(arch, "smoke")
    cfg = dataclasses.replace(cfg, n_items=4000)
    ref = convert.flatten_tree(jax.tree.map(
        np.asarray, jrs.init_params(jax.random.PRNGKey(0), jrs.RecsysConfig(
            **dataclasses.asdict(cfg)))))
    model = trs.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    leaves = model.leaves()
    assert list(leaves) == list(ref)
    for k, t in leaves.items():
        assert tuple(t.shape) == ref[k].shape, k
        assert t.dtype == torch.float32
        name = k.split("/")[-1]
        if name.startswith("b") and name[1:].isdigit() or name.startswith(
                "ln"):
            want = 0.0 if name.startswith("b") else 1.0
            assert torch.all(t == want), k
        elif t.numel() >= 1000 and (name in ("table", "tables", "bilinear")
                                    or name[0] == "w"):
            fan_in = t.shape[-2] if name[0] == "w" and t.dim() > 1 else \
                t.shape[-1]
            sd = float(t.detach().std()) * np.sqrt(fan_in)
            assert abs(sd - 1) < 0.15, (k, sd)
        elif name == "pos":
            assert abs(float(t.detach().std()) - 0.02) < 0.005


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_from_numpy(arch):
    cfg = _cfg(arch, "smoke")
    model = trs.init_params(torch.Generator().manual_seed(6), cfg,
                            device="cpu")
    tree = convert.recsys_params_to_numpy(model)
    back = convert.recsys_params_from_numpy(tree, cfg, device="cpu")
    for (k, a), (k2, b) in zip(model.leaves().items(),
                               back.leaves().items()):
        assert k == k2
        assert torch.equal(a, b), k
    jparams = jax.tree.map(jnp.asarray, tree)
    jb = jax.tree.map(jnp.asarray, jloaders.recsys_batch(
        0, 1, 4, jrs.RecsysConfig(**dataclasses.asdict(cfg))))
    tb = tloaders.recsys_batch(0, 1, 4, cfg, device="cpu")
    np.testing.assert_allclose(
        trs.score(model, tb, cfg).numpy(),
        np.asarray(jrs.score(jparams, jb, jrs.RecsysConfig(
            **dataclasses.asdict(cfg)))), **CLOSE)


def test_model_and_config_of_different_models_raise():
    din = _cfg("din", "smoke")
    model = trs.init_params(None, _cfg("mind", "smoke"), device="cpu")
    batch = tloaders.recsys_batch(0, 0, 2, din, device="cpu")
    for fn in (trs.score, trs.loss, trs.user_repr, trs.retrieval_scores):
        with pytest.raises(ValueError):
            fn(model, batch, din)
    with pytest.raises(ValueError):
        trs.item_embeddings(model, din)
    for cls in trs.MODELS.values():
        if cls.MODEL != "din":
            with pytest.raises(ValueError):
                cls(din, device="cpu")
    with pytest.raises(ValueError):
        convert.recsys_params_from_numpy({}, dataclasses.replace(
            din, model="gru4rec"), device="cpu")


# -- configs and the registry -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("equiformer-v2",))
def test_configs_equal_reference(arch):
    jmod, tmod = jreg.get(arch), treg.get(arch)
    assert (tmod.ARCH, tmod.FAMILY) == (jmod.ARCH, jmod.FAMILY)
    assert tmod.SHAPES == jmod.SHAPES
    for fn in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(tmod, fn)()) == \
            dataclasses.asdict(getattr(jmod, fn)()), fn


def test_registry_matches_reference():
    assert treg.ARCHS == jreg.ARCHS
    assert treg.ASSIGNED == jreg.ASSIGNED
    for arch in jreg.ARCHS:
        mod = treg.get(arch)
        assert mod.__name__.startswith("repro_torch.configs.")
        assert mod.FAMILY == jreg.get(arch).FAMILY
    for extra in (False, True):
        assert list(treg.all_cells(extra)) == list(jreg.all_cells(extra))
    with pytest.raises(KeyError):
        treg.get("gpt-5")


def test_sinnamon_engine_config_matches_reference():
    jmod, tmod = jreg.get("sinnamon-engine"), treg.get("sinnamon-engine")
    assert tmod.SHAPES == jmod.SHAPES and tmod.FAMILY == "retrieval"
    fields = ("n", "m", "capacity", "max_nnz", "h", "positive_only",
              "index_buckets", "sketch_kind", "dtype", "value_dtype", "seed")
    for shape in tmod.SHAPES.values():
        a, b = tmod.full_config(shape, 8), jmod.full_config(shape, 8)
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
    a, b = tmod.smoke_config(), jmod.smoke_config()
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
