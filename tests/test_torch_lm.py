"""The LM family of the port against ``repro.models.transformer``.

Each of the five smoke configs runs through both packages from the same
parameters (the reference's ``init_params``, loaded by
``convert.lm_params_from_numpy``) on the same tokens, with f32 weights (the
launcher's) and activations in f32 (``dtype="float32"``) and in bf16 (the
configs' own):

* ``forward`` (final hidden, aux), ``lm_loss`` (loss, xent, aux) and the
  gradient of every leaf against ``jax.grad``;
* ``prefill`` (f32 last-position logits and the cache), then
  ``decode_step`` from that cache copied into a longer one, past its end
  (``pos >= S``: the reference's ``dynamic_update_slice`` writes the last
  slot while attention reads ``pos + 1`` entries).

Tolerances, as a fraction of the largest |value| of the reference's
tensor: f32 1e-4 (f32 sums in another order, through up to six layers;
the differences seen are ≈1e-6); bf16 activations 5e-2 (a bf16 rounding is
2**-8 ≈ 4e-3 of a value, and a rounding that lands the other way in an
early layer moves the later ones; XLA also keeps fused elementwise chains
in f32 where PyTorch rounds each op; the differences seen are ≤ 2.3e-2).
The bf16 cache entries are within 2 bf16 steps of the reference's (1.6e-2
relative).

The MoE configs in bf16 are held block by block instead: a token whose
top-k experts are near a tie routes by the last bit of its router input,
which bf16 rounding upstream moves, and a route that flips moves that
token's output by O(1) (seen: 1 of 128 tokens in llama4-scout, 4 in
moonshot).  So each attention and MoE block is given the reference's own
input to it and held, with its input and weight gradients (``jax.vjp``),
to the reference's block at the bf16 tolerance; the whole model's loss
within 1e-2 of the reference's.

Also: ``lm_batch`` bit-equal, configs / ``LM_SHAPES`` / ``param_count``
equal to the reference's, the init law, the ``lm_params_*`` round trip,
4 train steps of both packages (losses, grad norms), LM train states
interchanged with the JAX package bit for bit, and each launcher resuming
the other's LM checkpoint.
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
from repro.configs import registry as jreg  # noqa: E402
from repro.data import loaders as jloaders  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import common as tcommon  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import loaders as tloaders  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

ARCHS = ("deepseek-67b", "stablelm-12b", "gemma3-27b",
         "llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")
DTYPES = ("float32", "bfloat16")
MOE = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")
#: whole-model cases: every config in f32, the dense ones also in bf16
CASES = [(a, d) for a in ARCHS for d in DTYPES
         if d == "float32" or a not in MOE]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, S, PROMPT, CACHE, DECODE = 2, 64, 48, 52, 8    # decode positions 48..55


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs diff {err:.3g} > " \
        f"{tol:g} x {scale:.3g}"


def _cfgs(arch, dtype):
    cfg_t = dataclasses.replace(treg.get(arch).smoke_config(), dtype=dtype)
    return cfg_t, jtr.LMConfig(**dataclasses.asdict(cfg_t))


_INIT = jax.jit(jtr.init_params, static_argnums=(1,))


def _params(arch, seed=1, dtype=jnp.float32):
    """The reference's parameters as numpy leaves: f32, or cast to
    ``dtype`` (``init_params(..., dtype)`` casts the same f32 draws)."""
    _, cfg_j = _cfgs(arch, "float32")
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                        _INIT(jax.random.PRNGKey(seed), cfg_j))


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return toks, labels


_RUNS = {}


def _reference(arch, dtype):
    """The reference's outputs for (arch, dtype), computed once."""
    if (arch, dtype) in _RUNS:
        return _RUNS[arch, dtype]
    _, cfg_j = _cfgs(arch, dtype)
    # remat changes what the reference's backward stores, not its values;
    # without it XLA compiles the bundle faster
    cfg_j = dataclasses.replace(cfg_j, remat=False)
    params = _params(arch)
    toks, labels = _tokens(cfg_j.vocab)

    @jax.jit
    def run(p, toks, labels):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jtr.lm_loss(q, toks, labels, cfg_j), has_aux=True)(p)
        hidden, aux = jtr.forward(p, toks, cfg_j)
        logits, cache = jtr.prefill(p, toks[:, :PROMPT], cfg_j)
        return loss, metrics, grads, hidden, aux, logits, cache

    loss, metrics, grads, hidden, aux, logits, pcache = run(params, toks,
                                                            labels)
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, c, t, pos, cfg_j))
    cache = jtr.init_cache(cfg_j, B, CACHE)
    cache = {n: cache[n].at[:, :, :, :PROMPT].set(pcache[n]) for n in cache}
    dec = []
    for i in range(DECODE):
        pos = PROMPT + i
        lg, cache = step(params, cache, toks[:, pos % S][:, None], pos)
        dec.append(np.asarray(lg))
    out = dict(loss=loss, xent=metrics["xent"], aux=aux, maux=metrics["aux"],
               grads=convert.flatten_tree(jax.tree.map(
                   lambda a: np.asarray(a, np.float32), grads)),
               hidden=hidden, logits=logits,
               pcache={n: np.asarray(c, np.float32) for n, c in
                       pcache.items()},
               dec=dec, cache={n: np.asarray(c, np.float32) for n, c in
                               cache.items()})
    _RUNS[arch, dtype] = out
    return out


def _port(arch, dtype, params=None):
    cfg_t, _ = _cfgs(arch, dtype)
    params = _params(arch) if params is None else params
    return cfg_t, convert.lm_params_from_numpy(params, cfg_t, device="cpu")


# -- forward, loss and gradients -----------------------------------------------

@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_and_loss_match_reference(arch, dtype):
    want = _reference(arch, dtype)
    cfg, model = _port(arch, dtype)
    toks, labels = (torch.from_numpy(a) for a in _tokens(cfg.vocab))
    with torch.no_grad():
        hidden, aux = ttr.forward(model, toks, cfg)
        loss, metrics = ttr.lm_loss(model, toks, labels, cfg)
    assert hidden.dtype == cfg.tdtype and aux.dtype == torch.float32
    _close(hidden.float(), want["hidden"], TOL[dtype], "hidden")
    for got, key in ((aux, "aux"), (loss, "loss"), (metrics["xent"], "xent"),
                     (metrics["aux"], "maux")):
        np.testing.assert_allclose(float(got), float(want[key]),
                                   rtol=TOL[dtype] / 10, atol=1e-6,
                                   err_msg=key)
    if not cfg.moe:
        assert float(aux) == 0.0


@pytest.mark.parametrize("arch,dtype", CASES)
def test_gradients_match_jax_grad(arch, dtype):
    want = _reference(arch, dtype)
    cfg, model = _port(arch, dtype)
    toks, labels = (torch.from_numpy(a) for a in _tokens(cfg.vocab))
    loss, _ = ttr.lm_loss(model, toks, labels, cfg)
    loss.backward()
    grads = model.leaves(grad=True)
    assert grads.keys() == want["grads"].keys()
    for k, g in grads.items():
        assert g.dtype == torch.float32
        _close(g, want["grads"][k], TOL[dtype], k)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_decode_match_reference(arch, dtype):
    want = _reference(arch, dtype)
    cfg, model = _port(arch, dtype)
    toks, _ = _tokens(cfg.vocab)
    logits, pcache = ttr.prefill(model, torch.from_numpy(toks[:, :PROMPT]),
                                 cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.vocab)
    assert not logits.requires_grad
    _close(logits, want["logits"], TOL[dtype], "prefill logits")
    cache_tol = 1e-5 if dtype == "float32" else 1.6e-2
    for n in ("k", "v"):
        assert pcache[n].shape == (cfg.n_layers, B, cfg.n_kv_heads, PROMPT,
                                   cfg.head_dim)
        assert pcache[n].dtype == cfg.tdtype
        _close(pcache[n].float(), want["pcache"][n], cache_tol,
               f"prefill cache {n}")
    cache = ttr.init_cache(cfg, B, CACHE, device="cpu")
    for n in cache:
        cache[n][:, :, :, :PROMPT] = pcache[n]
    for i in range(DECODE):
        pos = PROMPT + i
        lg, out = ttr.decode_step(model, cache,
                                  torch.from_numpy(toks[:, pos % S][:, None]),
                                  pos, cfg)
        assert out is cache and lg.dtype == torch.float32
        _close(lg, want["dec"][i], TOL[dtype], f"decode logits at {pos}")
    for n in cache:      # past the end every write landed on slot CACHE - 1
        _close(cache[n].float(), want["cache"][n], cache_tol, f"cache {n}")


@pytest.mark.parametrize("arch", MOE)
def test_moe_blocks_in_bf16_match_reference(arch):
    """Each block given the reference's input to it: outputs, aux and the
    gradients of the block's input and weights (an upstream cotangent
    drawn once), bf16 activations, f32 weights."""
    cfg, model = _port(arch, "bfloat16")
    _, cfg_j = _cfgs(arch, "bfloat16")
    params = _params(arch)
    toks, labels = _tokens(cfg.vocab)
    rng = np.random.default_rng(7)
    positions = np.broadcast_to(np.arange(S), (B, S))
    rot = ttr.layers.rope_tables(
        torch.from_numpy(np.ascontiguousarray(positions)), cfg.head_dim,
        cfg.rope_theta)

    def attn_block(lp, x):
        out, _ = jtr._attention_block(lp, x, positions, cfg=cfg_j, window=0,
                                      mesh=None, rules=None)
        return x + out

    def mlp_block(lp, x):
        y, a = jtr._mlp_block(lp, x, cfg=cfg_j, mesh=None, rules=None)
        return x + y, a

    def port_attn(lp, x):
        q, k, v = ttr._qkv(lp, x, rot, cfg)
        out = ttr.layers.blockwise_attention(q, k, v, chunk=cfg.attn_chunk)
        return x + ttr._out_proj(lp, out)

    def port_mlp(lp, x):
        y, a = ttr._mlp_block(lp, x, cfg)
        return x + y, a

    def with_vjp(fn):
        @jax.jit
        def run(lp, x, ct):
            out, vjp = jax.vjp(fn, lp, x)
            return out, vjp(ct)
        return run

    jfns = {"attn": with_vjp(attn_block), "mlp": with_vjp(mlp_block)}
    names = {"attn": ("ln1", "wq", "wk", "wv", "wo"),
             "mlp": ("ln2", "router", "wi", "wg", "wo_mlp")}
    tol = TOL["bfloat16"]
    x = jnp.take(params["embed"], toks, axis=0).astype(jnp.bfloat16)
    for li in range(cfg.n_layers):
        for kind, tfn in (("attn", port_attn), ("mlp", port_mlp)):
            lp = {k: params["layers"][k][li] for k in names[kind]}
            ct = rng.normal(size=x.shape).astype(np.float32)
            ct = jnp.asarray(ct, jnp.bfloat16)
            out, (g_lp, g_x) = jfns[kind](
                lp, x, (ct, jnp.float32(1.0)) if kind == "mlp" else ct)
            y = out[0] if kind == "mlp" else out
            tlp = {k: torch.from_numpy(np.array(v)).requires_grad_()
                   for k, v in lp.items()}
            tx = torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16).requires_grad_()
            tout = tfn(tlp, tx)
            ty = tout[0] if kind == "mlp" else tout
            what = f"layer {li} {kind}"
            _close(ty.float().detach(), y, tol, what)
            if kind == "mlp":
                np.testing.assert_allclose(float(tout[1].detach()),
                                           float(out[1]),
                                           rtol=1e-3, err_msg=what)
                torch.autograd.backward(
                    [ty, tout[1]], [torch.from_numpy(np.asarray(
                        ct, np.float32)).to(torch.bfloat16),
                        torch.tensor(1.0)])
            else:
                ty.backward(torch.from_numpy(np.asarray(
                    ct, np.float32)).to(torch.bfloat16))
            _close(tx.grad.float(), g_x, tol, f"{what} d/dx")
            for k in names[kind]:
                _close(tlp[k].grad, g_lp[k], tol, f"{what} d/d{k}")
            x = y
    with torch.no_grad():
        loss, _ = ttr.lm_loss(model, torch.from_numpy(toks),
                              torch.from_numpy(labels), cfg)
    want, _ = jtr.lm_loss(params, toks, labels, cfg_j)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-2)


def test_decode_past_the_end_writes_the_last_slot():
    """At ``pos >= S`` the new K/V overwrites slot S - 1 and nothing else,
    and the step's logits are the reference's."""
    arch = "stablelm-12b"
    cfg, model = _port(arch, "float32")
    _, cfg_j = _cfgs(arch, "float32")
    params = _params(arch)
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, 6, cfg.head_dim)
    init = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    cache = {n: torch.from_numpy(init[n].copy()) for n in "kv"}
    tok = np.array([[7]], np.int32)
    lg, cache = ttr.decode_step(model, cache, torch.from_numpy(tok), 9, cfg)
    jlg, jcache = jtr.decode_step(params, init, tok, 9, cfg_j)
    _close(lg, jlg, TOL["float32"], "logits at pos 9 of 6")
    for n in "kv":
        np.testing.assert_array_equal(cache[n][:, :, :, :5].numpy(),
                                      init[n][:, :, :, :5])
        assert not np.array_equal(cache[n][:, :, :, 5].numpy(),
                                  init[n][:, :, :, 5])
        _close(cache[n], jcache[n], 1e-5, f"cache {n}")


def test_bf16_weights_serve_like_reference():
    """The chip's case: bf16 weights (``init_params(..., dtype=bf16)``)
    through prefill and two decode steps."""
    arch = "stablelm-12b"
    params = _params(arch, dtype=jnp.bfloat16)
    cfg, model = _port(arch, "bfloat16", params)
    _, cfg_j = _cfgs(arch, "bfloat16")
    assert model.embed.dtype == torch.bfloat16
    toks, _ = _tokens(cfg.vocab)
    want, jcache = jax.jit(lambda p, t: jtr.prefill(p, t, cfg_j))(
        params, toks[:, :PROMPT])
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, c, t, pos, cfg_j))
    logits, cache = ttr.prefill(model, torch.from_numpy(toks[:, :PROMPT]),
                                cfg)
    _close(logits, want, TOL["bfloat16"], "prefill logits")
    full = {n: torch.zeros((*c.shape[:3], PROMPT + 2, c.shape[4]),
                           dtype=c.dtype) for n, c in cache.items()}
    jfull = {n: jnp.zeros(full[n].shape, jnp.bfloat16).at[
        :, :, :, :PROMPT].set(jcache[n]) for n in jcache}
    for n in full:
        full[n][:, :, :, :PROMPT] = cache[n]
    for pos in (PROMPT, PROMPT + 1):
        t = toks[:, pos][:, None]
        jlg, jfull = step(params, jfull, t, pos)
        lg, full = ttr.decode_step(model, full, torch.from_numpy(t), pos, cfg)
        _close(lg, jlg, TOL["bfloat16"], f"decode logits at {pos}")


def test_entry_points_need_a_device_or_cpu():
    cfg, _ = _cfgs("stablelm-12b", "float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_params(None, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloaders.lm_batch(0, 0, 2, 8, cfg.vocab)


# -- data, configs, parameters -------------------------------------------------

@pytest.mark.parametrize("seed,step,batch,seq,vocab",
                         [(0, 0, 4, 64, 512), (3, 17, 2, 9, 384),
                          (0, 5, 8, 128, 100352)])
def test_lm_batch_bit_equal(seed, step, batch, seq, vocab):
    jt, jl = jloaders.lm_batch(seed, step, batch, seq, vocab)
    tt, tl = tloaders.lm_batch(seed, step, batch, seq, vocab, device="cpu")
    assert tt.dtype == tl.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tl.numpy(), jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_reference(arch):
    jmod, tmod = jreg.get(arch), treg.get(arch)
    assert (tmod.ARCH, tmod.FAMILY) == (jmod.ARCH, jmod.FAMILY) == \
        (arch, "lm")
    assert tmod.SHAPES == jmod.SHAPES == tcommon.LM_SHAPES == \
        jcommon.LM_SHAPES
    for fn in ("full_config", "smoke_config"):
        t, j = getattr(tmod, fn)(), getattr(jmod, fn)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j), fn
        assert t.param_count() == j.param_count(), fn
        assert t.active_param_count() == j.active_param_count(), fn
        np.testing.assert_array_equal(ttr.layer_is_global(t),
                                      jtr.layer_is_global(j))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_shapes_and_init_law(arch):
    cfg = treg.get(arch).smoke_config()
    gen = torch.Generator().manual_seed(0)
    model = ttr.init_params(gen, cfg, device="cpu")
    want = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                  cfg))
    want = convert.flatten_tree(want)
    got = model.leaves()
    assert list(got) == list(want)        # the reference's tree order
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape and t.dtype == torch.float32
    d = cfg.d_model
    for k in ("layers/ln1", "layers/ln2", "ln_f"):
        assert torch.equal(got[k], torch.ones_like(got[k]))
    scales = {"embed": 1.0, "unembed": d ** -0.5, "layers/wq": d ** -0.5,
              "layers/wi": d ** -0.5,
              "layers/wo": d ** -0.5 / np.sqrt(2 * cfg.n_layers),
              "layers/wo_mlp": cfg.d_ff ** -0.5}
    for k, s in scales.items():
        std = float(got[k].std())
        assert abs(std / s - 1) < 0.1, (k, std, s)
    bf = ttr.init_params(torch.Generator().manual_seed(0), cfg,
                         dtype=torch.bfloat16, device="cpu")
    for k, t in bf.leaves().items():      # the same draws, cast
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, got[k].to(torch.bfloat16)), k


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch, dtype):
    params = _params(arch, dtype=dtype)
    cfg = treg.get(arch).smoke_config()
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    back = convert.flatten_tree(convert.lm_params_to_numpy(model))
    want = convert.flatten_tree(params)
    assert back.keys() == want.keys()
    for k, a in want.items():
        assert back[k].tobytes() == np.ascontiguousarray(a).tobytes(), k
    again = convert.lm_params_from_numpy(convert.lm_params_to_numpy(model),
                                         cfg, device="cpu")
    for k, t in again.leaves().items():
        assert torch.equal(t, model.leaves()[k]), k


# -- train states and the launchers -------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=10, decay_steps=12)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["stablelm-12b", "moonshot-v1-16b-a3b"])
def test_train_step_matches_reference(arch, microbatches):
    """The launcher's loss, batches and AdamW through both packages' train
    steps for 4 steps, activations in f32 (bf16's differences are held
    above): the loss of every step within rtol 1e-5, the grad norm within
    1e-4 (f32 sums in another order), the lr within 1e-6."""
    from repro.optim import adamw as jadamw
    cfg, cfg_j = _cfgs(arch, "float32")
    params = _params(arch)
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    jstep = jax.jit(jloop.make_train_step(
        lambda p, b: jtr.lm_loss(p, b[0], b[1], cfg_j),
        jadamw.AdamWConfig(**OPT), microbatches=microbatches))
    tstep = tloop.make_train_step(
        lambda p, b: ttr.lm_loss(p, b[0], b[1], cfg),
        tadamw.AdamWConfig(**OPT), microbatches=microbatches)
    js = jloop.init_state(jax.tree.map(jnp.asarray, params))
    ts = tloop.init_state(model)
    for s in range(4):
        t, lab = jloaders.lm_batch(0, s, 4 * microbatches, 64, cfg.vocab)
        js, jm = jstep(js, (jnp.asarray(t), jnp.asarray(lab)))
        ts, tm = tstep(ts, tloaders.lm_batch(0, s, 4 * microbatches, 64,
                                             cfg.vocab, device="cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {s}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_checkpoints_interchange(arch, tmp_path):
    """A port LM train state (two steps of the launcher's loss and batches)
    restores in JAX bit for bit, and a JAX one in the port."""
    cfg = treg.get(arch).smoke_config()
    model = ttr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = tloop.init_state(model)
    step = tloop.make_train_step(
        lambda p, b: ttr.lm_loss(p, b[0], b[1], cfg),
        tadamw.AdamWConfig(**OPT))
    for s in range(2):
        state, metrics = step(state, tloaders.lm_batch(0, s, 4, 64, cfg.vocab,
                                                       device="cpu"))
        assert np.isfinite(float(metrics["loss"]))
        assert {"xent", "aux", "grad_norm", "lr"} <= set(metrics)
    tlaunch.save(str(tmp_path / "t"), 2, state)
    template = jloop.init_state(jax.tree.map(jnp.asarray,
                                             _params(arch, seed=3)))
    jstate, at, _ = jckpt.restore(str(tmp_path / "t"), template)
    arrays, _ = convert.train_state_to_numpy(state)
    assert at == 2
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        _bits(np.asarray(leaf), arrays[_key(path)])

    jckpt.save(str(tmp_path / "j"), 4, template)
    back = tloop.init_state(ttr.init_params(None, cfg, device="cpu"))
    back, at = tlaunch.restore(str(tmp_path / "j"), back)
    mine, _ = convert.train_state_to_numpy(back)
    flat = jax.tree_util.tree_flatten_with_path(template)[0]
    assert at == 4 and len(flat) == len(mine)
    for path, leaf in flat:
        _bits(mine[_key(path)], np.asarray(leaf))


def _jax_launcher(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jlaunch.main()


def test_launchers_resume_each_others_lm_checkpoints(tmp_path, capsys,
                                                     monkeypatch):
    arch = "moonshot-v1-16b-a3b"
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tlaunch.main(["--arch", arch, "--steps", "10", "--device", "cpu",
                  "--ckpt-dir", port_dir, "--ckpt-every", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"[{arch}] step    1 loss=")
    assert out[1].startswith(f"[{arch}] step   10 loss=")
    assert tckpt.latest_step(port_dir) == 10
    _jax_launcher(monkeypatch, "--arch", arch, "--steps", "12",
                  "--ckpt-dir", port_dir, "--resume")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 10"
    assert out[1].startswith(f"[{arch}] step   11 loss=")

    _jax_launcher(monkeypatch, "--arch", arch, "--steps", "10",
                  "--ckpt-dir", jax_dir, "--ckpt-every", "10")
    jax_lines = capsys.readouterr().out.splitlines()
    tlaunch.main(["--arch", arch, "--steps", "12", "--device", "cpu",
                  "--ckpt-dir", jax_dir, "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 10"
    assert out[1].startswith(f"[{arch}] step   11 loss=")
    assert jax_lines[0].startswith(f"[{arch}] step    1 loss=")
