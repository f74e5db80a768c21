"""Cell builders for the dry run, as ``repro.launch.cells``: for every
(architecture × input shape) the step to run, its inputs as DTensors of
fake local shards placed by the logical-axis rules, and the meta
(``model_flops`` and so on) of the roofline report.

The reference lowers each step with ``jit(in_shardings=...)`` over
``ShapeDtypeStruct`` stand-ins.  The port runs the step itself, eagerly,
on DTensors whose local shards are fake tensors (no storage), inside the
fake process group and ``FakeTensorMode`` that ``repro_torch.launch.dryrun``
brings up; :func:`build` must run inside them.  Every input leaf is placed
by ``rules.spec_for`` on the leaf's shape and logical axes, as the
reference's ``tree_sharding`` places it.

Donation: the reference donates the train state and the decode cache
(``donate_argnums``).  The port's train step and decode step write the
parameters, the moments and the cache in place, which is what donation
buys XLA; the prefill builds its cache inside the step.  So no argument
is counted twice.

``n_layers`` cuts an LM or the GNN to that depth (the dry run traces 1
and 2 layers and extrapolates; ``repro_torch.launch.dryrun``); ``meta``
always describes the full config.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import registry
from repro_torch.core import engine as eng
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed import rules as R
from repro_torch.models import param_axes, recsys
from repro_torch.models import transformer as tr
from repro_torch.optim import adamw
from repro_torch.serving import sharded
from repro_torch.train import loop


class CellBundle(NamedTuple):
    fn: Callable            # the step: fn(*args)
    args: Tuple             # DTensor (or fake) inputs
    donate_argnums: Tuple[int, ...]
    meta: dict              # MODEL_FLOPS etc. for the roofline report


OPT_CFG = adamw.AdamWConfig()


# ---------------------------------------------------------------------------
# Placing abstract leaves
# ---------------------------------------------------------------------------

def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def abstract_dtensor(mesh, shape, dtype, logical, rules=None,
                     requires_grad: bool = False):
    """A DTensor of ``shape`` placed by ``logical`` whose local shard is an
    empty tensor on the mesh's device (fake inside ``FakeTensorMode``).  On
    a one-device mesh the plain tensor itself: nothing is sharded, and the
    models take their single-device path."""
    spec = R.spec_for(mesh, shape, logical, rules)
    return _place(mesh, shape, dtype, spec).requires_grad_(requires_grad)


def _place(mesh, shape, dtype, spec):
    from torch.distributed.tensor import DTensor

    local = torch.empty(R.local_shape(mesh, shape, spec), dtype=dtype,
                        device=mesh.device_type)
    if R.mesh_size(mesh) == 1:
        return local
    return DTensor.from_local(local, mesh, R.placements_for(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def abstract(make, *args, **kwargs):
    """``make(*args, **kwargs)`` (an ``abstract_params``: a model on
    ``meta``) with the fake mode lifted: ``meta`` tensors need none, and
    module construction swaps parameters, which fake tensors refuse."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return make(*args, **kwargs)


def place_model(model: nn.Module, axes: dict, mesh, rules=None,
                requires_grad: bool = False) -> nn.Module:
    """Swap every parameter of an abstract (``meta``) model for a DTensor
    parameter placed by the family's logical axes."""
    by_name = param_axes(model, axes)
    specs = {name: R.spec_for(mesh, p.shape, by_name[name].axes, rules)
             for name, p in model.named_parameters()}
    return _place_params(model, specs, mesh, requires_grad)


def _place_params(model: nn.Module, specs: dict, mesh,
                  requires_grad: bool = False) -> nn.Module:
    """Swap every parameter of an abstract model for a DTensor parameter
    placed by ``specs`` ({parameter name: spec})."""
    for name, p in list(model.named_parameters()):
        owner = model
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        dt = _place(mesh, p.shape, p.dtype, specs[name])
        setattr(owner, leaf, nn.Parameter(dt, requires_grad=requires_grad))
    return model


def _opt_state(mesh, model, axes: dict, rules=None) -> adamw.OptState:
    """f32 moments placed like their parameters, as the reference's
    ``_opt_axes``; the step a replicated 0-d int32."""
    flat = R.flat_axes(axes)
    leaves = model.leaves()

    def moments():
        return {k: abstract_dtensor(mesh, p.shape, torch.float32,
                                    flat[k].axes, rules)
                for k, p in leaves.items()}

    return adamw.OptState(m=moments(), v=moments(),
                          step=abstract_dtensor(mesh, (), torch.int32, ()))


def _train_state(mesh, model, axes, rules) -> loop.TrainState:
    model = place_model(model, axes, mesh, rules, requires_grad=True)
    return loop.TrainState(model, _opt_state(mesh, model, axes, rules), None)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_flops(cfg, shape) -> dict:
    tokens = shape["batch"] * (shape["seq"] if shape["kind"] != "lm_decode"
                               else 1)
    n_active = cfg.active_param_count()
    mult = 6 if shape["kind"] == "lm_train" else 2
    return {"model_flops": mult * n_active * tokens,
            "params": cfg.param_count(), "active_params": n_active,
            "tokens": tokens}


def lm_depth_config(cfg, n_layers: int, global_only: bool = False):
    """``cfg`` cut to ``n_layers``; ``global_only`` makes every layer a
    global-attention layer (gemma3's other window kind)."""
    out = dataclasses.replace(cfg, n_layers=n_layers)
    if global_only:
        out = dataclasses.replace(out, local_global_ratio=0, local_window=0)
    return out


def build_lm(mod, shape, mesh, rules=None, n_layers: Optional[int] = None,
             global_only: bool = False) -> CellBundle:
    full = mod.full_config()
    cfg = full if n_layers is None else lm_depth_config(full, n_layers,
                                                        global_only)
    kind = shape["kind"]
    B, S = shape["batch"], shape["seq"]
    meta = meta_for(mod, shape)
    ax = tr.logical_axes(cfg)

    if kind == "lm_train":
        state = _train_state(mesh, abstract(tr.abstract_params, cfg), ax,
                             rules)
        batch = tuple(abstract_dtensor(mesh, (B, S), torch.int32,
                                       ("batch", "seq"), rules)
                      for _ in range(2))

        def loss_fn(params, b):
            return tr.lm_loss(params, b[0], b[1], cfg, mesh=mesh,
                              rules=rules)

        step = loop.make_train_step(loss_fn, OPT_CFG)
        return CellBundle(step, (state, batch), (0,), meta)

    # serving weights
    params = place_model(abstract(tr.abstract_params, cfg, torch.bfloat16),
                         ax, mesh, rules)
    if kind == "lm_prefill":
        tokens = abstract_dtensor(mesh, (B, S), torch.int32,
                                  ("batch", "seq"), rules)
        fn = lambda p, t: tr.prefill(p, t, cfg, mesh=mesh,     # noqa: E731
                                     rules=rules)
        return CellBundle(fn, (params, tokens), (), meta)

    # decode: one new token against a full KV cache of S entries
    cax = tr.cache_logical_axes()
    cache = {k: abstract_dtensor(mesh, t.shape, t.dtype, cax[k].axes, rules)
             for k, t in abstract(tr.abstract_cache, cfg, B, S).items()}
    tokens = abstract_dtensor(mesh, (B, 1), torch.int32, ("batch", None),
                              rules)
    fn = lambda p, c, t, pos: tr.decode_step(p, c, t, pos, cfg,  # noqa: E731
                                             mesh=mesh, rules=rules)
    return CellBundle(fn, (params, cache, tokens, S - 1), (1,), meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_flops(cfg, shape) -> dict:
    """The reference's eSCN per-edge cost: the two rotations (2 ·
    Σ(2l+1)² · C) and the SO(2) products, times 6 (forward and backward)
    a layer."""
    lm = cfg.l_max
    rot = 2 * sum((2 * l + 1) ** 2 for l in range(lm + 1)) * cfg.c
    conv = ((lm + 1) * cfg.c) ** 2 + 2 * sum(
        ((lm + 1 - m) * cfg.c) ** 2 * 2 for m in range(1, cfg.m_max + 1))
    return {"arch_kind": "gnn_train",
            "model_flops": 6 * shape["n_edges"] * (rot + conv) * cfg.n_layers,
            "params": None, "tokens": shape["n_edges"]}


def build_gnn(mod, shape, mesh, rules=None,
              n_layers: Optional[int] = None) -> CellBundle:
    """One AdamW step of EquiformerV2 on the whole padded graph: node
    tensors replicated, edges over the data axes, the parameters placed by
    ``gnn_sharded.param_shardings``; ``gnn_sharded.loss_fn_sharded`` on a
    mesh of more than one device, ``gnn.loss_fn`` on one.  ``n_graphs``
    is static (the reference re-attaches it inside the step)."""
    from repro_torch.models import gnn, gnn_sharded

    full = mod.full_config(shape)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    pn, pe = shape["pad_nodes"], shape["pad_edges"]
    n_graphs = shape.get("batch_graphs", 1)
    dax = gnn_sharded.data_axes(mesh)
    edges = (dax if len(dax) > 1 else dax[0],) if dax else ()
    node_class = shape["task"] == "node_class"
    f32, i32 = torch.float32, torch.int32
    g = gnn.GraphBatch(
        node_feat=_place(mesh, (pn, shape["d_feat"]), f32, ()),
        edge_src=_place(mesh, (pe,), i32, edges),
        edge_dst=_place(mesh, (pe,), i32, edges),
        edge_vec=_place(mesh, (pe, 3), f32, edges),
        labels=_place(mesh, (pn,) if node_class else (n_graphs,),
                      i32 if node_class else f32, ()),
        forces=_place(mesh, (pn, 3), f32, ()),
        graph_id=_place(mesh, (pn,), i32, ()), n_graphs=n_graphs)
    specs = gnn_sharded.param_pspecs(cfg)
    model = _place_params(abstract(gnn.abstract_params, cfg),
                          {k.replace("/", "."): s for k, s in specs.items()},
                          mesh, requires_grad=True)
    lv = model.leaves()

    def moments():
        return {k: _place(mesh, p.shape, torch.float32, specs[k])
                for k, p in lv.items()}

    state = loop.TrainState(model, adamw.OptState(
        m=moments(), v=moments(), step=_place(mesh, (), torch.int32, ())),
        None)

    def loss_fn(params, batch):
        if R.mesh_size(mesh) > 1:
            return gnn_sharded.loss_fn_sharded(params, batch, cfg, mesh)
        return gnn.loss_fn(params, batch, cfg, mesh=mesh, rules=rules)

    step = loop.make_train_step(loss_fn, OPT_CFG)
    return CellBundle(step, (state, g), (0,), _gnn_flops(full, shape))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def recsys_batch(mesh, cfg, B: int, rules=None) -> recsys.RecsysBatch:
    ax = recsys.batch_logical_axes()
    shapes = recsys.RecsysBatch(
        dense=((B, cfg.n_dense), torch.float32),
        sparse=((B, cfg.n_sparse, cfg.multi_hot), torch.int32),
        hist=((B, cfg.seq_len), torch.int32),
        target=((B,), torch.int32),
        labels=((B,), torch.float32))
    return recsys.RecsysBatch(*(
        abstract_dtensor(mesh, s, dt, a.axes, rules)
        for (s, dt), a in zip(shapes, ax)))


def _recsys_flops(cfg, B) -> int:
    D = cfg.embed_dim
    if cfg.model == "dlrm":
        dims_b = (cfg.n_dense,) + cfg.bot_mlp
        dims_t = (cfg.bot_mlp[-1] + (cfg.n_sparse + 1) * cfg.n_sparse // 2,
                  ) + cfg.top_mlp
        mlp = sum(a * b for a, b in zip(dims_b[:-1], dims_b[1:])) + \
            sum(a * b for a, b in zip(dims_t[:-1], dims_t[1:]))
        inter = (cfg.n_sparse + 1) ** 2 * D
        return 2 * B * (mlp + inter)
    if cfg.model == "din":
        att = cfg.seq_len * (4 * D * cfg.attn_mlp[0]
                             + cfg.attn_mlp[0] * cfg.attn_mlp[1])
        m = 2 * D * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1]
        return 2 * B * (att + m)
    if cfg.model == "sasrec":
        S = cfg.seq_len
        return 2 * B * cfg.n_blocks * (4 * S * D * D + 2 * S * S * D)
    S = cfg.seq_len
    return 2 * B * cfg.capsule_iters * (2 * S * cfg.n_interests * D + D * D)


def build_recsys(mod, shape, mesh, rules=None) -> CellBundle:
    cfg = mod.full_config()
    kind = shape["kind"]
    B = shape["batch"]
    batch = recsys_batch(mesh, cfg, B, rules)
    meta = meta_for(mod, shape)
    ax = recsys.logical_axes(cfg)

    if kind == "recsys_train":
        state = _train_state(mesh, abstract(recsys.abstract_params, cfg),
                             ax, rules)

        def loss_fn(params, b):
            return recsys.loss(params, b, cfg, mesh=mesh, rules=rules), {}

        step = loop.make_train_step(loss_fn, OPT_CFG)
        return CellBundle(step, (state, batch), (0,), meta)

    params = place_model(abstract(recsys.abstract_params, cfg), ax, mesh,
                         rules)
    if kind == "recsys_serve":
        fn = lambda p, b: recsys.score(p, b, cfg, mesh=mesh,  # noqa: E731
                                       rules=rules)
        return CellBundle(fn, (params, batch), (), meta)

    # retrieval_cand: batched-dot MIPS against the full candidate set
    k = shape["k"]

    def fn(p, b):
        s = recsys.retrieval_scores(p, b, cfg, mesh=mesh, rules=rules)
        return torch.topk(s, k)

    return CellBundle(fn, (params, batch), (), meta)


# ---------------------------------------------------------------------------
# Retrieval-engine cells (the paper's own workload)
# ---------------------------------------------------------------------------

def abstract_state(mesh, spec: eng.EngineSpec, n_shards: int):
    """The global state of ``n_shards`` shards of ``spec`` (per-shard
    capacity), each leaf placed by ``sharded.state_pspecs``."""
    st = abstract(eng.init, spec, "meta")
    specs = sharded.state_pspecs(mesh, spec.upper_only)

    def place(t, pspec, slot_dim):
        shape = list(t.shape)
        if slot_dim is not None:
            shape[slot_dim] *= n_shards
        return _place(mesh, shape, t.dtype, pspec)

    return eng.SinnamonState(
        mappings=place(st.mappings, specs.mappings, None),
        sketch=place(st.sketch, specs.sketch, 1),
        bits=place(st.bits, specs.bits, 1),
        store=type(st.store)(place(st.store.indices, specs.store.indices, 0),
                             place(st.store.values, specs.store.values, 0)),
        active=place(st.active, specs.active, 0),
        ids=place(st.ids, specs.ids, 0),
        dirty=place(st.dirty, specs.dirty, 0),
        m=st.m)


def build_retrieval(mod, shape, mesh, rules=None) -> CellBundle:
    corpus_ax = meshlib.corpus_axes(mesh)
    n = meshlib.n_shards(mesh, corpus_ax)
    spec = mod.full_config(shape, n)
    state = abstract_state(mesh, spec, n)
    B, Lq = shape["batch"], shape["psi_q"]
    # the queries over 'data' alone, as the reference's P("data")
    qspec = ("data",) if "data" in R.axis_names(mesh) else ()
    q = tuple(_place(mesh, (B, Lq), dt, qspec)
              for dt in (torch.int32, torch.float32))
    step = sharded.make_search_step(mesh, spec, k=shape["k"],
                                    kprime_local=shape["kprime_local"])
    return CellBundle(step, (state,) + q, (), meta_for(mod, shape, n))


# ---------------------------------------------------------------------------

def meta_for(mod, shape: dict, n_corpus_shards: int = 1) -> dict:
    """The cell's ``meta`` (``model_flops`` and what the roofline report
    needs), the reference's formulas for every LM, recsys and retrieval
    cell."""
    kind = shape["kind"]
    if mod.FAMILY == "lm":
        meta = _lm_flops(mod.full_config(), shape)
        meta["arch_kind"] = kind
        return meta
    if mod.FAMILY == "recsys":
        cfg, B = mod.full_config(), shape["batch"]
        meta = {"arch_kind": kind, "model_flops": _recsys_flops(cfg, B),
                "tokens": B}
        if kind == "recsys_train":
            meta["model_flops"] *= 3
        elif kind == "recsys_retrieval":
            meta["model_flops"] = (2 * B * shape["n_candidates"]
                                   * cfg.embed_dim)
        return meta
    if mod.FAMILY == "retrieval":
        spec = mod.full_config(shape, n_corpus_shards)
        B, Lq = shape["batch"], shape["psi_q"]
        # scoring reads ψ_q rows of U and the bitmask per query coordinate
        flops = B * Lq * (spec.h * 2 + 2) * spec.capacity * n_corpus_shards
        return {"arch_kind": "retrieval_serve", "model_flops": flops,
                "tokens": B}
    if mod.FAMILY == "gnn":
        return _gnn_flops(mod.full_config(shape), shape)
    raise ValueError(f"no dry-run cell for the {mod.FAMILY!r} family")


def build(arch: str, shape_name: str, mesh, rules=None,
          n_layers: Optional[int] = None,
          global_only: bool = False) -> CellBundle:
    mod = registry.get(arch)
    return build_for(mod, mod.SHAPES[shape_name], mesh, rules, n_layers,
                     global_only)


def build_for(mod, shape: dict, mesh, rules=None,
              n_layers: Optional[int] = None,
              global_only: bool = False) -> CellBundle:
    """:func:`build` for a config module (``FAMILY``, ``full_config``) and
    a shape dict."""
    fam = mod.FAMILY
    if fam == "lm":
        return build_lm(mod, shape, mesh, rules, n_layers, global_only)
    if fam == "gnn":
        return build_gnn(mod, shape, mesh, rules, n_layers)
    if fam == "recsys":
        return build_recsys(mod, shape, mesh, rules)
    if fam == "retrieval":
        return build_retrieval(mod, shape, mesh, rules)
    raise ValueError(fam)
