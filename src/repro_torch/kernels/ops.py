"""Operand preparation around the kernels and the scoring-backend dispatch.

Counterpart of ``repro.kernels.ops``.  Every query hot path routes
candidate generation through one selector:

* ``fused``     — kernel A + the merge (:func:`fused_candidates`: one pass
  over every tile, or a sample and a threshold pass); never materialises
  the [B, C] score matrix.  The default.  ``pallas``, the
  reference package's name for its fused backend, is accepted as an alias,
  so a config or ``REPRO_SCORE_BACKEND`` written for ``repro`` works here.
* ``grouped``   — ``engine.score_batch(grouped=True)`` + a dense top-k.
* ``reference`` — the coordinate-at-a-time ``engine.score_batch`` + a dense
  top-k; the correctness oracle.

Select per call (``backend=...``), per server (``score_backend``) or
process-wide with the ``REPRO_SCORE_BACKEND`` environment variable.  A
``score_fn`` (:func:`make_engine_score_fn`: kernel C) overrides the backend
with a dense scorer.

:func:`embed_bag` (sum | mean) puts kernel D under the recsys models'
embedding bags, flat or with DLRM's stacked field tables, differentiable
in the table; :func:`embed_bag_backward` is its gradient kernel.

Each function dispatches on the device of its tensors: the CUDA kernel for
CUDA tensors, its plain twin for CPU tensors (``use_kernel`` overrides:
False runs the twin on the card too, which is how the kernels are checked).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import csr_score as _csr
from repro_torch.kernels import embed_bag as _bag
from repro_torch.kernels import sinnamon_score as _sinn
from repro_torch.obs.trace import span as _span

Tensor = torch.Tensor

SCORE_BACKENDS = ("reference", "grouped", "fused")
#: Other accepted names -> canonical name (``pallas`` is ``repro``'s).
BACKEND_ALIASES = {"pallas": "fused"}
SCORE_BACKEND_ENV = "REPRO_SCORE_BACKEND"
DEFAULT_SCORE_BACKEND = "fused"


def resolve_backend(backend: Optional[str] = None) -> str:
    """Validate a backend choice and return its canonical name (one of
    ``SCORE_BACKENDS``; ``pallas`` -> ``fused``); None ->
    ``$REPRO_SCORE_BACKEND``, else ``fused``."""
    if backend is None:
        backend = os.environ.get(SCORE_BACKEND_ENV, DEFAULT_SCORE_BACKEND)
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend not in SCORE_BACKENDS:
        raise ValueError(f"unknown score backend {backend!r}; expected one "
                         f"of {SCORE_BACKENDS + tuple(BACKEND_ALIASES)}")
    return backend


def pad_axis(x: Tensor, axis: int, multiple: int, fill=0) -> Tensor:
    """Pad ``axis`` of ``x`` up to a multiple of ``multiple`` with ``fill``."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x
    shape = list(x.shape)
    shape[axis] = target - size
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)


def prepare_query_operands(state, spec, q_idx: Tensor, q_val: Tensor,
                           budget: Optional[int] = None):
    """Engine state + padded sparse queries [B, Lq] -> (qv f32[B, L],
    rows int32[B, L, h], brows int32[B, L]).

    Sorts coordinates by |q[j]| descending (stable: Algorithm 6 line 2),
    truncates to the anytime budget and looks up the h sketch rows and the
    bitmap row of each kept coordinate.  Padded coordinates get qv = 0 and
    brows = -1 (the reference gathers their membership words as zeros
    instead; the kernel reads words itself).
    """
    from repro_torch.core import engine as _eng
    Lq = q_idx.shape[-1]
    L = Lq if budget is None else min(budget, Lq)
    key = torch.where(q_idx >= 0, q_val.to(torch.float32).abs(), -1.0)
    order = torch.argsort(-key, dim=-1, stable=True)[..., :L]
    idx_s = q_idx.gather(-1, order)
    val_s = q_val.gather(-1, order).to(torch.float32)
    valid = idx_s >= 0
    safe = torch.where(valid, idx_s, 0).long()
    qv = torch.where(valid, val_s, 0.0)
    rows = state.mappings[:, safe].permute(1, 2, 0)          # [B, L, h]
    brows = torch.where(valid, _eng.coord_rows(spec, idx_s), -1)
    return (qv.contiguous(), rows.to(torch.int32).contiguous(),
            brows.to(torch.int32).contiguous())


def prepare_fused_operands(state, spec, q_idx, q_val, budget=None):
    """Query + state -> (qv, rows, brows, skmat, one_sided) for kernel A.

    On top of :func:`prepare_query_operands`: negative coordinates' sketch
    rows are offset by +m into the stacked [U; L] matrix, so each cell is
    read one-sided.  The state keeps [U; L] stacked already, so ``skmat``
    is ``state.sketch`` itself.  Without a lower sketch, ``skmat`` is U and
    negative coordinates contribute 0 (``one_sided`` False).
    """
    qv, rows, brows = prepare_query_operands(state, spec, q_idx, q_val,
                                             budget)
    if state.l is None:
        return qv, rows, brows, state.sketch, False
    rows = torch.where((qv > 0)[..., None], rows, rows + state.m)
    return qv, rows.contiguous(), brows, state.sketch, True


class Candidates(NamedTuple):
    """Candidates as issued: upper bounds f32[B, k'] and slots int32[B, k']
    in (bound desc, slot asc) order; ``flag``, the two-pass selection's
    flag (int32[1]) on its way to the host, None where nothing can
    overturn them; ``ready``, the event after which ``flag`` holds the
    card's value (None: it does now); ``redo``, the single pass that gives
    the answer where the flag reads nonzero (:func:`flagged`)."""
    vals: Tensor
    slots: Tensor
    flag: Optional[Tensor] = None
    ready: Optional[object] = None
    redo: Optional[Callable] = None


def _flag_to_host(flag: Tensor):
    """``flag`` copied to pinned host memory behind the pass that sets it,
    and the event that marks the copy done: a later read waits for that
    pass alone, not for the merge and the rerank queued after it."""
    if flag.device.type != "cuda":
        return flag, None
    host = torch.empty(flag.shape, dtype=flag.dtype, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(flag.device))
    return host, ready


def _coord_counts(qv: Tensor, brows: Tensor, one_sided: bool) -> Tensor:
    """int64[2] on the operands' device: the scored (query, coordinate)
    pairs (``brows`` >= 0) and those of them with q < 0, which kernel A
    reads from the L rows where the sketch is ``one_sided`` (a padded
    coordinate has q = 0)."""
    lower = qv < 0 if one_sided else torch.zeros_like(qv, dtype=torch.bool)
    return torch.stack((brows >= 0, lower)).sum((1, 2))


def fused_candidates(state, spec, q_idx, q_val, kprime: int, *,
                     budget: Optional[int] = None,
                     ok: Optional[Tensor] = None,
                     use_kernel: Optional[bool] = None,
                     trace=None) -> Candidates:
    """The fused path's candidates, issued and not yet checked: kernel A
    (``sinnamon_score.candidate_scan``: one pass or two, by the batch's
    shape) and the merge.  Read the flag with :func:`flagged` once the
    work that uses them is issued, or take :func:`checked`.

    Slots past the capacity (the last tile's padding) are gated to -inf,
    so any capacity works; tiles are the kernel's ``TILE_C`` slots on every
    device.  A ``trace`` gets the spans ``sketch_scan`` (operand prep and
    kernel A's passes) and ``topk_merge`` (the merge), and the counters
    ``coords`` (the (query, coordinate) pairs kernel A scores, padding
    dropped) and ``lower_coords`` (those of them with a negative value,
    read from the L rows), counted on the device and read with the trace
    (``Trace.count``).
    """
    C = state.sketch.shape[1]
    if kprime > C:
        raise ValueError(f"kprime={kprime} > capacity {C}")
    with _span(trace, "sketch_scan"):
        qv, rows, brows, skmat, one_sided = prepare_fused_operands(
            state, spec, q_idx, q_val, budget)
        if ok is None:
            ok = torch.ones((C,), dtype=torch.bool, device=qv.device)
        args = (qv, rows, brows, state.bits, ok.contiguous(), skmat)
        kw = dict(kprime=kprime, one_sided=one_sided, use_kernel=use_kernel)
        keys, flag = _sinn.candidate_scan(*args, **kw)
        if flag is not None:
            flag, ready = _flag_to_host(flag)
        if trace is not None:       # issued behind kernel A, not before it
            trace.count(("coords", "lower_coords"),
                        _coord_counts(qv, brows, one_sided))
    with _span(trace, "topk_merge"):
        vals, slots = _sinn.merge_keys(keys, kprime)
    if flag is None:
        return Candidates(vals, slots)
    return Candidates(vals, slots, flag, ready, lambda: _sinn.merge_keys(
        _sinn.rescan(*args, **kw), kprime))


def flagged(cands) -> list:
    """Which of the issued :class:`Candidates` must be redone.  A caller
    reads once all of its batches (a sharded index's shards) and the work
    on them are issued; each flag reached the host behind its own pass, so
    the read never waits for that later work."""
    out = []
    for c in cands:
        if c.ready is not None:
            c.ready.synchronize()
        out.append(c.flag is not None and bool(c.flag.item()))
    return out


def checked(cands: Candidates, trace=None):
    """(vals, slots) of issued candidates, their flag read now; a flagged
    batch is redone in one pass, in a span ``fallback_scan`` of a
    device-timed trace, or in ``topk_merge`` of a synced one, whose stages
    stay ``serve.QUERY_STAGES``."""
    if not flagged([cands])[0]:
        return cands.vals, cands.slots
    timed = trace is None or trace.device_timed
    with _span(trace, "fallback_scan" if timed else "topk_merge"):
        return cands.redo()


def sinnamon_score_batch(state, qv: Tensor, rows: Tensor,
                         brows: Tensor) -> Tensor:
    """Kernel C over a query batch: Algorithm 6 upper bounds f32[B, C],
    ungated, from the first three operands of :func:`prepare_fused_operands`
    (rows pre-offset into the stacked sketch)."""
    return _sinn.sinnamon_score(qv, rows, brows, state.bits, state.sketch,
                                one_sided=state.l is not None)


def make_engine_score_fn():
    """A ``score_fn`` for ``engine.topk_candidates`` / ``search_batch``,
    ``SinnamonIndex.search_many`` and ``QueryServer``: kernel C on CUDA
    tensors, its plain twin on CPU tensors.

    The hook is batch-native: ``score_fn(state, spec, q_idx[B, Lq],
    q_val[B, Lq], budget) -> f32[B, C]`` (the reference's hook is per query
    and vmapped; a kernel launch cannot be vmapped).
    """

    def score_fn(state, spec, q_idx, q_val, budget=None):
        qv, rows, brows, _, _ = prepare_fused_operands(state, spec, q_idx,
                                                       q_val, budget)
        return sinnamon_score_batch(state, qv, rows, brows)

    return score_fn


def exact_scores_all(store, q_dense: Tensor, *,
                     use_kernel: Optional[bool] = None) -> Tensor:
    """Exact LinScan: scores of every slot, f32[C] for a query f32[n] or
    f32[B, C] for f32[B, n]."""
    one = q_dense.dim() == 1
    out = _csr.csr_score(q_dense.reshape(-1, q_dense.shape[-1]).contiguous(),
                         store.indices, store.values, None,
                         use_kernel=use_kernel)
    return out[0] if one else out


def embed_bag(table: Tensor, indices: Tensor,
              weights: Optional[Tensor] = None, *, mode: str = "sum",
              out: Optional[Tensor] = None,
              use_kernel: Optional[bool] = None) -> Tensor:
    """EmbeddingBag(sum|mean) on kernel D, one launch: f32[B, D] from
    ``table`` [V, D] and ``indices`` int32[B, hot], or f32[B, F, D] from
    stacked tables [F, V, D] and ``indices`` int32[B, F, hot] (pad -1),
    written into ``out`` when given.  ``weights`` None means ones, which
    the kernel applies itself; ``mean`` divides the weights by each bag's
    count of valid slots (at least 1), as the reference folds it in.

    Where autograd records (grad mode on, ``table.requires_grad``) the call
    goes through ``embed_bag.EmbedBag``, whose backward is kernel D's
    backward kernel (its twin on CPU tensors); ``out`` and weights that
    require a gradient then raise ``ValueError``."""
    if mode == "mean":
        counts = (indices >= 0).sum(-1, keepdim=True).clamp_min(1)
        if weights is None:
            weights = torch.ones(indices.shape, dtype=torch.float32,
                                 device=indices.device)
        weights = weights / counts
    elif mode != "sum":
        raise ValueError(mode)
    if weights is not None:
        weights = weights.contiguous()
    if torch.is_grad_enabled() and table.requires_grad:
        if out is not None:
            raise ValueError("out= is written outside autograd; a table "
                             "that takes a gradient needs out=None")
        if weights is not None and weights.requires_grad:
            raise ValueError("embed_bag's weights take no gradient")
        return _bag.EmbedBag.apply(table, indices, weights, use_kernel)
    return _bag.embed_bag(table, indices, weights, out=out,
                          use_kernel=use_kernel)


def embed_bag_backward(grad_bags: Tensor, indices: Tensor, V: int,
                       weights: Optional[Tensor] = None, *,
                       use_kernel: Optional[bool] = None) -> Tensor:
    """Kernel D's backward: the f32 gradient of :func:`embed_bag`'s bags
    with respect to the table, [F, V, D] from ``grad_bags`` [B, F, D] (any
    row and field stride; DLRM passes rows 1.. of its [B, F+1, D] buffer's
    gradient) or [V, D] from [B, D]; indices as the forward took them."""
    if grad_bags.numel() and grad_bags.stride(-1) != 1:
        grad_bags = grad_bags.contiguous()
    return _bag.embed_bag_backward(grad_bags, indices.to(torch.int32)
                                   .contiguous(), V, weights,
                                   use_kernel=use_kernel)
