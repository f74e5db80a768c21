"""Sinnamon: the approximate streaming SMIPS engine (paper §4) in PyTorch.

Counterpart of ``repro.core.engine``: plain functions on tensors plus a
thin host wrapper that owns slot allocation, the id map and capacity
growth.  Where the reference returns a new state, these functions update
the state's tensors **in place** (``index_put_``, ``scatter``), which saves
a copy of the multi-GB bitmap per mutation.

State layout (one shard):
    mappings : int32[h, n]       random coordinate mappings (π_o)
    sketch   : [R, C]            the stacked sketch [U; L] (R = 2m), or U
                                 alone (R = m) without a lower sketch;
                                 ``state.u`` / ``state.l`` are views of it
    bits     : int32[rows, C/32] id-only inverted index, bit-packed
                                 (see repro_torch.core.bitindex)
    store    : VecStore[C, P]    raw vectors (exact rerank source)
    active   : bool[C]           slot occupancy
    ids      : int64[C]          external document ids, -1 = empty slot
                                 (the reference packs them into uint32 pairs
                                 because JAX runs with x64 off)
    dirty    : bool[C]           sketch column carries deleted-doc residue

Keeping [U; L] stacked makes the fused kernel's operand a view instead of a
285 MB concatenation per query batch at shard scale.

Retrieval = Algorithm 6 (budgeted upper-bound scoring) + Algorithm 7
(top-k' candidates → exact rerank → top-k).  Deletion = bit-clear + slot
recycling (§4.3): the sketch column is left dirty and the next insert
merges into it (max into u, min into l); :func:`compact_state` rebuilds
the dirty columns from the raw vectors.

:class:`SinnamonIndex` guards its state with a reader-writer lock
(:class:`StateLock`): searches share it and run side by side, an in-place
write holds it alone, so a search that runs beside a write answers from
the state before it or after it, never from half of it (the reference
gets this from immutable state).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bitindex, sketch
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import span as _span
from repro_torch.storage import vecstore

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one.  Raises when CUDA is asked for (or implied) and no
    CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Static engine configuration (see ``repro.core.engine.EngineSpec``).

    Accuracy levers: ``m`` (sketch half-size), ``sketch_kind``
    (``full`` | ``lite``, §3.3 upper-bound-only sketch) and ``dtype`` (sketch
    cell storage ``f32 | bf16 | f8``, directed-rounded).  ``value_dtype`` is
    the raw VecStore width the exact rerank reads.
    """

    n: int
    m: int
    capacity: int
    max_nnz: int
    h: int = 1
    positive_only: bool = False
    index_buckets: Optional[int] = None
    sketch_kind: str = "full"
    dtype: str = "bfloat16"
    value_dtype: str = "bfloat16"
    seed: int = 0

    def __post_init__(self):
        if self.capacity % 32 != 0:
            raise ValueError("capacity must be a multiple of 32")
        if self.sketch_kind not in ("full", "lite"):
            raise ValueError(f"sketch_kind must be 'full' or 'lite', "
                             f"got {self.sketch_kind!r}")
        object.__setattr__(self, "dtype",
                           sketch.resolve_cell_dtype(self.dtype))

    @property
    def upper_only(self) -> bool:
        """True when no lower sketch is stored (Sinnamon+ or lite)."""
        return self.positive_only or self.sketch_kind == "lite"

    @property
    def sketch_spec(self) -> sketch.SketchSpec:
        return sketch.SketchSpec(self.n, self.m, self.h, self.upper_only,
                                 self.dtype)

    @property
    def value_tdtype(self) -> torch.dtype:
        return sketch.torch_cell_dtype(self.value_dtype)

    @property
    def bit_rows(self) -> int:
        return self.index_buckets or self.n


def coord_rows(spec: EngineSpec, idx: Tensor) -> Tensor:
    """Map coordinate ids to bitmap rows (identity, or hashed buckets).

    The reference's uint32 hash ``idx * 2654435761 mod 2**32`` is computed
    in int64 with a 32-bit mask; padded ids (< 0) pass through.
    """
    if spec.index_buckets is None:
        return idx
    safe = torch.where(idx >= 0, idx, 0).long()
    h = (safe * 2654435761) & 0xFFFFFFFF
    return torch.where(idx >= 0, (h % spec.index_buckets).to(idx.dtype), idx)


@dataclasses.dataclass
class SinnamonState:
    """One shard's tensors (see the module docstring for the layout)."""

    mappings: Tensor
    sketch: Tensor
    bits: Tensor
    store: vecstore.VecStore
    active: Tensor
    ids: Tensor
    dirty: Tensor
    m: int

    @property
    def u(self) -> Tensor:
        return self.sketch[:self.m]

    @property
    def l(self) -> Optional[Tensor]:
        return None if self.sketch.shape[0] == self.m else self.sketch[self.m:]

    @property
    def device(self) -> torch.device:
        return self.sketch.device


# ---------------------------------------------------------------------------
# Functional core
# ---------------------------------------------------------------------------

def init(spec: EngineSpec, device,
         store_rows: Optional[int] = None) -> SinnamonState:
    """Fresh, empty state on ``device``.  ``store_rows=0`` gives a zero-row
    store placeholder: the tiered index keeps the raw rows in a
    :class:`repro_torch.storage.tiered.TieredVecStore`, and the writes of
    the functional core skip an empty store."""
    sp = spec.sketch_spec
    return SinnamonState(
        mappings=torch.from_numpy(sketch.make_mappings(
            spec.seed, spec.n, spec.m, spec.h)).to(device),
        sketch=torch.zeros((sp.sketch_rows, spec.capacity), dtype=sp.tdtype,
                           device=device),
        bits=bitindex.empty(spec.bit_rows, spec.capacity, device),
        store=vecstore.empty(spec.capacity if store_rows is None
                             else store_rows, spec.max_nnz,
                             dtype=spec.value_tdtype, device=device),
        active=torch.zeros((spec.capacity,), dtype=torch.bool, device=device),
        ids=torch.full((spec.capacity,), -1, dtype=torch.int64,
                       device=device),
        dirty=torch.zeros((spec.capacity,), dtype=torch.bool, device=device),
        m=spec.m,
    )


_ints = sketch.cell_bits


def _merge_cells(old: Tensor, new: Tensor, upper: bool) -> Tensor:
    """IEEE maximum (upper) / minimum (lower) of two cell tensors, as the
    reference's ``jnp.maximum`` / ``jnp.minimum`` (+0.0 above -0.0)."""
    a, b = sketch.sortable_bits(old), sketch.sortable_bits(new)
    take_old = a > b if upper else a < b
    return torch.where(take_old, _ints(old), _ints(new)).view(old.dtype)


def _dedup_first(rows: Tensor) -> Tensor:
    """bool[B, P]: True at the first occurrence of each row within a doc
    (a stable sort groups equal rows in position order)."""
    srt, order = torch.sort(rows, dim=-1, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return torch.zeros_like(first).scatter_(-1, order, first)


def _bit_scatter_operands(spec: EngineSpec, slots: Tensor, idx: Tensor,
                          mask: Optional[Tensor]):
    """(rows, words, bitmasks) [B, P] of one batched membership-bit
    scatter-add.

    Padded coordinates, duplicate in-document rows and masked-off documents
    get a zero mask (adding 0 changes nothing), so every (row, word, bit) is
    added at most once and no host sync is needed to drop them.
    """
    rows = coord_rows(spec, idx)                             # [B, P]
    keep = (idx >= 0) & _dedup_first(rows)
    if mask is not None:
        keep &= mask[:, None]
    words = (slots // bitindex.WORD)[:, None].expand_as(rows)
    bitm = torch.where(keep, bitindex.word_mask(slots)[:, None], 0)
    return rows.clamp_min(0).long(), words.long(), bitm


def _select(mask: Optional[Tensor], slots: Tensor, *rows: Tensor):
    """The entries of a batch that ``mask`` keeps (all of them for None,
    which needs no host sync)."""
    if mask is None:
        return (slots.long(),) + rows
    sel = mask.nonzero().squeeze(1)
    return (slots[sel].long(),) + tuple(r[sel] for r in rows)


def insert_batch_masked(state: SinnamonState, spec: EngineSpec, slots: Tensor,
                        ext_ids: Tensor, idx: Tensor, val: Tensor,
                        mask: Optional[Tensor] = None,
                        trace=None) -> SinnamonState:
    """Vectorized batch insert (Algorithm 5); ``mask=False`` entries are
    no-ops (``mask=None`` keeps every entry).  Updates ``state`` in place
    and returns it.  A device-timed ``trace`` gets the spans ``encode``,
    ``bitmap`` (the membership scatter), ``sketch`` (the cells' merge)
    and ``csr`` (raw rows, ``active``, ``ids``).

    ``slots`` must be unique and free (the host allocator guarantees it).  A
    clean slot gets the document's exact sketch column; a dirty (recycled)
    slot is merged into — max for u, min for l — so the column still bounds
    every value it ever saw.  Membership bits are a scatter-add of word
    masks: distinct slots touch distinct bits, so the add is a bitwise OR.
    """
    with _span(trace, "encode"):
        u_cols, l_cols = sketch.encode_batch(state.mappings, spec.m, idx, val,
                                             dtype=spec.dtype,
                                             positive_only=spec.upper_only)
    with _span(trace, "bitmap"):
        rows, words, bitm = _bit_scatter_operands(spec, slots, idx, mask)
        state.bits.index_put_((rows, words), bitm, accumulate=True)

    with _span(trace, "sketch"):
        s, ext_ids, idx, val, u_cols = _select(mask, slots, ext_ids, idx,
                                               val, _ints(u_cols))
        l_cols = None if l_cols is None else _select(mask, slots,
                                                     _ints(l_cols))[1]
        was_dirty = state.dirty[s][None, :]
        for cols, side, upper in ((u_cols, state.u, True),
                                  (l_cols, state.l, False)):
            if side is None:
                continue
            new = cols.T.contiguous().view(side.dtype)         # [m, b]
            old = _ints(side)[:, s].view(side.dtype)
            merged = _merge_cells(old, new, upper)
            _ints(side)[:, s] = torch.where(was_dirty, _ints(merged),
                                            _ints(new))

    with _span(trace, "csr"):
        if state.store.capacity:        # a tiered placeholder holds no rows
            vecstore.write(state.store, s, idx, val)
        state.active[s] = True
        state.ids[s] = ext_ids.to(torch.int64)
    return state


def delete_batch_rows(state: SinnamonState, spec: EngineSpec, slots: Tensor,
                      idx: Tensor, mask: Optional[Tensor] = None
                      ) -> SinnamonState:
    """Masked batch delete (§4.3) with the deleted rows' coordinates ``idx``
    [B, P] passed in; updates ``state`` in place and returns it.

    Bit-clearing subtracts the word masks the insert added: each targeted
    bit is set, so nothing borrows (bit 31 wraps through the sign bit, the
    same pattern as the reference's uint32 arithmetic).  The sketch column
    is left dirty for the next insert to merge into.
    """
    rows, words, bitm = _bit_scatter_operands(spec, slots, idx, mask)
    state.bits.index_put_((rows, words), -bitm, accumulate=True)
    s, = _select(mask, slots)
    if state.store.capacity:
        vecstore.erase(state.store, s)
    state.active[s] = False
    state.ids[s] = -1
    state.dirty[s] = True
    return state


def delete_batch_masked(state: SinnamonState, spec: EngineSpec, slots: Tensor,
                        mask: Optional[Tensor] = None) -> SinnamonState:
    """:func:`delete_batch_rows` reading the rows from the resident store."""
    return delete_batch_rows(state, spec, slots,
                             state.store.indices[slots.long()], mask)


def insert(state: SinnamonState, spec: EngineSpec, slot: int, ext_id: int,
           idx: Tensor, val: Tensor) -> SinnamonState:
    """Algorithm 5 for one document at ``slot`` (the one-row batch form)."""
    dev = state.device
    return insert_batch_masked(
        state, spec, torch.tensor([slot], dtype=torch.int32, device=dev),
        torch.tensor([ext_id], dtype=torch.int64, device=dev), idx[None],
        val[None])


def delete(state: SinnamonState, spec: EngineSpec, slot: int
           ) -> SinnamonState:
    """§4.3 delete of the document at ``slot`` (the one-row batch form)."""
    dev = state.device
    return delete_batch_masked(
        state, spec, torch.tensor([slot], dtype=torch.int32, device=dev))


def grow_state(state: SinnamonState, spec: EngineSpec,
               new_spec: EngineSpec) -> SinnamonState:
    """A new state at ``new_spec.capacity`` with every per-slot axis copied
    over (slot numbering preserved)."""
    c = spec.capacity
    placeholder = state.store.capacity == 0         # tiered: stays empty
    st = init(new_spec, state.device, store_rows=0 if placeholder else None)
    st.mappings = state.mappings
    _ints(st.sketch)[:, :c] = _ints(state.sketch)
    st.bits[:, :c // bitindex.WORD] = state.bits
    if not placeholder:
        st.store.indices[:c] = state.store.indices
        st.store.values[:c] = state.store.values
    st.active[:c] = state.active
    st.ids[:c] = state.ids
    st.dirty[:c] = state.dirty
    return st


# ---------------------------------------------------------------------------
# Sketch compaction (§4.3 churn residue)
# ---------------------------------------------------------------------------

def fresh_sketch(state: SinnamonState, spec: EngineSpec):
    """Exact sketch re-encoded from the raw vectors in the store:
    (u [m, C], l [m, C] or None).  Erased slots encode to zero columns; no
    recycled-slot residue (the Theorem 5.1-tight reference)."""
    u, l = sketch.encode_batch(state.mappings, spec.m, state.store.indices,
                               state.store.values.to(torch.float32),
                               dtype=spec.dtype,
                               positive_only=spec.upper_only)
    return u.T, None if l is None else l.T


def fresh_cells(state: SinnamonState, spec: EngineSpec) -> Tensor:
    """The stacked fresh sketch of :func:`fresh_sketch` as the integer bit
    patterns of its cells, a new [R, C] tensor (``state`` is only read)."""
    u_f, l_f = fresh_sketch(state, spec)
    return _ints(u_f) if l_f is None else torch.cat([_ints(u_f),
                                                     _ints(l_f)])


def apply_compaction(state: SinnamonState, fresh: Tensor) -> SinnamonState:
    """Write :func:`fresh_cells` into every dirty column, in place, and
    clear ``dirty``; returns ``state``."""
    cells = _ints(state.sketch)
    cells.copy_(torch.where(state.dirty[None, :], fresh, cells))
    state.dirty.zero_()
    return state


def compact_state(state: SinnamonState, spec: EngineSpec) -> SinnamonState:
    """Rebuild every dirty sketch column from the store, in place, and
    clear ``dirty``; returns ``state``.

    Dirty+active columns become the document's fresh sketch, dirty+inactive
    (deleted, not recycled) columns zero; clean columns keep their bits.
    """
    return apply_compaction(state, fresh_cells(state, spec))


def slot_drift(state: SinnamonState, spec: EngineSpec) -> Tensor:
    """Per-slot sketch overestimate against a fresh sketch, f32[C]: the max
    over cells of how far the stored upper bound sits above the tight one
    (and the stored lower bound below it).  0 for inactive slots, and for
    clean slots when the store keeps f32 values."""
    u_f, l_f = fresh_sketch(state, spec)
    f32 = torch.float32
    over = (state.u.to(f32) - u_f.to(f32)).clamp_min(0.0).amax(dim=0)
    if state.l is not None:
        over = torch.maximum(
            over, (l_f.to(f32) - state.l.to(f32)).clamp_min(0.0).amax(dim=0))
    return torch.where(state.active, over, 0.0)


def fresh_cells_rows(state: SinnamonState, spec: EngineSpec, idx_rows: Tensor,
                     val_rows: Tensor) -> Tensor:
    """The stacked fresh sketch columns of raw rows ``idx_rows`` /
    ``val_rows`` [B, P] (on the state's device), as the integer bit patterns
    of their cells, [R, B]: column b is :func:`fresh_cells`' column of a
    slot holding row b (an erased row encodes to a zero column)."""
    u, l = sketch.encode_batch(state.mappings, spec.m, idx_rows,
                               val_rows.to(torch.float32), dtype=spec.dtype,
                               positive_only=spec.upper_only)
    u = _ints(u.T)
    return u if l is None else torch.cat([u, _ints(l.T)])


def apply_compaction_rows(state: SinnamonState, slots: Tensor,
                          cells: Tensor) -> SinnamonState:
    """Write :func:`fresh_cells_rows` columns ``cells`` [R, B] into
    ``slots`` [B] and clear their dirty flags, in place; returns ``state``."""
    s = slots.long()
    _ints(state.sketch)[:, s] = cells
    state.dirty[s] = False
    return state


def compact_slots_rows(state: SinnamonState, spec: EngineSpec, slots: Tensor,
                       idx_rows: Tensor, val_rows: Tensor,
                       mask: Optional[Tensor] = None) -> SinnamonState:
    """Rebuild the sketch columns of ``slots`` from their raw rows, in place
    (the reference's ``compact_slots_rows``): the rows-based twin of
    :func:`compact_state` for a store whose rows live off the device.
    ``mask=False`` entries are no-ops.  Rebuilding the dirty set this way
    gives :func:`compact_state`'s cells bit for bit."""
    if mask is not None:
        sel = mask.nonzero().squeeze(1)
        slots, idx_rows, val_rows = slots[sel], idx_rows[sel], val_rows[sel]
    return apply_compaction_rows(
        state, slots, fresh_cells_rows(state, spec, idx_rows, val_rows))


def slot_drift_rows(state: SinnamonState, spec: EngineSpec, slots: Tensor,
                    idx_rows: Tensor, val_rows: Tensor) -> Tensor:
    """:func:`slot_drift` of ``slots`` [B] from their raw rows, f32[B]."""
    u_f, l_f = sketch.encode_batch(state.mappings, spec.m, idx_rows,
                                   val_rows.to(torch.float32),
                                   dtype=spec.dtype,
                                   positive_only=spec.upper_only)
    s = slots.long()
    f32 = torch.float32
    over = (state.u[:, s].to(f32) - u_f.T.to(f32)).clamp_min(0.0).amax(dim=0)
    if state.l is not None:
        over = torch.maximum(over, (l_f.T.to(f32) - state.l[:, s].to(f32))
                             .clamp_min(0.0).amax(dim=0))
    return torch.where(state.active[s], over, 0.0)


# ---------------------------------------------------------------------------
# Algorithm 6 scoring (reference and grouped backends)
# ---------------------------------------------------------------------------

def _sorted_query(q_idx: Tensor, q_val: Tensor):
    """Order query coordinates by |q[j]| descending, padding last; the sort
    is stable, so budget truncation keeps the reference's coordinates."""
    key = torch.where(q_idx >= 0, q_val.to(torch.float32).abs(), -1.0)
    order = torch.argsort(-key, dim=-1, stable=True)
    return q_idx.gather(-1, order), q_val.gather(-1, order)


def score_batch(state: SinnamonState, spec: EngineSpec, q_idx: Tensor,
                q_val: Tensor, budget: Optional[int] = None,
                grouped: bool = False) -> Tensor:
    """[B, C] Algorithm 6 upper-bound scores of a query batch [B, Lq].

    ``grouped=False`` is the paper's coordinate-at-a-time loop (the
    ``reference`` backend); ``grouped=True`` decodes all budgeted
    coordinates as one [B, L, C] block and sums it in one reduction.
    """
    q_idx, q_val = _sorted_query(q_idx, q_val)
    steps = q_idx.shape[-1] if budget is None else min(budget,
                                                       q_idx.shape[-1])
    j = q_idx[:, :steps]
    v = q_val[:, :steps].to(torch.float32)
    safe = torch.where(j >= 0, j, 0).long()
    rows = state.mappings[:, safe].long()                     # [h, B, L]
    bit_rows = coord_rows(spec, j).clamp_min(0).long()
    uf = lambda r: sketch.cell_rows(state.u, r)               # noqa: E731
    lf = lambda r: sketch.cell_rows(state.l, r)               # noqa: E731
    if grouped:
        ub = uf(rows).amin(dim=0)                             # [B, L, C]
        lb = torch.zeros_like(ub) if state.l is None else lf(rows).amax(0)
        vv = v[..., None]
        contrib = torch.where(vv > 0, vv * ub, vv * lb)
        memb = bitindex.unpack_row(state.bits[bit_rows])      # [B, L, C]
        contrib = torch.where(memb & (j >= 0)[..., None], contrib, 0.0)
        return contrib.sum(dim=1)
    B = q_idx.shape[0]
    scores = torch.zeros((B, state.sketch.shape[1]), dtype=torch.float32,
                         device=state.device)
    for t in range(steps):
        r = rows[:, :, t]                                     # [h, B]
        ub = uf(r).amin(dim=0)                                # [B, C]
        lb = torch.zeros_like(ub) if state.l is None else lf(r).amax(0)
        vt = v[:, t, None]
        contrib = torch.where(vt > 0, vt * ub, vt * lb)
        memb = bitindex.unpack_row(state.bits[bit_rows[:, t]])
        scores = scores + torch.where(memb & (j[:, t] >= 0)[:, None],
                                      contrib, 0.0)
    return scores


def score(state, spec, q_idx, q_val, budget=None) -> Tensor:
    """Algorithm 6 upper-bound scores of one query, f32[C]."""
    return score_batch(state, spec, q_idx[None], q_val[None], budget)[0]


def score_grouped(state, spec, q_idx, q_val, budget=None) -> Tensor:
    """Grouped-schedule scores of one query, f32[C]."""
    return score_batch(state, spec, q_idx[None], q_val[None], budget,
                       grouped=True)[0]


# ---------------------------------------------------------------------------
# Search: candidates (Algorithm 6) → exact rerank (Algorithm 7)
# ---------------------------------------------------------------------------

def topk_candidates(state: SinnamonState, spec: EngineSpec, q_idx: Tensor,
                    q_val: Tensor, kprime: int, budget: Optional[int] = None,
                    filter_mask: Optional[Tensor] = None, score_fn=None,
                    backend: Optional[str] = None,
                    use_kernel: Optional[bool] = None, trace=None):
    """Batched candidate generation -> (upper_bounds f32[B, kprime],
    slots int32[B, kprime]) in (upper bound desc, slot asc) order, the same
    order for every backend (``reference | grouped | fused``, or the alias
    ``pallas``; None -> see ``ops.resolve_backend``).  ``use_kernel`` is
    passed to the fused path's kernel.  A device-timed ``trace`` gets the
    spans ``sketch_scan`` (the scores, or kernel A's passes) and
    ``topk_merge`` (the selection of the k'); the fused path adds
    ``fallback_scan`` when it must redo a batch in one pass
    (``ops.checked``).

    ``score_fn`` overrides the backend with a dense scorer.  It is
    batch-native, ``score_fn(state, spec, q_idx, q_val, budget) ->
    f32[B, C]`` (``ops.make_engine_score_fn`` runs kernel C); its scores
    are gated and cut with ``topk_desc``, the ``lax.top_k`` order.
    """
    from repro_torch.kernels import ops as _ops
    return _ops.checked(issue_candidates(
        state, spec, q_idx, q_val, kprime, budget, filter_mask,
        score_fn=score_fn, backend=backend, use_kernel=use_kernel,
        trace=trace), trace)


def issue_candidates(state: SinnamonState, spec: EngineSpec, q_idx: Tensor,
                     q_val: Tensor, kprime: int,
                     budget: Optional[int] = None,
                     filter_mask: Optional[Tensor] = None, score_fn=None,
                     backend: Optional[str] = None,
                     use_kernel: Optional[bool] = None, trace=None):
    """:func:`topk_candidates`, issued and not yet checked: an
    ``ops.Candidates``, whose flag only the fused path's two passes set.
    A caller that issues more work on the candidates reads the flag after
    it (``ops.flagged``), so the card does not wait on the host."""
    from repro_torch.kernels import ops as _ops
    from repro_torch.kernels.sinnamon_score import topk_desc

    ok = state.active if filter_mask is None else (state.active & filter_mask)
    backend = _ops.resolve_backend(backend)
    if score_fn is None and backend == "fused":
        return _ops.fused_candidates(state, spec, q_idx, q_val, kprime,
                                     budget=budget, ok=ok,
                                     use_kernel=use_kernel, trace=trace)
    with _span(trace, "sketch_scan"):
        if score_fn is not None:
            s = score_fn(state, spec, q_idx, q_val, budget)
        else:
            s = score_batch(state, spec, q_idx, q_val, budget,
                            grouped=backend == "grouped")
        s = torch.where(ok[None, :], s, -torch.inf)
    with _span(trace, "topk_merge"):
        return _ops.Candidates(*topk_desc(s, kprime))


def rerank_topk(state: SinnamonState, cand_scores: Tensor, cand_slots: Tensor,
                q_idx: Tensor, q_val: Tensor, k: int,
                use_kernel: Optional[bool] = None):
    """Algorithm 7 back half: exact rerank of [B, k'] candidates.

    The candidate CSR rows are scored against the sparse queries (duplicate
    coordinates combined; no dense query), slots whose upper bound was
    gated to -inf stay -inf, and the top-k is taken in (score desc,
    candidate position asc) order.  On CUDA tensors that is one launch of
    the ``csr_rerank_topk`` kernel; on CPU tensors its plain twin, the
    reference's steps.  Returns (ids int64[B, k], scores f32[B, k],
    slots int32[B, k]).
    """
    from repro_torch.kernels import csr_rerank as _rr

    return _rr.csr_rerank_topk(
        q_idx.to(torch.int32).contiguous(),
        q_val.to(torch.float32).contiguous(), state.store.indices,
        state.store.values, state.ids, cand_scores.contiguous(),
        cand_slots.contiguous(), k, use_kernel=use_kernel)


def rerank_topk_rows(state: SinnamonState, cand_scores: Tensor,
                     cand_slots: Tensor, rows_idx: Tensor, rows_val: Tensor,
                     q_idx: Tensor, q_val: Tensor, k: int,
                     use_kernel: Optional[bool] = None):
    """:func:`rerank_topk` with the candidates' CSR rows passed in
    (``rows_idx`` / ``rows_val`` [B·K', P] or [B, K', P], candidate-major:
    the tiered path's ``TieredVecStore.gather_rows``).

    The same wrapper, unchanged: the gathered rows are its store, each
    candidate's position b·K' + j its slot and ``state.ids`` of its real
    slot its id; the positions it returns map back through ``cand_slots``.
    A row's score does not depend on where the row lies, so the answer is
    :func:`rerank_topk`'s bit for bit.  Returns (ids int64[B, k],
    scores f32[B, k], slots int32[B, k]).
    """
    from repro_torch.kernels import csr_rerank as _rr

    B, Kp = cand_slots.shape
    flat = cand_slots.reshape(-1)
    P = rows_idx.shape[-1]
    pos = torch.arange(B * Kp, dtype=torch.int32,
                       device=cand_slots.device).view(B, Kp)
    ids, scores, at = _rr.csr_rerank_topk(
        q_idx.to(torch.int32).contiguous(),
        q_val.to(torch.float32).contiguous(),
        rows_idx.reshape(B * Kp, P).contiguous(),
        rows_val.reshape(B * Kp, P).contiguous(),
        state.ids[flat.long()], cand_scores.contiguous(), pos, k,
        use_kernel=use_kernel)
    return ids, scores, flat[at.long()]


def search_batch(state, spec, q_idx, q_val, k, kprime, budget=None,
                 filter_mask=None, score_fn=None,
                 backend: Optional[str] = None,
                 use_kernel: Optional[bool] = None, trace=None):
    """Batched search [B, Lq] -> (ids int64[B, k], scores f32[B, k],
    slots int32[B, k]); ``score_fn`` as in :func:`topk_candidates`.  A
    device-timed ``trace`` gets :func:`topk_candidates`'s spans and
    ``rerank``.  The candidates' flag is read once the rerank is issued; a
    flagged batch redoes both in the span ``fallback_scan``."""
    from repro_torch.kernels import ops as _ops

    cands = issue_candidates(
        state, spec, q_idx, q_val, kprime, budget, filter_mask,
        score_fn=score_fn, backend=backend, use_kernel=use_kernel,
        trace=trace)
    with _span(trace, "rerank"):
        out = rerank_topk(state, cands.vals, cands.slots, q_idx, q_val, k,
                          use_kernel=use_kernel)
    if _ops.flagged([cands])[0]:
        with _span(trace, "fallback_scan"):
            out = rerank_topk(state, *cands.redo(), q_idx, q_val, k,
                              use_kernel=use_kernel)
    return out


def search_batch_sketch(state, spec, q_idx, q_val, k, budget=None,
                        backend: Optional[str] = None,
                        use_kernel: Optional[bool] = None):
    """Sketch-only batched search (no rerank): the top-k upper bounds
    themselves — the serving brownout answer.  Returns (ids, upper_bounds,
    slots)."""
    ub, slots = topk_candidates(state, spec, q_idx, q_val, k, budget, None,
                                backend=backend, use_kernel=use_kernel)
    return state.ids[slots.long()], ub, slots


# ---------------------------------------------------------------------------
# Host wrapper: slot allocation, id mapping, growth
# ---------------------------------------------------------------------------

class _WritePathMetrics:
    """Write-path metric handles, lazily bound and revalidated against the
    current process-global registry (so `obs.metrics.set_registry` in tests
    takes effect on indexes created earlier).  The names and labels are
    the reference's."""

    __slots__ = ("_registry", "_ops", "_docs", "_batch")
    _OPS = ("insert", "insert_many", "delete", "delete_many", "grow", "compact")

    def __init__(self):
        self._registry = None

    def _bind(self):
        reg = obs_metrics.get_registry()
        if reg is not self._registry:
            self._ops = {
                op: (reg.counter("repro_engine_ops_total",
                                 "Engine mutations applied.", labels={"op": op}),
                     reg.histogram(
                         "repro_engine_update_ms",
                         "Host wall time of one mutation, scatter dispatch "
                         "included (async device work not synced).",
                         labels={"op": op}))
                for op in self._OPS}
            self._docs = {
                d: reg.counter("repro_engine_docs_total",
                               "Documents written/removed.", labels={"op": d})
                for d in ("insert", "delete")}
            self._batch = reg.histogram(
                "repro_engine_update_batch_docs",
                "Documents per mutation call.",
                buckets=obs_metrics.DEFAULT_COUNT_BUCKETS)
            self._registry = reg

    def record(self, op: str, t0_s: float, ndocs: int = 0) -> None:
        self._bind()
        count, hist = self._ops[op]
        count.inc()
        hist.observe((time.perf_counter() - t0_s) * 1e3)
        if ndocs:
            self._batch.observe(ndocs)
            self._docs["delete" if op.startswith("delete") else "insert"].inc(ndocs)


def _write_trace(op: str, device) -> Optional[obs_trace.Trace]:
    """A device-timed trace of one write call, or None while the
    process-global registry is the metrics-off ``NULL_REGISTRY``."""
    if isinstance(obs_metrics.get_registry(), obs_metrics.NullRegistry):
        return None
    return obs_trace.Trace(op, device, device_timed=True)


def pad_sparse(idx, val, width: int):
    """Pad/truncate one sparse (idx, val) pair (numpy-like, or tensors on
    any device) to ``width`` on the host: (int32[width] with -1 padding,
    f32[width]) numpy arrays."""
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    if isinstance(val, torch.Tensor):
        val = val.cpu().numpy()
    idx = np.asarray(idx, np.int32)[:width]
    val = np.asarray(val, np.float32)[:width]
    out_i = np.full((width,), -1, np.int32)
    out_v = np.zeros((width,), np.float32)
    out_i[:idx.size] = idx
    out_v[:val.size] = val
    return out_i, out_v


class StateLock:
    """Reader-writer lock over an index's in-place state.

    ``read()`` is shared: searches run side by side.  ``write()`` is
    exclusive and re-entrant for its thread, which may also take
    ``read()`` inside it.  A reading thread may nest reads, but may not
    take ``write()`` (that would wait for itself, so it raises).  A writer
    that waits holds off new readers, so a steady stream of searches
    cannot starve the writes.
    """

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0            # read holds, over all threads
        self._writer: Optional[int] = None
        self._depth = 0              # the writer's nested write holds
        self._waiting = 0            # writers waiting
        self._local = threading.local()

    @contextmanager
    def read(self):
        me = threading.get_ident()
        with self._cond:
            own = self._writer == me
            if not own:
                held = getattr(self._local, "reads", 0)
                if not held:
                    while self._writer is not None or self._waiting:
                        self._cond.wait()
                self._readers += 1
                self._local.reads = held + 1
        try:
            yield
        finally:
            if not own:
                with self._cond:
                    self._readers -= 1
                    self._local.reads -= 1
                    if not self._readers:
                        self._cond.notify_all()

    @contextmanager
    def write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._depth += 1
            else:
                if getattr(self._local, "reads", 0):
                    raise RuntimeError("a thread holding the state lock to "
                                       "read cannot take it to write")
                self._waiting += 1
                try:
                    while self._writer is not None or self._readers:
                        self._cond.wait()
                finally:
                    self._waiting -= 1
                self._writer, self._depth = me, 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._writer = None
                    self._cond.notify_all()


class SinnamonIndex:
    """Streaming index on one device (paper §4's full system).

    Owns the host-side bookkeeping — slot free list, external-id ↔ slot
    map, capacity growth — while the heavy operations are the functions
    above on ``self.state``.  ``device`` None means the CUDA card (raises
    without one); the tests pass ``device="cpu"``.  Mutations hold
    ``_state_lock`` to write and searches to read (:class:`StateLock`);
    every mutation
    reports to the write-path metrics of ``repro_torch.obs``, and records
    an insert records a device-timed ``insert_many`` trace
    (``repro_torch.obs.trace``) with the spans ``prep``, ``id_map``,
    ``encode``, ``bitmap``, ``sketch``, ``csr``, ``id_map``; a search given
    one fills a ``query`` trace with ``admission``, ``sketch_scan``,
    ``topk_merge``, ``rerank``, ``to_host``.
    """

    def __init__(self, spec: EngineSpec, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.default_backend: Optional[str] = None   # api.open_index sets it
        self.state = init(spec, self.device)
        self._free = list(range(spec.capacity - 1, -1, -1))  # pop() -> slot 0
        self._id2slot: dict[int, int] = {}
        self._state_lock = StateLock()
        self._obs = _WritePathMetrics()

    @classmethod
    def from_numpy(cls, spec: EngineSpec, leaves: dict, free, id2slot,
                   device=None) -> "SinnamonIndex":
        """An index holding the reference index's state (see
        :mod:`repro_torch.convert`)."""
        from repro_torch import convert
        index = cls.__new__(cls)
        index.spec = spec
        index.device = resolve_device(device)
        index.default_backend = None
        index.state = convert.state_from_numpy(leaves, spec, index.device)
        index._free = [int(s) for s in free]
        index._id2slot = {int(e): int(s) for e, s in dict(id2slot).items()}
        index._state_lock = StateLock()
        index._obs = _WritePathMetrics()
        return index

    def _tensor(self, x, dtype) -> Tensor:
        """``x`` (numpy-like or a tensor on any device) on this index's
        device as ``dtype``."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _rows(self, x, dtype, fill) -> Tensor:
        """Update rows [B, L] padded to the CSR width [B, max_nnz]."""
        t = self._tensor(x, dtype)
        width = self.spec.max_nnz
        if t.shape[1] > width:
            raise ValueError(f"document nnz {t.shape[1]} > max_nnz {width}")
        return torch.nn.functional.pad(t, (0, width - t.shape[1]), value=fill)

    # -- streaming updates ---------------------------------------------------
    def insert(self, ext_id: int, idx, val) -> None:
        """Insert one document (coordinates past ``max_nnz`` are dropped);
        an id already present is overwritten."""
        t0 = time.perf_counter()
        i, v = pad_sparse(idx, val, self.spec.max_nnz)
        self._insert_rows([int(ext_id)], i[None], v[None])
        self._obs.record("insert", t0, 1)

    def insert_many(self, ext_ids, idx_batch, val_batch) -> None:
        """Insert documents ``idx_batch``/``val_batch`` [B, L] (numpy or
        tensors) under ``ext_ids``; an id already present is overwritten."""
        t0 = time.perf_counter()
        bn = self._insert_rows(ext_ids, idx_batch, val_batch)
        self._obs.record("insert_many", t0, bn)

    def _insert_rows(self, ext_ids, idx_batch, val_batch) -> int:
        """The insert of :meth:`insert_many`; returns the number of
        documents written (a repeated id counts once)."""
        trace = _write_trace("insert_many", self.device)
        with _span(trace, "prep"):
            ext_ids = ext_ids.tolist() if isinstance(ext_ids, torch.Tensor) \
                else [int(e) for e in ext_ids]
            idx_t = self._rows(idx_batch, torch.int32, -1)
            val_t = self._rows(val_batch, torch.float32, 0)
            if len(set(ext_ids)) != len(ext_ids):
                # Sequential overwrite semantics: only the LAST occurrence
                # of a duplicated id survives.
                last = {e: pos for pos, e in enumerate(ext_ids)}
                keep = sorted(last.values())
                ext_ids = [ext_ids[p] for p in keep]
                sel = torch.tensor(keep, device=self.device)
                idx_t, val_t = idx_t[sel], val_t[sel]
        bn = len(ext_ids)
        with self._state_lock.write():
            with _span(trace, "id_map"):
                for e in ext_ids:
                    if e in self._id2slot:  # overwrite: drop the stale copy
                        self.delete(e)
                while len(self._free) < bn:
                    self.grow(self.spec.capacity * 2)
                slots = np.array([self._free.pop() for _ in range(bn)],
                                 np.int32)
            self._write_insert(slots, ext_ids, idx_t, val_t, trace)
            with _span(trace, "id_map"):
                for eid, slot in zip(ext_ids, slots):
                    self._id2slot[eid] = int(slot)
        if trace is not None:
            trace.finish()
        return bn

    def _write_insert(self, slots: np.ndarray, ext_ids, idx_t: Tensor,
                      val_t: Tensor, trace=None) -> None:
        """Write documents into free ``slots`` (the state lock held)."""
        insert_batch_masked(
            self.state, self.spec, self._tensor(slots, torch.int32),
            self._tensor(np.asarray(ext_ids, np.int64), torch.int64),
            idx_t, val_t, trace=trace)

    def _write_delete(self, slots) -> None:
        """Clear the documents at ``slots`` (the state lock held)."""
        delete_batch_masked(self.state, self.spec,
                            self._tensor(np.asarray(slots, np.int32),
                                         torch.int32))

    def delete(self, ext_id: int) -> None:
        t0 = time.perf_counter()
        self._delete_ids([ext_id])
        self._obs.record("delete", t0, 1)

    def delete_many(self, ext_ids) -> None:
        """Delete ``ext_ids`` in one :func:`delete_batch_masked` call; the
        state and the free list end as after ``delete`` of each id in order.
        A repeated id is one deletion; an unknown id raises ``KeyError``
        before anything changes."""
        t0 = time.perf_counter()
        n = self._delete_ids(ext_ids)
        self._obs.record("delete_many", t0, n)

    def _delete_ids(self, ext_ids) -> int:
        """The delete of :meth:`delete_many`; returns the number of
        documents removed."""
        ext_ids = list(dict.fromkeys(int(e) for e in ext_ids))
        with self._state_lock.write():
            missing = [e for e in ext_ids if e not in self._id2slot]
            if missing:
                raise KeyError(f"unknown document ids: {missing[:5]}")
            if not ext_ids:
                return 0
            slots = [self._id2slot.pop(e) for e in ext_ids]
            self._write_delete(slots)
            self._free.extend(slots)
        return len(ext_ids)

    # -- retrieval -----------------------------------------------------------
    def _backend(self, backend) -> str:
        """Per-call choice > the index default (set by ``open_index``) >
        ``fused``."""
        from repro_torch.kernels import ops as _ops
        return _ops.resolve_backend(self.default_backend if backend is None
                                    else backend)

    def _sizes(self, k: int, kprime: Optional[int]):
        kprime = kprime if kprime is not None else max(5 * k, k)
        kprime = min(kprime, self.spec.capacity)
        return min(k, kprime), kprime

    def _filter(self, filter_mask) -> Optional[Tensor]:
        return None if filter_mask is None \
            else self._tensor(filter_mask, torch.bool)

    def search(self, q_idx, q_val, k: int, kprime: Optional[int] = None,
               budget: Optional[int] = None, filter_mask=None, score_fn=None,
               backend: Optional[str] = None, trace=None):
        ids, scores = self.search_many(np.asarray(q_idx)[None],
                                       np.asarray(q_val)[None], k, kprime,
                                       budget, filter_mask, score_fn, backend,
                                       trace=trace)
        return ids[0], scores[0]

    def search_many(self, q_idx, q_val, k: int, kprime: Optional[int] = None,
                    budget: Optional[int] = None, filter_mask=None,
                    score_fn=None, backend: Optional[str] = None,
                    trace=None):
        """Batched search: q_idx/q_val [B, Lq] -> (ids int64[B, k],
        scores f32[B, k]) as numpy arrays.  ``score_fn`` (batch-native, see
        :func:`topk_candidates`) overrides the backend.  A device-timed
        ``trace`` (the caller finishes it) gets the spans ``admission``,
        ``sketch_scan``, ``topk_merge``, ``rerank`` and ``to_host`` (the
        blocking copy of the answers)."""
        k, kprime = self._sizes(k, kprime)
        with self._state_lock.read():
            with _span(trace, "admission"):
                qi = self._tensor(q_idx, torch.int32)
                qv = self._tensor(q_val, torch.float32)
            ids, scores, _ = search_batch(
                self.state, self.spec, qi, qv, k, kprime, budget,
                self._filter(filter_mask), score_fn=score_fn,
                backend=self._backend(backend), trace=trace)
            with _span(trace, "to_host"):
                return ids.cpu().numpy(), scores.cpu().numpy()

    def search_many_sketch(self, q_idx, q_val, k: int,
                           budget: Optional[int] = None,
                           backend: Optional[str] = None):
        """Sketch-only batched search (no rerank): scores are sketch upper
        bounds, not inner products."""
        k = min(k, self.spec.capacity)
        with self._state_lock.read():
            ids, ub, _ = search_batch_sketch(
                self.state, self.spec, self._tensor(q_idx, torch.int32),
                self._tensor(q_val, torch.float32), k, budget,
                backend=self._backend(backend))
            return ids.cpu().numpy(), ub.cpu().numpy()

    # -- capacity --------------------------------------------------------------
    def grow(self, new_capacity: int) -> None:
        """Reallocate to a larger capacity, preserving slot numbering."""
        t0 = time.perf_counter()
        self._grow(new_capacity)
        self._obs.record("grow", t0)

    def _grow(self, new_capacity: int) -> None:
        """:meth:`grow` without its metric (a sharded index grows its
        shards through it and records one grow)."""
        with self._state_lock.write():
            spec = self.spec
            if new_capacity <= spec.capacity or new_capacity % 32 != 0:
                raise ValueError("new capacity must be a larger multiple "
                                 "of 32")
            new_spec = dataclasses.replace(spec, capacity=new_capacity)
            self.state = grow_state(self.state, spec, new_spec)
            self.spec = new_spec
            self._free = (list(range(new_capacity - 1, spec.capacity - 1, -1))
                          + self._free)

    # -- maintenance -----------------------------------------------------------
    def compact(self) -> int:
        """Rebuild all dirty sketch columns from the store (restores the
        Theorem 5.1 tightness lost to §4.3 churn); returns the number of
        columns rebuilt.

        The re-encode only reads the state, so it runs outside the state
        lock and searches go on beside it; the columns are written under
        the lock.  Like every mutation, it assumes one writer at a time.
        """
        t0 = time.perf_counter()
        n_dirty = int(self.state.dirty.sum())
        if n_dirty:
            fresh = self._fresh_compaction(self.state)
            with self._state_lock.write():
                self._apply_compaction(fresh)
        self._obs.record("compact", t0)
        return n_dirty

    def _fresh_compaction(self, state: SinnamonState):
        """The re-encoded cells a compaction of ``state`` writes in (only
        reads ``state``; no lock needed)."""
        return fresh_cells(state, self.spec)

    def _apply_compaction(self, fresh) -> None:
        """Write :meth:`_fresh_compaction`'s cells in (the state lock
        held to write)."""
        apply_compaction(self.state, fresh)

    def slot_drift(self) -> np.ndarray:
        """Per-slot sketch overestimate against a fresh sketch (f32[C])."""
        return slot_drift(self.state, self.spec).cpu().numpy()

    # -- persistence hooks (repro_torch.persist.snapshot) --------------------
    def logical_state(self) -> SinnamonState:
        """The state a snapshot stores: the whole raw store included."""
        return self.state

    def adopt_logical_state(self, state: SinnamonState) -> None:
        """Install a restored :meth:`logical_state` (the state lock held to
        write by the caller)."""
        self.state = state

    @property
    def size(self) -> int:
        return len(self._id2slot)

    def __contains__(self, ext_id) -> bool:
        return int(ext_id) in self._id2slot

    def doc_ids(self) -> list:
        """Sorted external ids of every live document."""
        return sorted(self._id2slot)

    def memory_bytes(self) -> dict:
        """Index-size accounting (paper §6.1.2)."""
        st = self.state
        nbytes = lambda t: t.numel() * t.element_size()      # noqa: E731
        out = {
            "sketch": nbytes(st.sketch),
            "inverted_index": nbytes(st.bits),
            "storage": nbytes(st.store.indices) + nbytes(st.store.values),
        }
        out["index_total"] = out["sketch"] + out["inverted_index"]
        return out


class TieredSinnamonIndex(SinnamonIndex):
    """:class:`SinnamonIndex` whose raw store is hot/cold tiered
    (counterpart of ``repro.core.engine.TieredSinnamonIndex``).

    The sketch, bitmap, ``active``, ``ids`` and ``dirty`` stay on the
    device; ``state.store`` is a zero-row placeholder and the raw CSR rows
    live in a :class:`repro_torch.storage.tiered.TieredVecStore` (pinned
    host backing behind a bounded device chunk cache), so the corpus can
    outgrow the device budget.  A search is the resident candidate
    generation, a host sync of the ``[B, k']`` candidate slots that drives
    chunk promotion, then :func:`rerank_topk_rows` over the gathered rows:
    the same rerank kernel on the same rows, so the answers are the
    resident index's bit for bit.  ``search`` is ``search_many`` at B = 1,
    as on the resident port.  Maintenance (compact, slot_drift) reads the
    dirty rows from the host backing in blocks of ``_MAINT_BLOCK`` slots;
    ``slot_drift`` reports 0 for clean slots (only the dirty set is
    evaluated).  The store's lock is always taken inside the state lock.
    """

    _MAINT_BLOCK = 256           # dirty-slot rows per maintenance step

    def __init__(self, spec: EngineSpec, device=None, *,
                 tier_chunk_slots: int = 256,
                 device_budget_bytes: Optional[int] = None,
                 cache_chunks: Optional[int] = None):
        from repro_torch.storage import tiered as tiered_mod
        self.spec = spec
        self.device = resolve_device(device)
        self.default_backend = None
        self.tiered = tiered_mod.TieredVecStore(
            spec.capacity, spec.max_nnz, value_dtype=spec.value_tdtype,
            chunk_slots=tier_chunk_slots,
            device_budget_bytes=device_budget_bytes,
            cache_chunks=cache_chunks, device=self.device)
        self.state = init(spec, self.device, store_rows=0)
        self._free = list(range(spec.capacity - 1, -1, -1))
        self._id2slot = {}
        self._state_lock = StateLock()
        self._obs = _WritePathMetrics()

    def _placeholder_store(self) -> vecstore.VecStore:
        return vecstore.empty(0, self.spec.max_nnz,
                              dtype=self.spec.value_tdtype,
                              device=self.device)

    # -- streaming updates ---------------------------------------------------
    def _write_insert(self, slots, ext_ids, idx_t, val_t,
                      trace=None) -> None:
        # Host backing first (write-through), its chunks pinned until the
        # sketch/bitmap update of this batch is issued.
        chunks = self.tiered.write_rows(slots, idx_t, val_t, pin=True)
        try:
            super()._write_insert(slots, ext_ids, idx_t, val_t, trace)
        finally:
            self.tiered.unpin(chunks)

    def _write_delete(self, slots) -> None:
        rows = self.tiered.read_indices(slots).to(self.device)
        delete_batch_rows(self.state, self.spec,
                          self._tensor(np.asarray(slots, np.int32),
                                       torch.int32), rows)
        self.tiered.erase_rows(slots)

    # -- retrieval -----------------------------------------------------------
    def search_many(self, q_idx, q_val, k: int, kprime: Optional[int] = None,
                    budget: Optional[int] = None, filter_mask=None,
                    score_fn=None, backend: Optional[str] = None,
                    trace=None):
        """Batched search: candidates, a host sync of their slots that
        drives promotion, then the rows-based rerank.  A device-timed
        ``trace`` gets the resident index's spans with ``prefetch`` (the
        slots' sync, promotion and row gather) before ``rerank``."""
        k, kprime = self._sizes(k, kprime)
        with self._state_lock.read():
            with _span(trace, "admission"):
                qi = self._tensor(q_idx, torch.int32)
                qv = self._tensor(q_val, torch.float32)
            ub, slots = topk_candidates(
                self.state, self.spec, qi, qv, kprime, budget,
                self._filter(filter_mask), score_fn=score_fn,
                backend=self._backend(backend), trace=trace)
            with _span(trace, "prefetch"):
                ridx, rval = self.tiered.gather_rows(slots)
            with _span(trace, "rerank"):
                ids, scores, _ = rerank_topk_rows(self.state, ub, slots,
                                                  ridx, rval, qi, qv, k)
            with _span(trace, "to_host"):
                return ids.cpu().numpy(), scores.cpu().numpy()

    # -- capacity / maintenance ----------------------------------------------
    def _grow(self, new_capacity: int) -> None:
        with self._state_lock.write():
            super()._grow(new_capacity)     # grow_state keeps the placeholder
            self.tiered.grow(new_capacity)

    def _dirty_blocks(self, state: SinnamonState):
        """(slots, idx rows, val rows) on the device, for each block of at
        most ``_MAINT_BLOCK`` dirty slots of ``state``, rows read from the
        host backing."""
        dirty = state.dirty.nonzero().squeeze(1).cpu().numpy()
        for lo in range(0, dirty.size, self._MAINT_BLOCK):
            blk = dirty[lo:lo + self._MAINT_BLOCK]
            ridx, rval = self.tiered.read_rows(blk)
            yield (torch.from_numpy(blk).to(self.device),
                   ridx.to(self.device), rval.to(self.device))

    def _fresh_compaction(self, state: SinnamonState):
        return [(s, fresh_cells_rows(state, self.spec, ri, rv))
                for s, ri, rv in self._dirty_blocks(state)]

    def _apply_compaction(self, fresh) -> None:
        for slots, cells in fresh:
            apply_compaction_rows(self.state, slots, cells)

    def slot_drift(self) -> np.ndarray:
        out = torch.zeros((self.spec.capacity,), dtype=torch.float32,
                          device=self.device)
        for slots, ri, rv in self._dirty_blocks(self.state):
            out[slots] = slot_drift_rows(self.state, self.spec, slots, ri, rv)
        return out.cpu().numpy()

    def memory_bytes(self) -> dict:
        out = super().memory_bytes()
        out["storage"] = self.tiered.device_bytes()       # device-resident
        out["storage_host"] = self.tiered.host_bytes()    # cold backing
        return out

    # -- persistence hooks ---------------------------------------------------
    def logical_state(self) -> SinnamonState:
        """The state with the whole raw store spliced in as CPU tensors —
        what a snapshot stores, so tiered and resident snapshots are one
        format."""
        idx, val = self.tiered.to_tensors()
        return dataclasses.replace(self.state,
                                   store=vecstore.VecStore(idx, val))

    def adopt_logical_state(self, state: SinnamonState) -> None:
        """Install a restored logical state: the raw rows go to the host
        backing (tiering state reset to access-free defaults), the rest
        stays where it is with the placeholder store."""
        self.tiered.load_rows(state.store.indices, state.store.values)
        self.state = dataclasses.replace(state,
                                         store=self._placeholder_store())
