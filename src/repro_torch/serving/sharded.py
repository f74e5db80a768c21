"""Sharded Sinnamon serving on the port: one process over S corpus shards.

Counterpart of ``repro.serving.sharded``.  The reference is one controller
process over a device mesh: jitted ``shard_map`` steps in which each
shard scores, reranks and updates its own slots, and only the k'-sized
candidate tuples cross shards.  The port keeps that form without a mesh:
:class:`ShardedSinnamonIndex` holds S engine indexes, one a shard, shard
s on ``devices[s % len(devices)]`` (several shards may share one card),
and runs the port's engine functions on each shard in turn, on the
caller's stream.  There is no ``torch.distributed``: one process owns
every shard, as the reference's controller does.

What the host keeps, as in the reference: one ``id → (shard, slot)`` dict,
one free list per shard (``range(cap-1, -1, -1)``, popped from the end),
routing by the Knuth hash ``((id * 2654435761) & 0xFFFFFFFF) % S``, update
blocks of ``update_block`` documents per shard, and ``spec.capacity`` as
the PER-SHARD slot count (shard s owns global slots ``[s·cap,
(s+1)·cap)`` of :meth:`ShardedSinnamonIndex.logical_state`).

Search.  Each shard issues ``engine.issue_candidates`` (kernel A and the
merge on the fused backend, or a ``score_fn`` such as kernel C) for
``kl = min(k', cap)`` candidates, every shard before any flag of the
two-pass selection is read (``kernels.ops.flagged``), then ``engine.rerank_topk`` (B's rerank
kernel) keeps its top ``min(k, kl)``; :func:`repro_torch.distributed.topk
.merge_shards` concatenates the shards in order and takes the global
top-k.  This equals the reference, which reranks all ``kl`` candidates of
every shard and takes one ``lax.top_k`` over the ``S·kl`` exact scores in
(shard, candidate position) order:

* every element of that global top-k lies in its own shard's top
  ``min(k, kl)``, because whatever precedes it in its shard precedes it
  globally too;
* the rerank kernel orders a shard's candidates by (score desc, candidate
  position asc), and the merge by (score desc, shard asc, rank asc), so
  the two pick the same entries in the same order — equal scores across
  shards go to the lower shard, and the ``-inf`` tail when k exceeds the
  live documents comes out in (shard, candidate position) order.

:class:`TieredShardedSinnamonIndex` makes each shard an
``engine.TieredSinnamonIndex``, with its own ``TieredVecStore`` on the
shard's device (the reference's per-shard tiers), and splits the search
into candidates, a host sync of their slots that drives each shard's chunk
promotion, and the rows-fed rerank, with the same merge: its answers are
the resident sharded index's bit for bit.
"""

from __future__ import annotations

import functools
import time
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import engine as eng
from repro_torch.core import sketch
from repro_torch.distributed import mesh as meshlib
from repro_torch.distributed import topk
from repro_torch.kernels import ops as _ops
from repro_torch.storage import vecstore

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# The mesh form: one rank a shard (the reference's shard_map step)
# ---------------------------------------------------------------------------

def _corpus_spec(mesh):
    corpus = meshlib.corpus_axes(mesh)
    return corpus if len(corpus) > 1 else (corpus[0] if corpus else None)


def state_pspecs(mesh, positive_only: bool = False) -> eng.SinnamonState:
    """The spec of every state leaf (corpus slots over the mesh's
    ``(pod, model)`` axes, the rest replicated), as the reference's
    ``state_pspecs``, on the port's leaves: ``sketch`` [2m or m, C] holds
    the reference's ``u`` and ``l``, and ``ids`` is int64[C] where the
    reference keeps uint32[C, 2].  ``positive_only`` is kept for the
    reference's signature: the sketch's spec is the same either way."""
    c = _corpus_spec(mesh)
    row = (c,) if c is not None else ()
    col = (None, c) if c is not None else ()
    return eng.SinnamonState(
        mappings=(), sketch=col, bits=col,
        store=vecstore.VecStore(indices=row, values=row),
        active=row, ids=row, dirty=row, m=0)


def _local_state(state: eng.SinnamonState) -> eng.SinnamonState:
    """This rank's shard: each leaf's local block."""
    loc = lambda t: getattr(t, "_local_tensor", t)          # noqa: E731
    return eng.SinnamonState(
        mappings=loc(state.mappings), sketch=loc(state.sketch),
        bits=loc(state.bits),
        store=vecstore.VecStore(loc(state.store.indices),
                                loc(state.store.values)),
        active=loc(state.active), ids=loc(state.ids), dirty=loc(state.dirty),
        m=state.m)


def make_search_step(mesh, local_spec: eng.EngineSpec, *, k: int,
                     kprime_local: int, budget: Optional[int] = None,
                     backend: Optional[str] = None,
                     use_kernel: Optional[bool] = None):
    """The SPMD search step of one rank, as the reference's
    ``make_search_step``: ``step(state, q_idx[B, Lq], q_val[B, Lq]) ->
    (scores f32[b, k], ids int64[b, k], locators int32[b, k])`` for this
    rank's queries (a DTensor batch over ``data``: its local rows).

    ``state`` is the global state, its leaves DTensors placed by
    :func:`state_pspecs` (or, on a one-device mesh, plain tensors).  The
    rank runs ``engine.search_batch`` on its own shard (the fused backend
    by default: kernel A and the merge, then B's rerank keeps its top
    ``min(k, kl)``), and the candidate tuples (scores, ids, packed
    (shard, slot) locators) are all-gathered over each corpus axis of more
    than one device, as ``merge_over_axes`` does (three all-gathers an
    axis; the reference's id is two uint32 payloads, the port's one
    int64), then ``topk.merge_shards`` takes the global top-k in (score
    desc, position asc) order.  On a one-device mesh nothing is gathered
    and the answer is ``engine.search_batch``'s.
    """
    from torch.distributed import _functional_collectives as funcol

    corpus = [a for a in meshlib.corpus_axes(mesh)
              if meshlib.n_shards(mesh, (a,)) > 1]
    backend = _ops.resolve_backend(backend)
    names = tuple(mesh.mesh_dim_names)

    def gather(t, ax):
        g = funcol.all_gather_tensor(t.contiguous(), t.dim() - 1,
                                     (mesh, names.index(ax)))
        return funcol.wait_tensor(g)

    def step(state: eng.SinnamonState, q_idx, q_val):
        local = _local_state(state)
        qi = getattr(q_idx, "_local_tensor", q_idx)
        qv = getattr(q_val, "_local_tensor", q_val)
        kl = min(kprime_local, local_spec.capacity)
        ids, scores, sl = eng.search_batch(local, local_spec, qi, qv,
                                           min(k, kl), kl, budget,
                                           backend=backend,
                                           use_kernel=use_kernel)
        shard = meshlib.linear_index(mesh, meshlib.corpus_axes(mesh))
        tup = (scores, ids, topk.pack_shard_slot(shard, sl))
        for ax in corpus:
            tup = tuple(gather(t, ax) for t in tup)
        vals, (ids, loc), _ = topk.merge_shards([tup[0]], [tup[1:]],
                                                min(k, tup[0].shape[-1]))
        return vals, ids, loc

    return step


def route_many(ext_ids, n_shards: int) -> np.ndarray:
    """Owning shard of each external id: the reference's Knuth hash
    ``((id * 2654435761) & 0xFFFFFFFF) % S`` on the ids' int64 bits."""
    u = np.asarray(ext_ids, np.int64).view(np.uint64)
    h = (u * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    return (h % np.uint64(n_shards)).astype(np.int64)


def concat_states(states) -> eng.SinnamonState:
    """The shards' states concatenated along every slot axis, in shard
    order, as one state on the CPU: the reference's global layout (u, l
    ``[R, C]``; bitmap words ``[rows, C/32]``; store ``[C, P]``; active,
    dirty, ids ``[C]``)."""
    ints = sketch.cell_bits
    cat = lambda ts, dim=0: torch.cat([t.cpu() for t in ts], dim=dim)  # noqa: E731
    first = states[0]
    return eng.SinnamonState(
        mappings=first.mappings.cpu(),
        sketch=cat([ints(st.sketch) for st in states], 1).view(
            first.sketch.dtype),
        bits=cat([st.bits for st in states], 1),
        store=vecstore.VecStore(
            cat([st.store.indices for st in states]),
            cat([ints(st.store.values) for st in states]).view(
                first.store.values.dtype)),
        active=cat([st.active for st in states]),
        ids=cat([st.ids for st in states]),
        dirty=cat([st.dirty for st in states]),
        m=first.m)


class ShardedSinnamonIndex:
    """Streaming index over S corpus shards, one process, one state each.

    ``spec.capacity`` is the PER-SHARD slot count.  ``devices`` is None
    (the visible CUDA devices; raises without one), one device, or a list;
    ``n_shards`` None means one shard per listed device, and shard s lives
    on ``devices[s % len(devices)]``.

    Each shard is an engine index on its device, made by ``make_shard(spec,
    device)`` (``engine.SinnamonIndex``; ``engine.TieredSinnamonIndex`` for
    the tiered form).  A shard keeps its state, free list and raw store,
    and its write, growth, compaction and snapshot hooks do the per-shard
    work.  This index keeps what spans the shards: the routing, the one
    ``id → (shard, slot)`` map, the update blocks, the merge, the write-path
    metrics and ``_state_lock``, which mutations hold to write and searches
    to read (``engine.StateLock``).  The shards' own id maps, locks and
    metrics stay unused.
    """

    def __init__(self, spec: eng.EngineSpec, devices=None, *,
                 n_shards: Optional[int] = None, update_block: int = 32,
                 make_shard=eng.SinnamonIndex):
        if update_block < 1:
            raise ValueError(f"update_block must be >= 1, got {update_block}")
        self.devices = meshlib.shard_devices(n_shards, devices)
        self.n_shards = len(self.devices)
        self.device = self.devices[0]          # where the merge runs
        self.update_block = int(update_block)
        self.default_backend: Optional[str] = None   # api.open_index sets it
        self.shards = [make_shard(spec, device=d) for d in self.devices]
        self._id2slot: dict[int, tuple[int, int]] = {}
        self._state_lock = eng.StateLock()
        self._obs = eng._WritePathMetrics()

    @property
    def spec(self) -> eng.EngineSpec:
        """The per-shard spec (every shard holds the same)."""
        return self.shards[0].spec

    @spec.setter
    def spec(self, spec: eng.EngineSpec) -> None:
        for sh in self.shards:
            sh.spec = spec

    @property
    def states(self) -> list:
        """Every shard's ``SinnamonState``, in shard order."""
        return [sh.state for sh in self.shards]

    @property
    def _free(self) -> list:
        """Every shard's free list (the lists themselves), in shard order."""
        return [sh._free for sh in self.shards]

    @_free.setter
    def _free(self, lists) -> None:
        for sh, free in zip(self.shards, lists):
            sh._free = [int(x) for x in free]

    # -- routing --------------------------------------------------------------
    def route(self, ext_id: int) -> int:
        """Owning shard of an external id (Knuth multiplicative hash)."""
        return int(route_many([int(ext_id)], self.n_shards)[0])

    def _rows(self, x, dtype, fill) -> Tensor:
        """Update rows [B, L] (numpy, or a tensor on any device) as a tensor
        where they lie, padded to [B, max_nnz]."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        width = self.spec.max_nnz
        if t.shape[1] > width:
            raise ValueError(f"document nnz {t.shape[1]} > max_nnz {width}")
        return torch.nn.functional.pad(t.to(dtype), (0, width - t.shape[1]),
                                       value=fill)

    # -- streaming updates ----------------------------------------------------
    def insert(self, ext_id: int, idx, val) -> None:
        i, v = eng.pad_sparse(idx, val, self.spec.max_nnz)
        self.insert_many([ext_id], i[None], v[None])

    def insert_many(self, ext_ids, idx_batch, val_batch) -> None:
        """Insert documents [B, L] under ``ext_ids``; an id already present
        is overwritten, and of a repeated id only the last occurrence is
        written (the reference's sequential-overwrite rule)."""
        t0 = time.perf_counter()
        ext_ids = ext_ids.tolist() if isinstance(ext_ids, torch.Tensor) \
            else [int(e) for e in ext_ids]
        idx_t = self._rows(idx_batch, torch.int32, -1)
        val_t = self._rows(val_batch, torch.float32, 0)
        if len(set(ext_ids)) != len(ext_ids):
            last = {e: pos for pos, e in enumerate(ext_ids)}
            keep = sorted(last.values())
            ext_ids = [ext_ids[p] for p in keep]
            sel = torch.tensor(keep, device=idx_t.device)
            idx_t, val_t = idx_t[sel], val_t[sel]
        with self._state_lock.write():
            stale = [e for e in ext_ids if e in self._id2slot]
            if stale:
                self.delete_many(stale)
            route = route_many(ext_ids, self.n_shards)
            per_shard = [np.flatnonzero(route == s)
                         for s in range(self.n_shards)]
            while any(len(sh._free) < pos.size
                      for sh, pos in zip(self.shards, per_shard)):
                self.grow()
            ids64 = np.asarray(ext_ids, np.int64)
            B = self.update_block
            for s, (sh, pos) in enumerate(zip(self.shards, per_shard)):
                n = pos.size
                if not n:
                    continue
                slots = np.asarray(sh._free[-n:][::-1], np.int32)  # pop order
                del sh._free[-n:]
                self._id2slot.update(zip(ids64[pos].tolist(),
                                         ((s, int(x)) for x in slots)))
                pos_t = torch.from_numpy(pos).to(idx_t.device)
                for lo in range(0, n, B):
                    take = pos_t[lo:lo + B]
                    sh._write_insert(slots[lo:lo + B], ids64[pos[lo:lo + B]],
                                     idx_t[take].to(sh.device),
                                     val_t[take].to(sh.device))
        self._obs.record("insert_many", t0, len(ext_ids))

    def delete(self, ext_id: int) -> None:
        self.delete_many([ext_id])

    def delete_many(self, ext_ids) -> None:
        """Delete ``ext_ids`` in blocks of ``update_block`` per shard.  A
        repeated id is one deletion; an unknown id raises ``KeyError``
        before anything changes.  Freed slots go back in reverse."""
        t0 = time.perf_counter()
        ext_ids = list(dict.fromkeys(int(e) for e in ext_ids))
        with self._state_lock.write():
            missing = [e for e in ext_ids if e not in self._id2slot]
            if missing:
                raise KeyError(f"unknown document ids: {missing[:5]}")
            per_shard = [[] for _ in range(self.n_shards)]
            for e in ext_ids:
                s, slot = self._id2slot.pop(e)
                per_shard[s].append(slot)
            B = self.update_block
            for sh, slots in zip(self.shards, per_shard):
                for lo in range(0, len(slots), B):
                    sh._write_delete(np.asarray(slots[lo:lo + B], np.int32))
                sh._free.extend(reversed(slots))
        self._obs.record("delete_many", t0, len(ext_ids))

    # -- retrieval ------------------------------------------------------------
    def _backend(self, backend) -> str:
        return _ops.resolve_backend(self.default_backend if backend is None
                                    else backend)

    def _sizes(self, k: int, kprime: Optional[int]):
        """(k, kl): ``kl = min(k', cap)`` per shard, ``k <= kl·S``."""
        kprime = kprime if kprime is not None else max(5 * k, k)
        kl = min(kprime, self.spec.capacity)
        return min(k, kl * self.n_shards), kl

    def _queries(self, q_idx, q_val) -> dict:
        """{device: (int32 q_idx, f32 q_val)} for every shard device."""
        out = {}
        for dev in self.devices:
            if dev not in out:
                out[dev] = (torch.as_tensor(q_idx).to(dev, torch.int32),
                            torch.as_tensor(q_val).to(dev, torch.float32))
        return out

    def _candidates(self, qs, kl: int, budget, score_fn, backend,
                    use_kernel) -> list:
        """Every shard's candidates [B, kl], issued on every shard before
        any flag is read (``ops.flagged``), so the shards' cards run
        together."""
        return [eng.issue_candidates(sh.state, sh.spec, *qs[sh.device], kl,
                                     budget, score_fn=score_fn,
                                     backend=backend, use_kernel=use_kernel)
                for sh in self.shards]

    def _merge(self, parts, k: int):
        """Merge per-shard (scores, ids, local slots), each shard's [B, kk],
        into the global (scores, ids, locators), shard order breaking
        ties; a locator's shard is its concatenated position // kk."""
        scores, (ids, slots), pos = topk.merge_shards(
            [sc for sc, _, _ in parts], [(ids, sl) for _, ids, sl in parts],
            k, self.device)
        return scores, ids, topk.pack_shard_slot(pos // parts[0][0].shape[-1],
                                                 slots)

    def _sync(self) -> None:
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @staticmethod
    def _host(scores, ids, loc, return_locators: bool):
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        if return_locators:
            return ids, scores, loc.cpu().numpy()
        return ids, scores

    def search(self, q_idx, q_val, k: int, kprime: Optional[int] = None,
               budget: Optional[int] = None, score_fn=None,
               backend: Optional[str] = None, trace=None):
        ids, scores = self.search_many(
            torch.as_tensor(np.asarray(q_idx))[None],
            torch.as_tensor(np.asarray(q_val))[None], k, kprime=kprime,
            budget=budget, score_fn=score_fn, backend=backend, trace=trace)
        return ids[0], scores[0]

    def search_many(self, q_idx, q_val, k: int,
                    kprime: Optional[int] = None,
                    budget: Optional[int] = None, score_fn=None,
                    backend: Optional[str] = None,
                    return_locators: bool = False, trace=None,
                    use_kernel: Optional[bool] = None):
        """Batched search over [B, Lq] queries -> (ids int64[B, k], scores
        f32[B, k]) as numpy arrays, plus packed (shard, slot) locators with
        ``return_locators`` (decode with ``topk.unpack_shard_slot``).

        ``kprime`` is the per-shard candidate count k'; ``score_fn``
        (batch-native) overrides ``backend``; ``use_kernel`` is passed to
        the kernels' wrappers.  ``trace`` (a ``repro_torch.obs.Trace``)
        records the whole search as one ``spmd_search`` span (synced, or
        device-timed on the first shard's device).
        """
        k, kl = self._sizes(k, kprime)
        backend = None if score_fn is not None else self._backend(backend)
        with self._state_lock.read():
            with (nullcontext() if trace is None
                  else trace.span("spmd_search")):
                qs = self._queries(q_idx, q_val)
                cands = self._candidates(qs, kl, budget, score_fn, backend,
                                         use_kernel)

                def rerank(sh, ub, slots):
                    ids, sc, sl = eng.rerank_topk(
                        sh.state, ub, slots, *qs[sh.device], min(k, kl),
                        use_kernel=use_kernel)
                    return sc, ids, sl

                parts = [rerank(sh, c.vals, c.slots)
                         for sh, c in zip(self.shards, cands)]
                for i, redo in enumerate(_ops.flagged(cands)):
                    if redo:
                        parts[i] = rerank(self.shards[i], *cands[i].redo())
                out = self._host(*self._merge(parts, k), return_locators)
        return out

    # -- capacity management --------------------------------------------------
    def grow(self, new_local_capacity: Optional[int] = None) -> None:
        """Double (or set) every shard's local capacity; slot numbering
        within a shard is kept and the new slots are prepended to every
        free list (so they are handed out last)."""
        t0 = time.perf_counter()
        with self._state_lock.write():
            new_c = new_local_capacity or self.spec.capacity * 2
            for sh in self.shards:         # the first one checks new_c
                sh._grow(new_c)
        self._obs.record("grow", t0)

    # -- maintenance ------------------------------------------------------------
    def compact(self) -> int:
        """Rebuild every shard's dirty sketch columns; returns the number of
        columns rebuilt over all shards.  The re-encode only reads the
        states and runs outside the state lock; the columns are written
        under it, all shards at once."""
        t0 = time.perf_counter()
        base = self.states
        n_dirty = self._n_dirty(base)
        if n_dirty:
            fresh = self._fresh_compaction(base)
            with self._state_lock.write():
                self._apply_compaction(fresh)
        self._obs.record("compact", t0)
        return n_dirty

    @staticmethod
    def _n_dirty(states) -> int:
        return sum(int(st.dirty.sum()) for st in states)

    def _fresh_compaction(self, states) -> list:
        """The re-encoded cells a compaction of ``states`` writes in, one
        entry a shard (each shard's own re-encode)."""
        return [sh._fresh_compaction(st)
                for sh, st in zip(self.shards, states)]

    def _apply_compaction(self, fresh) -> None:
        for sh, cells in zip(self.shards, fresh):
            sh._apply_compaction(cells)

    def slot_drift(self) -> np.ndarray:
        """Per-slot sketch overestimate vs. a fresh sketch (f32[C_global])."""
        return np.concatenate([sh.slot_drift() for sh in self.shards])

    # -- persistence hooks (repro_torch.persist.snapshot) ---------------------
    def logical_state(self) -> eng.SinnamonState:
        """The shards' states concatenated in shard order on the CPU, the
        reference's global layout (what a snapshot stores); the search
        path never builds it."""
        return concat_states([sh.logical_state() for sh in self.shards])

    def adopt_leaves(self, leaves: dict) -> None:
        """Install a restored global state given as snapshot leaves
        (``convert.state_to_numpy``'s keys): shard s's block of every slot
        axis on its device, a tiered shard's raw rows on the host (the
        state lock held to write by the caller)."""
        store_device = "cpu" if isinstance(self.shards[0],
                                           eng.TieredSinnamonIndex) else None
        states = convert.sharded_states_from_numpy(
            leaves, self.spec, self.devices, store_device=store_device)
        for sh, st in zip(self.shards, states):
            sh.adopt_logical_state(st)

    def adopt_logical_state(self, state: eng.SinnamonState) -> None:
        """Install a restored global :meth:`logical_state`."""
        self.adopt_leaves(convert.state_to_numpy(state, self.spec))

    # -- misc -------------------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self._id2slot)

    def __contains__(self, ext_id) -> bool:
        """True iff ``ext_id`` is currently live in the index."""
        return int(ext_id) in self._id2slot

    def doc_ids(self) -> list:
        """Sorted external ids of every live document."""
        return sorted(self._id2slot)

    def memory_bytes(self) -> dict:
        """Index-size accounting (paper §6.1.2), summed over the shards."""
        out: dict = {}
        for sh in self.shards:
            for key, n in sh.memory_bytes().items():
                out[key] = out.get(key, 0) + n
        return out


class TieredShardedSinnamonIndex(ShardedSinnamonIndex):
    """:class:`ShardedSinnamonIndex` whose shards are
    ``engine.TieredSinnamonIndex``es, each with a hot/cold tiered raw store
    on its device (counterpart of
    ``repro.serving.sharded.TieredShardedSinnamonIndex``;
    ``device_budget_bytes`` is PER SHARD).

    Writes, growth, maintenance and snapshots are the tiered shards' own:
    inserts write the rows pinned and then apply the block, deletes read
    the coordinates from the store before they clear the bits, and
    maintenance reads the dirty rows from the host backings.  A search
    takes every shard's candidates, syncs their slots to the host
    (``spmd_candidates``), has each shard's store gather the rows
    (``prefetch``), then reranks the rows with B's rerank kernel and merges
    (``spmd_rerank``): the same rows, kernel and merge as the resident
    index, so the answers are its bit for bit.  ``score_fn`` is not
    supported, as in the reference.
    """

    def __init__(self, spec: eng.EngineSpec, devices=None, *,
                 n_shards: Optional[int] = None, update_block: int = 32,
                 tier_chunk_slots: int = 256,
                 device_budget_bytes: Optional[int] = None,
                 cache_chunks: Optional[int] = None):
        super().__init__(spec, devices, n_shards=n_shards,
                         update_block=update_block,
                         make_shard=functools.partial(
                             eng.TieredSinnamonIndex,
                             tier_chunk_slots=tier_chunk_slots,
                             device_budget_bytes=device_budget_bytes,
                             cache_chunks=cache_chunks))

    @property
    def tiers(self) -> list:
        """Every shard's ``TieredVecStore``, in shard order."""
        return [sh.tiered for sh in self.shards]

    def search_many(self, q_idx, q_val, k: int,
                    kprime: Optional[int] = None,
                    budget: Optional[int] = None, score_fn=None,
                    backend: Optional[str] = None,
                    return_locators: bool = False, trace=None,
                    use_kernel: Optional[bool] = None):
        """Candidates, a host sync of their slots driving each shard's
        chunk promotion, then the rows-fed rerank and the merge; with
        ``trace`` the stages are the ``spmd_candidates`` / ``prefetch`` /
        ``spmd_rerank`` spans."""
        if score_fn is not None:
            raise NotImplementedError(
                "score_fn is not supported on the tiered sharded index")
        k, kl = self._sizes(k, kprime)
        backend = self._backend(backend)
        span = (lambda name: nullcontext()) if trace is None \
            else trace.span
        with self._state_lock.read():
            qs = self._queries(q_idx, q_val)
            with span("spmd_candidates"):
                cands = self._candidates(qs, kl, budget, None, backend,
                                         use_kernel)
                cands = [c.redo() if redo else (c.vals, c.slots)
                         for c, redo in zip(cands, _ops.flagged(cands))]
                hosts = [slots.cpu() for _, slots in cands]      # sync
            with span("prefetch"):
                rows = [sh.tiered.gather_rows(slots, host) for sh, (_, slots),
                        host in zip(self.shards, cands, hosts)]
                if trace is not None and not trace.device_timed:
                    self._sync()
            with span("spmd_rerank"):
                parts = []
                for sh, (ub, slots), (ridx, rval) in zip(self.shards, cands,
                                                         rows):
                    ids, sc, sl = eng.rerank_topk_rows(
                        sh.state, ub, slots, ridx, rval, *qs[sh.device],
                        min(k, kl), use_kernel=use_kernel)
                    parts.append((sc, ids, sl))
                out = self._host(*self._merge(parts, k), return_locators)
        return out
