"""Frequency-aware hot/cold tiering for the raw store (counterpart of
``repro.storage.tiered``).

The sketch is the small, always-resident part of a Sinnamon index; the raw
padded-CSR rows that only the Algorithm 7 exact rerank reads dominate its
memory.  :class:`TieredVecStore` lets that raw store outgrow the device:

* the **host backing** (authoritative, write-through) holds every row,
  partitioned into *chunks* of ``chunk_slots`` consecutive slots.  It is
  CPU tensors, in pinned memory when the cache lives on a CUDA device
  (``grow`` re-allocates it pinned);
* a **bounded device chunk cache** holds at most ``cache_chunks`` chunks
  as one ``[L, chunk_slots, P]`` int32 / value-dtype tensor pair on the
  index's device, sized from ``device_budget_bytes``;
* **LFU-with-aging** eviction: per-chunk access counters, halved every
  ``aging_every`` accesses;
* **candidate-driven promotion**: :meth:`gather_rows` / :meth:`prefetch`
  promote the unique cold chunks of a ``[B, k']`` candidate set before the
  rerank reads its rows;
* a **pinned set** protects chunks an in-flight insert touches.

Writes go to the host first, then to the resident device line, so a
demotion is a map drop and nothing is ever flushed.  A promotion fires the
``vecstore.read`` failpoint before any map mutation, so an injected read
fault never leaves a mapped-but-unfilled line.  The names of the metrics,
the geometry, the LFU policy and ``stats()`` are the reference's.

On the device.  The reference's cache arrays are immutable; this cache is
written in place.  Every device operation of the store (a promotion's copy
into its lines, a write-through patch, a gather out of the lines) is issued
on the caller's current stream, under the store's lock, so on one stream a
line is overwritten only after every gather queued before it has read it.
A caller on another stream first waits on an event recorded after the last
device operation of the store, so the same holds across streams.  A
promotion stages its chunks in a fresh pinned buffer (``index_select`` from
the backing) and copies them with one ``non_blocking`` copy; PyTorch's
pinned-memory allocator keeps that buffer alive until the copy has run.
The maps are committed only after the copy is issued.  :meth:`gather_rows`
returns fresh device tensors (a copy out of the lines).  When the
candidates' chunks do not fit the cache (or every line is pinned) the rows
come from the backing by ``index_select`` and go to the device in one copy
(the reference's host-gather fallback, counted in ``fallbacks``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch
from repro_torch.fault import failpoints as _fp
from repro_torch.obs import metrics as obs_metrics

Tensor = torch.Tensor


def _value_dtype(value_dtype) -> torch.dtype:
    return value_dtype if isinstance(value_dtype, torch.dtype) \
        else sketch.torch_cell_dtype(value_dtype)


def chunk_bytes(chunk_slots: int, max_nnz: int, value_dtype) -> int:
    """Device bytes one resident chunk occupies (int32 indices + values)."""
    item = torch.empty((), dtype=_value_dtype(value_dtype)).element_size()
    return chunk_slots * max_nnz * (4 + item)


class _TierMetrics:
    """Process-global tier counters, lazily (re)bound to the current metrics
    registry, so ``obs.metrics.set_registry`` takes effect on existing
    stores.  Names and help texts are the reference's."""

    __slots__ = ("_registry", "hits", "misses", "promotions", "evictions",
                 "prefetched", "fallbacks")

    def __init__(self):
        self._registry = None

    def bind(self) -> "_TierMetrics":
        reg = obs_metrics.get_registry()
        if reg is not self._registry:
            self.hits = reg.counter(
                "repro_tier_hits_total",
                "Chunk-cache hits (unique chunks already device-resident).")
            self.misses = reg.counter(
                "repro_tier_misses_total",
                "Chunk-cache misses (chunk cold at access time).")
            self.promotions = reg.counter(
                "repro_tier_promotions_total",
                "Cold chunks copied host -> device cache.")
            self.evictions = reg.counter(
                "repro_tier_evictions_total",
                "Resident chunks demoted (LFU-with-aging victim drop).")
            self.prefetched = reg.counter(
                "repro_tier_prefetch_total",
                "Chunks promoted by candidate-driven prefetch.")
            self.fallbacks = reg.counter(
                "repro_tier_fallback_total",
                "Row gathers served straight from host backing "
                "(every cache line pinned).")
            self._registry = reg
        return self


def _host_slots(slots) -> np.ndarray:
    if isinstance(slots, torch.Tensor):
        slots = slots.cpu().numpy()
    return np.asarray(slots, np.int64).reshape(-1)


class TieredVecStore:
    """Chunked host-RAM CSR row store behind a bounded device chunk cache.

    ``capacity`` / ``max_nnz`` mirror the resident store's ``[C, P]``.
    Exactly one of ``device_budget_bytes`` / ``cache_chunks`` sizes the
    cache (``cache_chunks`` wins when both are given); the budget is rounded
    down to whole chunks with a floor of one line.  ``device`` holds the
    cache and every gather's output (None: the CPU).  All methods are
    thread-safe.
    """

    def __init__(self, capacity: int, max_nnz: int, *,
                 value_dtype="bfloat16", chunk_slots: int = 256,
                 device_budget_bytes: Optional[int] = None,
                 cache_chunks: Optional[int] = None,
                 device=None, aging_every: int = 4096):
        if chunk_slots < 1:
            raise ValueError("chunk_slots must be >= 1")
        self.max_nnz = max_nnz
        self.chunk_slots = chunk_slots
        self._vdtype = _value_dtype(value_dtype)
        self._device = torch.device("cpu" if device is None else device)
        self._pin = self._device.type == "cuda"
        self.aging_every = aging_every
        if cache_chunks is None:
            if device_budget_bytes is None:
                raise ValueError("size the cache with device_budget_bytes "
                                 "or cache_chunks")
            cache_chunks = max(1, int(device_budget_bytes)
                               // chunk_bytes(chunk_slots, max_nnz,
                                              self._vdtype))
        self.cache_chunks = int(cache_chunks)

        self.capacity = 0
        self._h_idx = self._host_empty((0, max_nnz), torch.int32, -1)
        self._h_val = self._host_empty((0, max_nnz), self._vdtype, 0)
        self._freq = np.zeros((0,), np.float64)
        self._line_by_chunk = np.zeros((0,), np.int32)
        self._line_dev = torch.zeros((0,), dtype=torch.int32,
                                     device=self._device)
        self._last_op = None         # (stream, event) of the last device op
        self._resize_backing(capacity)

        L, S, P = self.cache_chunks, chunk_slots, max_nnz
        self._c_idx = torch.full((L, S, P), -1, dtype=torch.int32,
                                 device=self._device)
        self._c_val = torch.zeros((L, S, P), dtype=self._vdtype,
                                  device=self._device)
        self._chunk_by_line = np.full((L,), -1, np.int64)
        self._free_lines = list(range(L - 1, -1, -1))
        self._pinned: set[int] = set()
        self._accesses = 0
        self._lock = threading.RLock()
        self._m = _TierMetrics()
        # instance-local counters for stats() (the registry counters
        # aggregate across stores)
        self._hits = self._misses = self._promotions = 0
        self._evictions = self._prefetched = self._fallbacks = 0
        self.h2d_bytes = 0           # host-to-device bytes of rows moved

    # -- geometry -------------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        return self._h_idx.shape[0] // self.chunk_slots

    @property
    def value_dtype(self) -> torch.dtype:
        return self._vdtype

    @property
    def device(self) -> torch.device:
        return self._device

    def device_bytes(self) -> int:
        return (self._c_idx.numel() * self._c_idx.element_size()
                + self._c_val.numel() * self._c_val.element_size())

    def host_bytes(self) -> int:
        return (self._h_idx.numel() * self._h_idx.element_size()
                + self._h_val.numel() * self._h_val.element_size())

    def resident_chunks(self) -> int:
        return self.cache_chunks - len(self._free_lines)

    def _host_empty(self, shape, dtype, fill) -> Tensor:
        return torch.full(shape, fill, dtype=dtype, pin_memory=self._pin)

    def _resize_backing(self, new_capacity: int) -> None:
        S = self.chunk_slots
        padded = -(-new_capacity // S) * S       # whole chunks
        old = self._h_idx.shape[0]
        if padded < old:
            raise ValueError("TieredVecStore cannot shrink")
        if padded > old:
            h_idx = self._host_empty((padded, self.max_nnz), torch.int32, -1)
            h_val = self._host_empty((padded, self.max_nnz), self._vdtype, 0)
            h_idx[:old] = self._h_idx
            h_val[:old] = self._h_val
            self._h_idx, self._h_val = h_idx, h_val
            nc = padded // S
            self._freq = np.concatenate(
                [self._freq, np.zeros((nc - self._freq.size,), np.float64)])
            self._line_by_chunk = np.concatenate(
                [self._line_by_chunk,
                 np.full((nc - self._line_by_chunk.size,), -1, np.int32)])
            self._sync_line_map()
        self.capacity = new_capacity

    # -- device ordering ------------------------------------------------------
    def _begin_device_op(self) -> None:
        """Order this call's device work after the store's last device op
        when that ran on another stream (see the module docstring)."""
        if self._device.type != "cuda" or self._last_op is None:
            return
        stream, event = self._last_op
        current = torch.cuda.current_stream(self._device)
        if stream != current:
            current.wait_event(event)

    def _end_device_op(self) -> None:
        if self._device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self._device)
        event = torch.cuda.Event()
        event.record(stream)
        self._last_op = (stream, event)

    def _to_device(self, t: Tensor) -> Tensor:
        """A host tensor on the cache's device: one ``non_blocking`` copy
        from pinned memory on CUDA (the tensor itself on the CPU)."""
        if self._device.type == "cpu":
            return t
        self.h2d_bytes += t.numel() * t.element_size()
        return t.to(self._device, non_blocking=True)

    def _pinned_rows(self, src: Tensor, rows: np.ndarray) -> Tensor:
        """``src[rows]`` as a fresh (pinned, on CUDA) host tensor."""
        out = torch.empty((rows.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, pin_memory=self._pin)
        return torch.index_select(src, 0, torch.from_numpy(rows), out=out)

    def _sync_line_map(self) -> None:
        """Mirror the chunk -> line map on the device, for the gathers."""
        self._begin_device_op()
        if self._line_dev.shape[0] != self._line_by_chunk.size:
            self._line_dev = torch.empty((self._line_by_chunk.size,),
                                         dtype=torch.int32,
                                         device=self._device)
        self._line_dev.copy_(torch.from_numpy(self._line_by_chunk))
        self._end_device_op()

    # -- LFU with aging -------------------------------------------------------
    def _touch(self, chunks: np.ndarray) -> None:
        self._freq[chunks] += 1.0
        self._accesses += len(chunks)
        if self._accesses >= self.aging_every:
            self._freq *= 0.5                    # age: historical heat decays
            self._accesses = 0

    def _evictable(self, keep: np.ndarray) -> np.ndarray:
        """Resident chunks neither pinned nor in ``keep``."""
        res = self._chunk_by_line[self._chunk_by_line >= 0]
        held = np.concatenate([keep.astype(np.int64),
                               np.fromiter(self._pinned, np.int64,
                                           len(self._pinned))])
        return res[~np.isin(res, held)]

    def _pick_victim(self, keep: np.ndarray) -> Optional[int]:
        """Least-frequently-used resident chunk neither pinned nor in
        ``keep`` (ties: lowest id)."""
        cand = self._evictable(keep)
        if cand.size == 0:
            return None
        f = self._freq[cand]
        return int(cand[f == f.min()].min())

    def _evict(self, chunk: int) -> None:
        line = int(self._line_by_chunk[chunk])
        self._line_by_chunk[chunk] = -1
        self._chunk_by_line[line] = -1
        self._free_lines.append(line)
        self._evictions += 1
        self._m.bind().evictions.inc()

    def _ensure_resident(self, chunks, count=None) -> bool:
        """Promote every chunk in ``chunks`` (host -> device cache).

        Returns False (promoting nothing further) if the chunks cannot all
        fit before the cache is fully pinned; the caller then gathers from
        the host.  The ``vecstore.read`` failpoint fires before any map
        mutation for the new chunks, so a failed promotion never leaves a
        chunk marked resident.  A resident chunk of ``chunks`` is never the
        victim: the reference's LFU may pick one (its gather then reads
        rows through an unmapped line), the port holds them like pinned
        ones.
        """
        chunks = np.asarray(chunks, np.int64)
        need = [int(c) for c in chunks if self._line_by_chunk[c] < 0]
        if not need:
            return True
        if len(need) > len(self._free_lines) + self._evictable(chunks).size:
            return False    # can't fit: don't churn the cache for nothing
        lines = []
        for c in need:
            if not self._free_lines:
                victim = self._pick_victim(chunks)
                if victim is None:               # everything pinned
                    self._free_lines.extend(reversed(lines))
                    return False
                self._evict(victim)
            lines.append(self._free_lines.pop())
        try:
            _fp.fire("vecstore.read")            # injected cold-read faults
            S, P = self.chunk_slots, self.max_nnz
            view_i = self._h_idx.view(self.num_chunks, S, P)
            view_v = self._h_val.view(self.num_chunks, S, P)
            need_np = np.asarray(need, np.int64)
            stage_i = self._pinned_rows(view_i, need_np)
            stage_v = self._pinned_rows(view_v, need_np)
            lines_t = torch.as_tensor(lines, dtype=torch.long,
                                      device=self._device)
            self._begin_device_op()
            self._c_idx.index_copy_(0, lines_t, self._to_device(stage_i))
            self._c_val.index_copy_(0, lines_t, self._to_device(stage_v))
            self._end_device_op()
        except BaseException:
            self._free_lines.extend(reversed(lines))   # lines stay unmapped
            raise
        for c, line in zip(need, lines):         # commit only after the copy
            self._line_by_chunk[c] = line
            self._chunk_by_line[line] = c
        self._sync_line_map()
        self._promotions += len(need)
        self._m.bind().promotions.inc(len(need))
        if count is not None:
            count.inc(len(need))
        return True

    # -- pinning --------------------------------------------------------------
    def _chunks_of(self, slots: np.ndarray) -> np.ndarray:
        return np.unique(np.asarray(slots, np.int64) // self.chunk_slots)

    def pin(self, chunks) -> None:
        with self._lock:
            self._pinned.update(int(c) for c in chunks)

    def unpin(self, chunks) -> None:
        with self._lock:
            for c in chunks:
                self._pinned.discard(int(c))

    @contextmanager
    def pinning(self, slots):
        """Pin the chunks covering ``slots`` for the duration of the block."""
        chunks = self._chunks_of(_host_slots(slots))
        added = [int(c) for c in chunks if int(c) not in self._pinned]
        self.pin(added)
        try:
            yield
        finally:
            self.unpin(added)

    # -- reads ----------------------------------------------------------------
    def gather_rows(self, slots, host_slots=None) -> Tuple[Tensor, Tensor]:
        """Device rows for ``slots`` (a flat int array or tensor, on any
        device) — the rerank feed: (int32[K, P], value dtype[K, P]), fresh
        tensors on the cache's device.  ``host_slots``, a host copy of
        device ``slots`` the caller already holds, saves a copy back.

        Promotes the unique cold chunks first (LFU eviction as needed); when
        they cannot all be resident the rows come straight from the host
        backing instead (the fallback), so a query never blocks on an
        unevictable cache.
        """
        with self._lock:
            dev_slots = slots.reshape(-1) if isinstance(slots, torch.Tensor) \
                and slots.device == self._device else None
            host = _host_slots(slots if host_slots is None else host_slots)
            chunks = self._chunks_of(host)
            self._touch(chunks)
            m = self._m.bind()
            hits = int(np.sum(self._line_by_chunk[chunks] >= 0))
            self._hits += hits
            self._misses += len(chunks) - hits
            m.hits.inc(hits)
            m.misses.inc(len(chunks) - hits)
            if self._ensure_resident(chunks):
                if dev_slots is None:
                    dev_slots = torch.from_numpy(host).to(self._device)
                dev_slots = dev_slots.long()
                self._begin_device_op()
                lines = self._line_dev[dev_slots // self.chunk_slots].long()
                offs = dev_slots % self.chunk_slots
                out = self._c_idx[lines, offs], self._c_val[lines, offs]
                self._end_device_op()
                return out
            self._fallbacks += 1
            m.fallbacks.inc()
            return (self._to_device(self._pinned_rows(self._h_idx, host)),
                    self._to_device(self._pinned_rows(self._h_val, host)))

    def prefetch(self, slots) -> int:
        """Promote the chunks covering candidate ``slots`` (best effort).

        Returns the number of chunks promoted.
        """
        with self._lock:
            chunks = self._chunks_of(_host_slots(slots))
            self._touch(chunks)
            before = self._promotions
            self._ensure_resident(chunks, count=self._m.bind().prefetched)
            n = self._promotions - before
            self._prefetched += n
            return n

    def read_indices(self, slots) -> Tensor:
        """Host read of index rows (no promotion) — the delete bit-clear
        feed; a fresh CPU tensor."""
        with self._lock:
            return self._h_idx[torch.from_numpy(_host_slots(slots))]

    def read_rows(self, slots) -> Tuple[Tensor, Tensor]:
        """Host read of full rows (no promotion) — the compaction/drift
        feed; fresh CPU tensors."""
        with self._lock:
            s = torch.from_numpy(_host_slots(slots))
            return self._h_idx[s], self._h_val[s]

    # -- writes (write-through) ----------------------------------------------
    def write_rows(self, slots, idx_rows, val_rows, *, pin: bool = False):
        """Write CSR rows (numpy or tensors on any device): host backing
        first, then any resident device copy.

        With ``pin=True`` the touched chunks are left pinned (the caller
        unpins once the in-flight insert's device work is issued); the
        chunk ids are returned either way.
        """
        with self._lock:
            host = _host_slots(slots)
            n = host.size
            idx_rows = torch.as_tensor(idx_rows).reshape(n, self.max_nnz)
            val_rows = torch.as_tensor(val_rows).reshape(n, self.max_nnz)
            s = torch.from_numpy(host)
            self._h_idx[s] = idx_rows.to(torch.int32).cpu()
            self._h_val[s] = val_rows.to(self._vdtype).cpu()
            chunks = self._chunks_of(host)
            self._touch(chunks)
            if pin:
                self.pin(chunks)
            lines = self._line_by_chunk[host // self.chunk_slots]
            res = lines >= 0
            if res.any():
                sel = torch.from_numpy(np.flatnonzero(res))
                li = torch.from_numpy(lines[res].astype(np.int64))
                of = torch.from_numpy(host[res] % self.chunk_slots)
                li, of = li.to(self._device), of.to(self._device)
                ri = idx_rows[sel.to(idx_rows.device)].to(self._device,
                                                          torch.int32)
                rv = val_rows[sel.to(val_rows.device)].to(self._device,
                                                          self._vdtype)
                self._begin_device_op()
                self._c_idx[li, of] = ri
                self._c_val[li, of] = rv
                self._end_device_op()
            return chunks

    def erase_rows(self, slots) -> None:
        n = _host_slots(slots).size
        self.write_rows(
            slots, torch.full((n, self.max_nnz), -1, dtype=torch.int32),
            torch.zeros((n, self.max_nnz), dtype=self._vdtype))

    # -- bulk / lifecycle -----------------------------------------------------
    def to_tensors(self) -> Tuple[Tensor, Tensor]:
        """The full logical store as CPU tensors [capacity, P] (snapshots)."""
        with self._lock:
            return (self._h_idx[:self.capacity].clone(),
                    self._h_val[:self.capacity].clone())

    def load_rows(self, indices, values) -> None:
        """Replace the whole backing store (snapshot restore).

        Tiering state resets to access-free defaults: empty cache, zero
        frequencies, nothing pinned — recovery never trusts pre-crash heat.
        """
        with self._lock:
            indices = torch.as_tensor(indices)
            self.capacity = 0
            self._h_idx = self._host_empty((0, self.max_nnz), torch.int32, -1)
            self._h_val = self._host_empty((0, self.max_nnz), self._vdtype, 0)
            self._freq = np.zeros((0,), np.float64)
            self._line_by_chunk = np.zeros((0,), np.int32)
            self._resize_backing(indices.shape[0])
            self._h_idx[:indices.shape[0]] = indices.to(torch.int32).cpu()
            self._h_val[:indices.shape[0]] = torch.as_tensor(values).to(
                self._vdtype).cpu()
            L = self.cache_chunks
            self._chunk_by_line = np.full((L,), -1, np.int64)
            self._free_lines = list(range(L - 1, -1, -1))
            self._pinned.clear()
            self._accesses = 0

    def grow(self, new_capacity: int) -> None:
        """Extend the host backing (cache geometry is unchanged)."""
        with self._lock:
            self._resize_backing(new_capacity)

    # -- reporting ------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {
                "hits": self._hits, "misses": self._misses,
                "promotions": self._promotions, "evictions": self._evictions,
                "prefetched": self._prefetched, "fallbacks": self._fallbacks,
                "hit_rate": (self._hits / total) if total else 0.0,
                "resident_chunks": self.resident_chunks(),
                "cache_chunks": self.cache_chunks,
                "num_chunks": self.num_chunks,
                "resident_bytes": self.device_bytes(),
                "host_bytes": self.host_bytes(),
            }
