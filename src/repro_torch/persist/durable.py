"""WAL-on-write wrapper around the single-device streaming index.

Counterpart of ``repro.persist.durable``.  ``DurableSinnamonIndex``
subclasses :class:`repro_torch.core.engine.SinnamonIndex` and logs every
public mutation to the write-ahead log *before* applying it, so recovery =
latest snapshot + replay of the WAL tail through the same host code paths.
Replay reproduces slot allocation, free-list order, capacity growth,
recycled-column merges and compaction points bit for bit: a recovered
index returns the same ids and scores as the never-restarted one.  The
snapshot and WAL formats are the reference's, so either package recovers
what the other wrote.

Determinism notes (as in the reference):

* Auto-grow inside an insert is not logged — it is a deterministic
  function of the op stream.  Explicit ``grow()`` calls are logged.
* ``compact()`` IS logged (KIND_COMPACT): it changes upper-bound scores, so
  replay rebuilds the dirty columns at the same op position.
* ``delete_many`` logs ONE KIND_DELETE record with all its ids; replaying
  it deletes each id in order, which is what ``delete_many`` promises (the
  reference's single-device replay deletes them one by one, to the same
  state).

Concurrency.  The reference's state is immutable, so its searches read a
state reference without any lock and a compaction decides whether a write
raced it by object identity.  The port writes its tensors in place, so:

* ``_lock`` (the op lock) orders mutations, snapshots and WAL appends, as
  in the reference; each logged op bumps ``_mutations`` under it.
* Searches take only the index's ``_state_lock`` (a reader-writer lock,
  :class:`repro_torch.core.engine.StateLock`) to read, side by side;
  every in-place apply takes it to write, so a search answers from the
  state before or after a write, never from half of it.  Searches never
  wait on the op lock: not on a
  write's fsync, a snapshot's device-to-host copy and disk write, nor a
  compaction's re-encode.
* ``snapshot()`` holds the op lock (no write can run) and copies the state
  to the host and writes it with searches going on beside it.
* ``try_compact_async()`` re-encodes the store into new tensors with no
  lock held, then, under the op lock and the state lock, writes the dirty
  columns in only if ``_mutations`` has not moved (else returns None).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import engine as eng
from repro_torch.fault import failpoints as _fp
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.persist import snapshot as snaplib
from repro_torch.persist import wal


def _host(x, dtype) -> np.ndarray:
    """``x`` (numpy-like, or a tensor on any device) as a host array of
    ``dtype``; a device tensor's copy has finished when this returns."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _DurableOps:
    """Logging, policy and recovery machinery of the durable index."""

    def _init_durable(self, *, wal_dir: str, snapshot_dir: Optional[str],
                      fsync: bool, segment_bytes: int,
                      snapshot_every: Optional[int],
                      compact_threshold: Optional[float],
                      compact_check_every: int,
                      snapshot_keep: int):
        self.wal_dir = wal_dir
        self.snapshot_dir = snapshot_dir
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        self.snapshot_every = snapshot_every
        self.compact_threshold = compact_threshold
        self.compact_check_every = compact_check_every
        self.snapshot_keep = snapshot_keep
        self._lock = threading.RLock()
        self._suspend = 0            # >0: inside a replay or an internal call
        self._mutations = 0          # bumped under _lock by every logged op
        self._writers: dict[int, wal.WalWriter] = {}
        self._next_lsn = 0
        self._last_lsn = -1
        self._ops_since_snapshot = 0
        self._ops_since_compact_check = 0
        self._last_snapshot_ts: Optional[float] = None
        self._replayed_ops = 0
        #: seconds of the last snapshot written: device-to-host and write
        self.snapshot_timings: dict = {}
        #: seconds of the last recovery: read, to_device, replay
        self.recovery_timings: dict = {}

    @contextmanager
    def _nolog(self):
        self._suspend += 1
        try:
            yield
        finally:
            self._suspend -= 1

    @property
    def _logging(self) -> bool:
        return self._suspend == 0

    def _writer(self, shard: int) -> wal.WalWriter:
        if shard not in self._writers:
            self._writers[shard] = wal.writer_for(
                self.wal_dir, shard, fsync=self.fsync,
                segment_bytes=self.segment_bytes)
        return self._writers[shard]

    def _append(self, shard: int, kind: int, arrays: dict) -> int:
        lsn = self._writer(shard).append(kind, arrays, lsn=self._next_lsn)
        self._next_lsn = lsn + 1
        self._last_lsn = lsn
        return lsn

    # -- policy ---------------------------------------------------------------
    def _after_ops(self, n: int) -> None:
        if not self._logging:
            return
        self._ops_since_snapshot += n
        self._ops_since_compact_check += n
        # The drift metric re-encodes the whole store (O(corpus)), so it is
        # only recomputed every compact_check_every ops — and only when a
        # recycled (dirty+active) slot exists, the sole place drift can live.
        if (self.compact_threshold is not None
                and self._ops_since_compact_check >= self.compact_check_every):
            self._ops_since_compact_check = 0
            st = self.state
            if bool(torch.any(st.dirty & st.active)):
                drift = self.slot_drift()
                if float(drift.max()) > self.compact_threshold:
                    self.compact()
        if (self.snapshot_every is not None and self.snapshot_dir
                and self._ops_since_snapshot >= self.snapshot_every):
            self.snapshot()

    # -- snapshot / compaction ------------------------------------------------
    def snapshot(self) -> str:
        """Write a full snapshot and prune WAL segments it covers.

        Safe to call while a ``QueryServer`` is serving: searches never take
        the op lock; the lock only orders the snapshot against concurrent
        mutations so (state, id↔slot map, free list, LSN) stay consistent.
        """
        if not self.snapshot_dir:
            raise ValueError("index was opened without a snapshot_dir")
        t0 = time.perf_counter()
        with self._lock:
            ms = snaplib.latest_manifest(self.snapshot_dir)
            extra = None if ms is None else ms[0]["extra"]
            skipped = (extra is not None and snaplib.matches_layout(extra, self)
                       and int(extra["wal_lsn"]) == self._last_lsn)
            if skipped:
                # State at a given LSN is deterministic, so the on-disk
                # snapshot is already current: rewriting it would briefly
                # unpublish the only recovery base for zero gain.
                path = snaplib.step_path(self.snapshot_dir, ms[1])
            else:
                t_copy = time.perf_counter()
                arrays = convert.state_to_numpy(self.state, self.spec)
                t_write = time.perf_counter()
                path = snaplib.save(self.snapshot_dir, self, self._last_lsn,
                                    keep=self.snapshot_keep, arrays=arrays)
                del arrays
                self.snapshot_timings = {
                    "to_host_s": t_write - t_copy,
                    "write_s": time.perf_counter() - t_write}
            self._ops_since_snapshot = 0
            pruned = wal.prune(self.wal_dir, self._last_lsn)
            # The prune may unlink a writer's open segment; close so the next
            # append rotates to a fresh file instead of a dead inode.
            for w in self._writers.values():
                w.close()
            lsn = self._last_lsn
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._last_snapshot_ts = time.time()
        reg = obs_metrics.get_registry()
        reg.counter("repro_snapshots_total",
                    "Snapshot calls by outcome (written | skipped_current).",
                    labels={"outcome": "skipped_current" if skipped
                            else "written"}).inc()
        reg.histogram("repro_snapshot_ms",
                      "Wall time of snapshot() incl. WAL prune.").observe(dt_ms)
        obs_events.emit("snapshot", path=path, lsn=lsn, ms=round(dt_ms, 3),
                        skipped=skipped, pruned_segments=pruned)
        return path

    def compact(self) -> int:
        """Logged compaction: rebuild dirty sketch columns (see superclass)."""
        with self._lock:
            if not int(self.state.dirty.sum()):
                return 0
            if self._logging:
                self._append(0, wal.KIND_COMPACT, {})
            self._mutations += 1
            with self._nolog():
                return super().compact()

    def try_compact_async(self) -> Optional[int]:
        """Optimistic compaction for a background thread.

        Re-encodes the dirty columns from the store into new tensors with
        no lock held, then writes them in only if no logged op ran
        meanwhile (otherwise returns None and the caller retries later).
        The KIND_COMPACT record is appended at the write-in, so replay
        rebuilds at the same position in the op stream.
        """
        with self._lock:
            mark = self._mutations
            st, spec = self.state, self.spec
        n_dirty = int(st.dirty.sum())
        if not n_dirty:
            return 0
        fresh = eng.fresh_cells(st, spec)
        # Failpoint: stall widens the optimistic-race window (a mutation
        # lands first and the swap is skipped); error models the rebuild
        # itself failing and takes the compactor's error path.
        _fp.fire("compact.swap")
        with self._lock:
            if self._mutations != mark:
                return None
            if self._logging:
                self._append(0, wal.KIND_COMPACT, {})
            self._mutations += 1
            with self._state_lock.write():
                eng.apply_compaction(self.state, fresh)
        return n_dirty

    # -- recovery -------------------------------------------------------------
    def _recover(self, restore_fn) -> None:
        """Open flow: latest snapshot (if any) + WAL tail replay.

        ``restore_fn(arrays, extra) -> (wal_lsn, rebased)`` fills the index
        from the restored snapshot parts; ``rebased`` means the restore was
        elastic (a sharded-kind snapshot), in which case a fresh snapshot
        is written so later recoveries skip the rebuild.
        """
        t0 = time.perf_counter()
        snap_lsn = -1
        rebased = False
        ms = None
        timings = {"read_s": 0.0, "to_device_s": 0.0}
        if self.snapshot_dir:
            # Recovery owns the dir at this point (nothing serves yet), so
            # crash-stranded resaves can safely be promoted back.
            snaplib.adopt_strays(self.snapshot_dir)
            ms = snaplib.latest_manifest(self.snapshot_dir)
        if ms is not None:
            if snaplib.matches_layout(ms[0]["extra"], self):
                # A same-layout restore replaces the state wholesale: free
                # the constructor's fresh tensors BEFORE materialising the
                # snapshot so recovery never holds two full copies.  (An
                # elastic restore re-inserts into the fresh state, so it
                # must stay.)
                self.state = None
            t = time.perf_counter()
            arrays, extra = snaplib.restore_parts(self.snapshot_dir, ms)
            timings["read_s"] = time.perf_counter() - t
            t = time.perf_counter()
            with self._nolog():     # elastic re-inserts must not re-log
                snap_lsn, rebased = restore_fn(arrays, extra)
            del arrays
            _sync(self.device)
            timings["to_device_s"] = time.perf_counter() - t
        t = time.perf_counter()
        horizon = self._replay(snap_lsn)
        _sync(self.device)
        timings["replay_s"] = time.perf_counter() - t
        timings["replayed_ops"] = self._replayed_ops
        self.recovery_timings = timings
        dt_ms = (time.perf_counter() - t0) * 1e3
        reg = obs_metrics.get_registry()
        reg.counter("repro_recoveries_total", "Open-with-recovery calls.").inc()
        reg.gauge("repro_recovery_replay_ms",
                  "Wall time of the last recovery (restore + replay).",
                  ).set(dt_ms)
        reg.gauge("repro_recovery_replayed_ops",
                  "WAL records replayed by the last recovery.",
                  ).set(self._replayed_ops)
        obs_events.emit("recovery", snapshot_lsn=snap_lsn, horizon=horizon,
                        replayed=self._replayed_ops, rebased=rebased,
                        ms=round(dt_ms, 3))
        if rebased:
            self.snapshot()

    def _replay(self, after_lsn: int) -> int:
        """Apply the WAL tail (> after_lsn); returns the replay horizon.

        One scan serves replay, the orphan check and the repair decision;
        repair itself (which must re-read files to rewrite them) only runs
        when there is actually a torn tail or an orphan to drop.
        """
        merged, torn = wal.scan_all(self.wal_dir)
        ops = wal.gap_free_ops(merged, after_lsn)
        horizon = after_lsn
        self._replayed_ops = len(ops)
        with self._nolog():
            for lsn, kind, arrays in ops:
                self._apply_op(kind, arrays)
                horizon = lsn
        # Records beyond the horizon that repair would drop: a torn final
        # batch reaches at most one-batch past the horizon (one record per
        # partition).  Anything further means the replay base itself is
        # wrong — typically a WAL pruned against a snapshot this open()
        # wasn't given — and "repairing" would silently destroy
        # acknowledged data.
        orphans = [lsn for lsn, _, _ in merged if lsn > horizon]
        max_batch = max(len(wal.partitions(self.wal_dir)), 1)
        if orphans and orphans[-1] > horizon + max_batch:
            raise RuntimeError(
                f"{self.wal_dir}: WAL records at LSNs {orphans[:3]}"
                f"{'...' if len(orphans) > 3 else ''} are unreachable from "
                f"recovery base LSN {after_lsn} — this is not a torn batch "
                f"tail (wrong or missing snapshot_dir?); refusing to repair")
        if torn or orphans:
            wal.repair(self.wal_dir, horizon)
        self._next_lsn = horizon + 1
        self._last_lsn = horizon
        return horizon

    def _apply_op(self, kind: int, arrays: dict) -> None:
        if kind == wal.KIND_INSERT:
            self.insert_many([int(e) for e in arrays["ext_ids"]],
                             arrays["idx"], arrays["val"])
        elif kind == wal.KIND_INSERT_ONE:
            self.insert(int(arrays["ext_ids"][0]), arrays["idx"][0],
                        arrays["val"][0])
        elif kind == wal.KIND_DELETE:
            self._apply_delete([int(e) for e in arrays["ext_ids"]])
        elif kind == wal.KIND_GROW:
            try:
                self.grow(int(arrays["capacity"]))
            except ValueError:
                # Cross-layout elastic replay: the logged capacity was for a
                # different layout (e.g. per-shard local).  Skipping is safe:
                # grow never changes content, and auto-grow covers need.
                pass
        elif kind == wal.KIND_COMPACT:
            self.compact()
        else:
            raise ValueError(f"unknown WAL record kind {kind}")


class DurableSinnamonIndex(_DurableOps, eng.SinnamonIndex):
    """Single-device streaming index with WAL + snapshot durability.

    Same surface as :class:`repro_torch.core.engine.SinnamonIndex`; every
    mutation is validated, logged (fsync'd) and only then applied, so
    :meth:`open`-after-crash reproduces the pre-crash state bit for bit.
    Update batches may be CUDA tensors: each is copied to the host (and
    the copy finished) before its record is appended, and the logged host
    arrays are what the index applies, as replay will.
    """

    def __init__(self, spec: eng.EngineSpec, *, wal_dir: str,
                 snapshot_dir: Optional[str] = None, fsync: bool = True,
                 segment_bytes: int = 4 << 20,
                 snapshot_every: Optional[int] = None,
                 compact_threshold: Optional[float] = None,
                 compact_check_every: int = 64,
                 snapshot_keep: int = 3, device=None):
        eng.SinnamonIndex.__init__(self, spec, device=device)
        self._init_durable(wal_dir=wal_dir, snapshot_dir=snapshot_dir,
                           fsync=fsync, segment_bytes=segment_bytes,
                           snapshot_every=snapshot_every,
                           compact_threshold=compact_threshold,
                           compact_check_every=compact_check_every,
                           snapshot_keep=snapshot_keep)

    @classmethod
    def open(cls, spec: eng.EngineSpec, *, wal_dir: str,
             snapshot_dir: Optional[str] = None, device=None,
             **kw) -> "DurableSinnamonIndex":
        """Open-or-recover on ``device`` (None: the CUDA card): fresh if
        no durable data exists, otherwise latest snapshot + WAL tail
        replay (torn tails repaired)."""
        index = cls(spec, wal_dir=wal_dir, snapshot_dir=snapshot_dir,
                    device=device, **kw)
        index._recover(lambda arrays, extra: (
            snaplib.apply_single(index, arrays, extra),
            extra["kind"] != "single"))             # cross-layout elastic
        return index

    # -- logged mutations -----------------------------------------------------
    # Every op validates BEFORE appending to the WAL: a record is only
    # written for an op that will succeed, so a caller-handled error (bad id,
    # bad capacity, wrong width) can never leave a poison record that breaks
    # every future replay.

    def insert(self, ext_id: int, idx, val) -> None:
        with self._lock:
            pi, pv = eng.pad_sparse(idx, val, self.spec.max_nnz)
            if self._logging:
                self._append(0, wal.KIND_INSERT_ONE, {
                    "ext_ids": np.asarray([ext_id], np.int64),
                    "idx": pi[None], "val": pv[None]})
            self._mutations += 1
            with self._nolog():
                super().insert(ext_id, pi, pv)
            self._after_ops(1)

    def insert_many(self, ext_ids, idx_batch, val_batch) -> None:
        with self._lock:
            ext_ids = ext_ids.tolist() if isinstance(ext_ids, torch.Tensor) \
                else [int(e) for e in ext_ids]
            idx_batch = _host(idx_batch, np.int32)
            val_batch = _host(val_batch, np.float32)
            if idx_batch.shape[1] != self.spec.max_nnz:
                raise ValueError(f"batch nnz width {idx_batch.shape[1]} != "
                                 f"max_nnz {self.spec.max_nnz}")
            if not (len(ext_ids) == idx_batch.shape[0] == val_batch.shape[0]):
                raise ValueError(
                    f"batch length mismatch: {len(ext_ids)} ids vs "
                    f"{idx_batch.shape[0]} idx rows / "
                    f"{val_batch.shape[0]} val rows")
            if self._logging:
                self._append(0, wal.KIND_INSERT, {
                    "ext_ids": np.asarray(ext_ids, np.int64),
                    "idx": idx_batch, "val": val_batch})
            self._mutations += 1
            with self._nolog():
                super().insert_many(ext_ids, idx_batch, val_batch)
            self._after_ops(len(ext_ids))

    def delete(self, ext_id: int) -> None:
        with self._lock:
            if ext_id not in self._id2slot:
                raise KeyError(f"unknown document id: {ext_id}")
            if self._logging:
                self._append(0, wal.KIND_DELETE, {
                    "ext_ids": np.asarray([ext_id], np.int64)})
            self._mutations += 1
            with self._nolog():
                super().delete(ext_id)
            self._after_ops(1)

    def delete_many(self, ext_ids) -> None:
        """Logged :meth:`SinnamonIndex.delete_many`: one KIND_DELETE record
        holding every id (a repeated id is one deletion, deduplicated
        before logging so no record can fail on replay)."""
        with self._lock:
            ext_ids = list(dict.fromkeys(int(e) for e in ext_ids))
            missing = [e for e in ext_ids if e not in self._id2slot]
            if missing:
                raise KeyError(f"unknown document ids: {missing[:5]}")
            if not ext_ids:
                return
            if self._logging:
                self._append(0, wal.KIND_DELETE, {
                    "ext_ids": np.asarray(ext_ids, np.int64)})
            self._mutations += 1
            with self._nolog():
                super().delete_many(ext_ids)
            self._after_ops(len(ext_ids))

    def _apply_delete(self, ext_ids) -> None:
        self.delete_many(ext_ids)

    def grow(self, new_capacity: int) -> None:
        with self._lock:
            if new_capacity <= self.spec.capacity or new_capacity % 32 != 0:
                raise ValueError("new capacity must be a larger multiple of 32")
            if self._logging:
                self._append(0, wal.KIND_GROW, {
                    "capacity": np.asarray(new_capacity, np.int64)})
            self._mutations += 1
            super().grow(new_capacity)
