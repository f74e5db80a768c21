"""Append-only write-ahead log of streaming index operations.

A copy of ``repro.persist.wal`` (numpy records, this package's obs and
fault): the two packages write and read the same segments.

Layout: ``<wal_dir>/<partition>/wal-<first_lsn:016d>.seg`` — one partition per
shard (``shard-000`` … ; a single-device index uses just ``shard-000``), each
a sequence of fixed-header records:

    magic u32 | lsn u64 | kind u8 | pad x3 | payload_len u32 | crc u32
    payload   (np.savez bytes: the op's numpy record batch)

The CRC covers the header fields (magic, lsn, kind, payload_len) AND the
payload, so a flipped bit anywhere in a record — including its lsn or kind —
makes the record undecodable instead of replaying garbage.

LSNs are assigned from ONE global counter across partitions, so the merged
log totally orders every operation.  Each append is flushed (and fsync'd by
default) before the in-memory index mutates — a crash can lose at most the
torn tail of the record being written.

Replay semantics (``read_ops``): scan every partition (a torn/corrupt record
hides only the rest of its own segment; later segments stay visible), merge
by LSN, and apply only the gap-free prefix — with per-record fsync a torn
record is necessarily the globally last write, so the prefix is exactly
"everything that was acknowledged".  Records that survive past a gap are
*orphans*: the replay layer refuses to proceed unless they fit a torn final
batch (see ``durable._replay``).  ``repair`` truncates torn tails and drops
beyond-horizon segments so the writer can resume cleanly.
"""

from __future__ import annotations

import errno
import io
import os
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fault import failpoints as _fp
from repro_torch.fault.retry import RetryPolicy, call_with_retry, fsync_transient
from repro_torch.obs import metrics as obs_metrics

MAGIC = 0x57414C31                       # "WAL1"
_HEADER = struct.Struct("<IQB3xII")      # magic, lsn, kind, pad, len, crc
_CRC_OFF = _HEADER.size - 4              # crc is the header's last field

KIND_INSERT = 1        # batch insert        (ext_ids, idx, val)
KIND_INSERT_ONE = 2    # single-doc insert   (ext_ids[1], idx[1], val[1])
KIND_DELETE = 3        # batch delete        (ext_ids)
KIND_GROW = 4          # explicit capacity growth (capacity; per-shard local)
KIND_COMPACT = 5       # sketch compaction point (empty payload)

KIND_NAMES = {KIND_INSERT: "insert", KIND_INSERT_ONE: "insert_one",
              KIND_DELETE: "delete", KIND_GROW: "grow",
              KIND_COMPACT: "compact"}


def partition_name(shard: int) -> str:
    return f"shard-{shard:03d}"


def _fsync_dir(path: str) -> None:
    """Durably persist directory entries (new/renamed/removed files)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _encode_payload(arrays: Dict[str, np.ndarray]) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _decode_payload(payload: bytes) -> Dict[str, np.ndarray]:
    if not payload:
        return {}
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def _pack_record(lsn: int, kind: int, payload: bytes) -> bytes:
    hdr = _HEADER.pack(MAGIC, lsn, kind, len(payload), 0)[:_CRC_OFF]
    crc = zlib.crc32(payload, zlib.crc32(hdr)) & 0xFFFFFFFF
    return hdr + struct.pack("<I", crc) + payload


#: Default fsync retry budget: a couple of quick backoffs for pure
#: interruptions (EINTR/EAGAIN — see ``fsync_transient``), bounded well
#: under a request deadline.  EIO and ENOSPC are never retried at the
#: durability barrier: after a failed fsync the kernel may have marked
#: the dirty pages clean (fsyncgate), so a retried "success" proves
#: nothing about the bytes on disk — the append unwinds instead.
FSYNC_RETRY = RetryPolicy(attempts=3, base_delay_s=0.005,
                          max_delay_s=0.05, deadline_s=0.25)


class WalWriter:
    """Appends records to one partition directory (one shard's log).

    Failpoint sites (docs/robustness.md): ``wal.write`` fires before the
    record bytes are written (``torn`` mode writes a prefix of the record
    then raises EIO — the torn-tail crash); ``wal.fsync`` fires inside
    the fsync, which is retried per ``fsync_retry`` for interruptions
    (EINTR/EAGAIN) only — an fsync EIO/ENOSPC is fatal: the append
    unwinds and the segment is abandoned (fsyncgate: a post-failure
    fsync on the same fd can report durability that never happened).
    """

    def __init__(self, part_dir: str, *, fsync: bool = True,
                 segment_bytes: int = 4 << 20, next_lsn: int = 0,
                 fsync_retry: Optional[RetryPolicy] = None):
        self.part_dir = part_dir
        self.fsync = fsync
        self.segment_bytes = segment_bytes
        self.next_lsn = next_lsn          # used when the caller doesn't pass one
        self.fsync_retry = fsync_retry or FSYNC_RETRY
        os.makedirs(part_dir, exist_ok=True)
        if fsync:
            _fsync_dir(os.path.dirname(part_dir.rstrip(os.sep)) or ".")
        self._f = None
        self._last_append: Optional[int] = None
        self._obs_registry = None

    def _obs(self):
        """WAL metric handles, bound lazily against the current global
        registry (revalidated so `set_registry` in tests takes effect)."""
        reg = obs_metrics.get_registry()
        if reg is not self._obs_registry:
            self._obs_append_ms = reg.histogram(
                "repro_wal_append_ms", "One WAL record append, fsync included.")
            self._obs_fsync_ms = reg.histogram(
                "repro_wal_fsync_ms", "fsync portion of a WAL append.")
            self._obs_bytes = reg.counter(
                "repro_wal_appended_bytes_total", "Record bytes appended.")
            self._obs_records = {
                name: reg.counter("repro_wal_records_total",
                                  "WAL records appended by kind.",
                                  labels={"kind": name})
                for name in KIND_NAMES.values()}
            self._obs_rotations = reg.counter(
                "repro_wal_segment_rotations_total", "Segment files opened.")
            self._obs_errors = reg.counter(
                "repro_wal_append_errors_total", "Failed (unwound) appends.")
            self._obs_registry = reg
        return self

    def _rotate(self, first_lsn: int) -> None:
        self._last_append = None
        if self._f is not None:
            self._f.close()
        path = os.path.join(self.part_dir, f"wal-{first_lsn:016d}.seg")
        self._f = open(path, "ab")
        self._obs()._obs_rotations.inc()
        if self.fsync:
            # Persist the directory entry too: an fsync'd record in a file
            # whose entry was lost to a power cut is a lost record.
            _fsync_dir(self.part_dir)

    def append(self, kind: int, arrays: Dict[str, np.ndarray],
               lsn: Optional[int] = None) -> int:
        t0 = time.perf_counter()
        lsn = self.next_lsn if lsn is None else lsn
        payload = _encode_payload(arrays) if arrays else b""
        if self._f is None or self._f.tell() >= self.segment_bytes:
            self._rotate(lsn)
        start = self._f.tell()
        record = _pack_record(lsn, kind, payload)
        obs = self._obs()
        try:
            act = _fp.fire("wal.write")
            if act is not None and act.mode == "torn":
                # Model a mid-write crash: a prefix of the record reaches
                # the file, then the write "fails".  The unwind below must
                # erase it; replay must never decode it.
                self._f.write(record[:max(1, int(len(record) * act.arg))])
                self._f.flush()
                raise _fp.InjectedError(
                    errno.EIO, "injected torn write at wal.write")
            self._f.write(record)
            self._f.flush()
        except OSError:
            # Roll the partial bytes back: garbage mid-segment would hide
            # every later acknowledged record in this segment from replay.
            obs._obs_errors.inc()
            self._unwind(start)
            raise
        if self.fsync:
            t_sync = time.perf_counter()
            try:
                call_with_retry(self._do_fsync, policy=self.fsync_retry,
                                should_retry=fsync_transient,
                                op="wal.fsync")
            except OSError:
                # The durability barrier itself failed.  fsyncgate: the
                # kernel may now consider the dirty pages clean, so neither
                # a retried fsync nor any later one on this fd can be
                # trusted to have persisted the record.  Unwind the bytes
                # and abandon the segment — the next append lands on a
                # fresh file whose first fsync tells the truth.
                obs._obs_errors.inc()
                self._unwind(start)
                if self._f is not None:
                    try:
                        self._f.close()
                    except OSError:
                        pass
                    self._f = None
                raise
            obs._obs_fsync_ms.observe((time.perf_counter() - t_sync) * 1e3)
        self.next_lsn = lsn + 1
        self._last_append = start
        obs._obs_append_ms.observe((time.perf_counter() - t0) * 1e3)
        obs._obs_bytes.inc(len(record))
        counter = obs._obs_records.get(KIND_NAMES.get(kind, ""))
        if counter is not None:
            counter.inc()
        return lsn

    def _do_fsync(self) -> None:
        _fp.fire("wal.fsync")
        os.fsync(self._f.fileno())

    def _unwind(self, start: int) -> None:
        try:
            self._f.truncate(start)
            # truncate() does not move the stream position, and the file is
            # in append mode so writes still land correctly — but tell()
            # (used for the NEXT append's unwind start and the rotation
            # check) would stay past the new end, making a later unwind
            # truncate short and strand garbage.  Re-sync it.
            self._f.seek(start)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError:
            # Disk too broken even to truncate: abandon the segment so the
            # next append (if any succeeds) lands in a fresh file AFTER the
            # garbage, where the scanner can still reach it.
            self._f.close()
            self._f = None

    def unappend(self) -> None:
        """Roll back the most recent successful append (best effort).

        Used to keep a multi-record batch all-or-nothing ON DISK when a
        later record of the same batch fails to append: the durable subset
        would otherwise pin stale LSNs that collide with the next op.
        """
        if self._f is not None and self._last_append is not None:
            self._unwind(self._last_append)
            self._last_append = None

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# ---------------------------------------------------------------------------
# Reading / replay
# ---------------------------------------------------------------------------

def _segments(part_dir: str) -> List[str]:
    if not os.path.isdir(part_dir):
        return []
    return sorted(n for n in os.listdir(part_dir)
                  if n.startswith("wal-") and n.endswith(".seg"))


def _scan_segment(path: str) -> Tuple[List[Tuple[int, int, bytes]], int, bool]:
    """Parse one segment file.

    Returns (records [(lsn, kind, payload)], clean_byte_len, torn) where
    ``torn`` means trailing bytes past ``clean_byte_len`` failed the
    magic/length/CRC check (truncated or corrupt tail).
    """
    with open(path, "rb") as f:
        buf = f.read()
    records, off = [], 0
    while off + _HEADER.size <= len(buf):
        magic, lsn, kind, plen, crc = _HEADER.unpack_from(buf, off)
        end = off + _HEADER.size + plen
        if magic != MAGIC or end > len(buf):
            break
        payload = buf[off + _HEADER.size:end]
        hdr_crc = zlib.crc32(buf[off:off + _CRC_OFF])
        if zlib.crc32(payload, hdr_crc) & 0xFFFFFFFF != crc:
            break
        records.append((lsn, kind, bytes(payload)))
        off = end
    return records, off, off < len(buf)


def scan_partition(part_dir: str) -> Tuple[List[Tuple[int, int, bytes]], bool]:
    """All decodable records of one partition.

    A torn/corrupt record hides the rest of ITS segment (there is no way to
    find the next record boundary in the same file), but later segments
    start at a known boundary and ARE still scanned: their records must stay
    visible so the replay orphan guard can refuse to repair over acknowledged
    data (a mid-stream corruption must never silently delete the segments
    after it).  The LSN gap rule keeps any post-corruption record out of the
    replayed stream regardless.
    """
    records: List[Tuple[int, int, bytes]] = []
    torn_any = False
    for name in _segments(part_dir):
        recs, _, torn = _scan_segment(os.path.join(part_dir, name))
        records.extend(recs)
        torn_any = torn_any or torn
    return records, torn_any


def scan_all(wal_dir: str) -> Tuple[List[Tuple[int, int, bytes]], bool]:
    """One pass over every partition: (merged decodable records sorted by
    LSN, whether any partition has a torn tail).  The raw-record form lets a
    caller derive the gap-free stream AND the orphan set from a single scan
    (see :func:`gap_free_ops` / ``durable._replay``)."""
    merged: List[Tuple[int, int, bytes]] = []
    torn_any = False
    for part in partitions(wal_dir):
        recs, torn = scan_partition(os.path.join(wal_dir, part))
        merged.extend(recs)
        torn_any = torn_any or torn
    merged.sort(key=lambda r: r[0])
    return merged, torn_any


def gap_free_ops(merged: List[Tuple[int, int, bytes]], after_lsn: int = -1
                 ) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """Decode the gap-free op stream out of :func:`scan_all`'s records.

    Keeps only records with ``lsn > after_lsn`` and stops at the first
    missing LSN — a gap means a mid-stream record was lost (torn tail), so
    later records (which the live process applied *after* the lost one) are
    discarded for consistency.
    """
    out = []
    # A snapshot at L means ops <= L were applied, so the tail must start at
    # exactly L+1.  With no snapshot the stream must start at LSN 0: pruning
    # only ever runs after a snapshot, so a WAL whose head is missing is
    # unrecoverable without that snapshot — and a multi-shard batch whose
    # lowest-LSN record was lost to a torn tail (records are appended in
    # descending-LSN order) must be discarded whole, never applied partially.
    expect = after_lsn + 1
    for lsn, kind, payload in merged:
        if lsn <= after_lsn:
            continue
        if lsn != expect:
            break
        expect = lsn + 1
        out.append((lsn, kind, _decode_payload(payload)))
    return out


def read_ops(wal_dir: str, after_lsn: int = -1
             ) -> List[Tuple[int, int, Dict[str, np.ndarray]]]:
    """Merged, gap-free op stream across all partitions (single scan)."""
    merged, _ = scan_all(wal_dir)
    return gap_free_ops(merged, after_lsn)


def partitions(wal_dir: str) -> List[str]:
    if not os.path.isdir(wal_dir):
        return []
    return sorted(n for n in os.listdir(wal_dir)
                  if n.startswith("shard-")
                  and os.path.isdir(os.path.join(wal_dir, n)))


def last_lsn(wal_dir: str) -> int:
    """Highest LSN in the gap-free merged stream (-1 if empty)."""
    ops = read_ops(wal_dir)
    return ops[-1][0] if ops else -1


def orphan_lsns(wal_dir: str, horizon_lsn: int) -> List[int]:
    """LSNs of decodable records beyond a replay horizon, sorted.

    Non-empty means the gap-free stream could not reach these records.  The
    only legitimate cause is a torn multi-shard batch (at most one record per
    shard, LSNs within one batch of the horizon); anything further out means
    the replay base is wrong — e.g. the WAL was pruned against a snapshot the
    caller no longer has — and repair would destroy acknowledged data.
    """
    merged, _ = scan_all(wal_dir)
    return [lsn for lsn, _, _ in merged if lsn > horizon_lsn]


def repair(wal_dir: str, horizon_lsn: int) -> None:
    """Make the on-disk log consistent with a replay horizon.

    Truncates torn segment tails and removes any record/segment beyond
    ``horizon_lsn`` so a resuming writer (next_lsn = horizon+1) never
    collides with stale bytes.
    """
    for part in partitions(wal_dir):
        pdir = os.path.join(wal_dir, part)
        changed = False
        for name in _segments(pdir):
            path = os.path.join(pdir, name)
            recs, clean_len, torn = _scan_segment(path)
            keep = [r for r in recs if r[0] <= horizon_lsn]
            if len(keep) == len(recs):
                if torn:
                    with open(path, "r+b") as f:
                        f.truncate(clean_len)
                        f.flush()
                        os.fsync(f.fileno())
                continue
            if not keep:
                os.remove(path)
                changed = True
                continue
            # Rewrite via temp + atomic rename: a crash mid-repair must not
            # destroy records that were acknowledged in the original run.
            buf = b"".join(_pack_record(lsn, kind, payload)
                           for lsn, kind, payload in keep)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            changed = True
        if changed:
            _fsync_dir(pdir)


def prune(wal_dir: str, upto_lsn: int) -> int:
    """Drop whole segments whose every record is covered by a snapshot at
    ``upto_lsn``.  Returns the number of segments removed."""
    removed = 0
    for part in partitions(wal_dir):
        pdir = os.path.join(wal_dir, part)
        n = 0
        for name in _segments(pdir):
            path = os.path.join(pdir, name)
            recs, _, torn = _scan_segment(path)
            if not torn and recs and recs[-1][0] <= upto_lsn:
                os.remove(path)
                n += 1
        if n:
            _fsync_dir(pdir)
        removed += n
    return removed


def writer_for(wal_dir: str, shard: int, *, fsync: bool = True,
               segment_bytes: int = 4 << 20, next_lsn: int = 0) -> WalWriter:
    return WalWriter(os.path.join(wal_dir, partition_name(shard)),
                     fsync=fsync, segment_bytes=segment_bytes,
                     next_lsn=next_lsn)
