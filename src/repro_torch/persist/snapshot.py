"""Full-state snapshots of the streaming index (counterpart of
``repro.persist.snapshot``, on disk in its format).

Built on :mod:`repro_torch.checkpoint.ckpt`'s atomic-rename layout (a
preempted save never corrupts the latest snapshot).  The state is stored as
the reference stores its ``SinnamonState`` pytree — the leaves of
:func:`repro_torch.convert.state_to_numpy`, packed uint32 ids and uint32
bitmap words included — and the host-side reconstruction recipe (engine
spec, id↔slot map, free list, WAL position) rides in the manifest's
``extra`` blob.  So a snapshot written by either package restores in the
other, bit for bit.

Two layouts, as in the reference.  A single-device index writes the
``single`` kind; a :class:`~repro_torch.serving.sharded.ShardedSinnamonIndex`
writes the ``sharded`` kind: the global arrays of its ``logical_state()``
(the shards concatenated in order, stored unsharded) with the shard count,
``update_block``, the per-shard free lists and ``id2slot`` as ``[shard,
slot]`` in the recipe.  A snapshot restores onto any layout: the same
layout (and shard count) places the state directly, bit for bit; any other
restores elastically — every live document is re-inserted, in ascending
id order, from its raw VecStore row, which freshens its sketch column.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import bitindex
from repro_torch.core import engine as eng
from repro_torch.fault import failpoints as _fp
from repro_torch.serving.sharded import ShardedSinnamonIndex

# Format history (older formats are refused with an explicit error in
# restore_parts, as the reference refuses them):
#   v1: int32[C] ids leaf (pre packed-int64 ids).
#   v2: ids became packed uint32[C, 2] lo/hi words.
#   v3: spec grew the accuracy levers `sketch_kind` and quantized cell
#       dtypes (f8 sketch cells stored as raw uint8 views).
FORMAT = "sinnamon-snapshot-v3"


def _spec_dict(spec: eng.EngineSpec) -> dict:
    return dataclasses.asdict(spec)


def _spec_from(d: dict) -> eng.EngineSpec:
    return eng.EngineSpec(**d)


def save(snap_dir: str, index, wal_lsn: int, keep: int = 3,
         arrays: Optional[dict] = None) -> str:
    """Snapshot a :class:`~repro_torch.core.engine.SinnamonIndex` or a
    :class:`~repro_torch.serving.sharded.ShardedSinnamonIndex` (durable or
    not); returns the published directory.

    ``wal_lsn`` is the LSN of the last operation reflected in the state;
    recovery replays the WAL strictly after it.  The ckpt step is
    ``wal_lsn + 1`` so newer snapshots sort later.  ``arrays`` are the
    state's leaves when the caller already copied them to the host
    (default: :func:`convert.state_to_numpy` of ``index.state``).
    """
    if arrays is None:
        arrays = convert.state_to_numpy(index.logical_state(), index.spec)
    sharded = isinstance(index, ShardedSinnamonIndex)
    extra = {
        "format": FORMAT,
        "kind": "sharded" if sharded else "single",
        "spec": _spec_dict(index.spec),       # per-shard spec when sharded
        "wal_lsn": int(wal_lsn),
    }
    if sharded:
        extra["n_shards"] = index.n_shards
        extra["update_block"] = index.update_block
        extra["free"] = [list(map(int, f)) for f in index._free]
        extra["id2slot"] = {str(k): [int(v[0]), int(v[1])]
                            for k, v in index._id2slot.items()}
    else:
        extra["free"] = list(map(int, index._free))
        extra["id2slot"] = {str(k): int(v)
                            for k, v in index._id2slot.items()}
    return ckpt.save(snap_dir, int(wal_lsn) + 1, arrays, keep=keep,
                     extra=extra, dtypes=convert.leaf_dtypes(index.spec))


def latest_manifest(snap_dir: str) -> Optional[Tuple[dict, int]]:
    """(manifest, step) of the newest snapshot, or None if there is none."""
    if ckpt.latest_step(snap_dir) is None:
        return None
    return ckpt.read_manifest(snap_dir)


def latest_extra(snap_dir: str) -> Optional[dict]:
    """The newest snapshot's ``extra`` blob, or None if none exists."""
    ms = latest_manifest(snap_dir)
    return None if ms is None else ms[0]["extra"]


def latest_wal_lsn(snap_dir: str) -> Optional[int]:
    """WAL position of the newest snapshot, or None if there is none."""
    extra = latest_extra(snap_dir)
    return None if extra is None else int(extra["wal_lsn"])


def step_path(snap_dir: str, step: int) -> str:
    """Directory of the snapshot published at ``step``."""
    return os.path.join(snap_dir, f"step_{step:010d}")


def adopt_strays(snap_dir: str) -> None:
    """Writer-side crash repair of the snapshot dir (see ckpt.adopt_strays)."""
    ckpt.adopt_strays(snap_dir)


def matches_layout(extra: dict, index) -> bool:
    """Does a snapshot recipe describe ``index``'s layout (kind + shards)?"""
    sharded = isinstance(index, ShardedSinnamonIndex)
    if extra.get("kind") != ("sharded" if sharded else "single"):
        return False
    return not sharded or int(extra["n_shards"]) == index.n_shards


def expected_leaves(spec: eng.EngineSpec) -> dict:
    """{snapshot key: (shape, dtype name)} of a ``spec`` state — the
    restore template (the reference's ``jax.eval_shape(init)``)."""
    C = spec.capacity
    shapes = {".mappings": (spec.h, spec.n), ".u": (spec.m, C),
              ".l": (spec.m, C), ".bits": (spec.bit_rows, C // bitindex.WORD),
              ".store/.indices": (C, spec.max_nnz),
              ".store/.values": (C, spec.max_nnz), ".active": (C,),
              ".ids": (C, 2), ".dirty": (C,)}
    return {k: (shapes[k], dt) for k, dt in convert.leaf_dtypes(spec).items()}


def restore_parts(snap_dir: str,
                  manifest_step: Optional[Tuple[dict, int]] = None
                  ) -> Tuple[dict, dict]:
    """Load (host state leaves, extra recipe) from the newest snapshot.

    Pass a ``latest_manifest`` result as ``manifest_step`` to avoid
    re-reading the manifest.  The leaves are checked against the recipe's
    spec (names, shapes and dtypes) before anything is placed on a device.
    """
    manifest, step = manifest_step or ckpt.read_manifest(snap_dir)
    extra = manifest["extra"]
    if extra.get("format") != FORMAT:
        raise ValueError(
            f"{snap_dir}: snapshot format {extra.get('format')!r} is "
            f"incompatible with {FORMAT} (the state layout changed); "
            f"restore it with the version that wrote it, or re-index")
    spec = _spec_from(extra["spec"])
    if extra["kind"] == "sharded":
        spec = dataclasses.replace(
            spec, capacity=spec.capacity * int(extra["n_shards"]))
    arrays, _, _ = ckpt.restore(snap_dir, expected_leaves(spec), step=step)
    return arrays, extra


def _live_rows(extra) -> dict:
    """ext_id → global VecStore row of every live doc in a snapshot."""
    if extra["kind"] == "sharded":
        local_cap = int(extra["spec"]["capacity"])
        return {int(k): int(v[0]) * local_cap + int(v[1])
                for k, v in extra["id2slot"].items()}
    return {int(k): int(v) for k, v in extra["id2slot"].items()}


def _store_values_f32(arrays: dict, extra: dict) -> np.ndarray:
    """The snapshot's raw values as f32 (exact from bf16 / f8 bits)."""
    values = arrays[".store/.values"]
    vdt = _spec_from(extra["spec"]).value_tdtype
    if values.dtype == np.float32:
        return values
    return convert.cells_from_numpy(values, vdt).float().numpy()


def _reinsert_live(index, arrays, extra) -> int:
    """Elastic restore: re-insert every live doc from its raw VecStore row
    (deterministic ascending-id order; sketch columns come out fresh).
    Returns wal_lsn.
    """
    rows_of = _live_rows(extra)
    # Failpoint: a bad read of the raw VecStore rows during elastic
    # restore — recovery must surface it, never silently re-insert junk.
    _fp.fire("vecstore.read")
    indices = arrays[".store/.indices"]
    values = _store_values_f32(arrays, extra)
    width = index.spec.max_nnz
    if indices.shape[1] > width:
        raise ValueError(f"snapshot max_nnz {indices.shape[1]} > target "
                         f"index max_nnz {width}: would drop coordinates")
    if indices.shape[1] < width:
        pad_i = np.full((indices.shape[0], width), -1, indices.dtype)
        pad_i[:, :indices.shape[1]] = indices
        pad_v = np.zeros((values.shape[0], width), values.dtype)
        pad_v[:, :values.shape[1]] = values
        indices, values = pad_i, pad_v
    ext_ids = sorted(rows_of)
    for lo in range(0, len(ext_ids), 512):
        chunk = ext_ids[lo:lo + 512]
        rows = [rows_of[e] for e in chunk]
        index.insert_many(chunk, indices[rows], values[rows])
    return int(extra["wal_lsn"])


def apply_single(index: eng.SinnamonIndex, arrays: dict, extra: dict) -> int:
    """Fill an existing index from restored parts.  Returns wal_lsn.

    A single-kind snapshot restores bit-identically (every state leaf, the
    slot map and the free-list order) onto the index's device; a
    sharded-kind snapshot restores elastically by re-inserting the live
    docs from the raw store.
    """
    if extra["kind"] != "single":
        return _reinsert_live(index, arrays, extra)
    spec = _spec_from(extra["spec"])
    # a tiered index keeps the raw rows on the host
    store_device = "cpu" if isinstance(index, eng.TieredSinnamonIndex) \
        else None
    with index._state_lock.write():
        index.spec = spec
        index.adopt_logical_state(convert.state_from_numpy(
            arrays, spec, index.device, store_device=store_device))
        index._id2slot = {int(k): int(v) for k, v in extra["id2slot"].items()}
        index._free = [int(s) for s in extra["free"]]
    return int(extra["wal_lsn"])


def apply_sharded(index: ShardedSinnamonIndex, arrays: dict,
                  extra: dict) -> int:
    """Fill an existing sharded index from restored parts.  Returns
    wal_lsn.

    A sharded snapshot with the index's shard count places each shard's
    block of the global arrays on the shard's device (every state leaf, the
    free lists and the slot map bit for bit).  Another shard count, or a
    single-kind snapshot, restores elastically (:func:`_reinsert_live`).
    """
    if (extra["kind"] != "sharded"
            or index.n_shards != int(extra["n_shards"])):
        return _reinsert_live(index, arrays, extra)
    with index._state_lock.write():
        index.spec = _spec_from(extra["spec"])
        index.adopt_leaves(arrays)
        index._free = [[int(s) for s in f] for f in extra["free"]]
        index._id2slot = {int(k): (int(v[0]), int(v[1]))
                          for k, v in extra["id2slot"].items()}
    return int(extra["wal_lsn"])


def load_single(snap_dir: str, device=None) -> Tuple[eng.SinnamonIndex, int]:
    """Rebuild a SinnamonIndex from the newest snapshot on ``device`` (None:
    the CUDA card).  Returns (index, wal_lsn)."""
    arrays, extra = restore_parts(snap_dir)
    spec = _spec_from(extra["spec"])
    if extra["kind"] == "single":
        index = eng.SinnamonIndex.from_numpy(spec, arrays, extra["free"], {
            int(k): int(v) for k, v in extra["id2slot"].items()},
            device=device)
        return index, int(extra["wal_lsn"])
    index = eng.SinnamonIndex(spec, device=device)
    return index, apply_single(index, arrays, extra)


def load_sharded(snap_dir: str, devices=None, *,
                 n_shards: Optional[int] = None
                 ) -> Tuple[ShardedSinnamonIndex, int]:
    """Rebuild a ShardedSinnamonIndex from the newest snapshot onto
    ``devices`` (see ``ShardedSinnamonIndex``; ``n_shards`` None: the
    snapshot's shard count, or one shard per device for a single-kind
    snapshot).  Returns (index, wal_lsn); :func:`apply_sharded` gives the
    elastic semantics.  A single-kind snapshot's spec describes the whole
    corpus and is used as the per-shard spec unchanged, as the reference
    does.
    """
    arrays, extra = restore_parts(snap_dir)
    if n_shards is None and extra["kind"] == "sharded":
        n_shards = int(extra["n_shards"])
    index = ShardedSinnamonIndex(_spec_from(extra["spec"]), devices,
                                 n_shards=n_shards,
                                 update_block=int(extra.get("update_block",
                                                            32)))
    return index, apply_sharded(index, arrays, extra)
