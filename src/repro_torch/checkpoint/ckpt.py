"""Checkpoints of flat array dicts, on disk as the reference writes them.

Counterpart of ``repro.checkpoint.ckpt`` with the same layout, so either
package reads what the other wrote::

    <dir>/step_<N:010d>/arrays.npz + manifest.json

A save stages ``step_<N>.tmp``, makes it durable and publishes it with an
atomic rename (a preempted save never corrupts the latest checkpoint).
The manifest names every leaf with its shape and its *true* dtype; numpy's
npz cannot hold bfloat16 or float8_e4m3fn, so such leaves are stored as
their raw uint16 / uint8 bits and the manifest says ``"bfloat16"`` /
``"float8_e4m3fn"`` (``repro_torch.convert.cells_to_numpy`` makes those
bits with torch's own ``.view``).

Where the reference flattens a JAX pytree, this module works on a flat
``{key: np.ndarray}`` whose keys are the reference's leaf paths (for the
index state, ``repro_torch.convert.state_to_numpy``'s), with a
``{key: dtype name}`` dict for the leaves held as raw bits.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

from repro_torch.fault import failpoints as _fp

#: true dtype -> the numpy dtype of the raw bits the npz stores
RAW_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8}


def _fsync(path: str) -> None:
    """Durably persist a file's contents or a directory's entries.

    Callers that delete their redundancy once a checkpoint exists (the
    retrieval WAL is pruned against snapshots) need the publish itself to
    survive a power cut, not just a process crash.
    """
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str, step: int, arrays: dict, keep: int = 3,
         extra: Optional[dict] = None, dtypes: Optional[dict] = None) -> str:
    """Write ``arrays`` ({key: np.ndarray}) as checkpoint ``step``; returns
    its directory.  ``dtypes`` gives the true dtype of leaves stored as raw
    bits (see :data:`RAW_DTYPES`); every other leaf's is its numpy dtype."""
    dtypes = dtypes or {}
    for key, name in dtypes.items():
        if name in RAW_DTYPES and key in arrays \
                and arrays[key].dtype != RAW_DTYPES[name]:
            raise ValueError(f"{key}: a {name} leaf is stored as "
                             f"{np.dtype(RAW_DTYPES[name])} bits, got "
                             f"{arrays[key].dtype}")
    os.makedirs(ckpt_dir, exist_ok=True)
    adopt_strays(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # Failpoint sites model a save dying at each distinct hazard: while
    # writing array bytes, while making them durable, and at the publish
    # rename.  All three strand only .tmp/.old debris that the next
    # save/adopt_strays clears — never the published step.
    _fp.fire("snapshot.write")
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape),
                       "dtype": dtypes.get(k, v.dtype.name)}
                   for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    _fp.fire("snapshot.fsync")
    for name in ("arrays.npz", "manifest.json"):
        _fsync(os.path.join(tmp, name))
    _fsync(tmp)
    _fp.fire("snapshot.rename")
    if os.path.exists(final):
        # Never delete the published step before its replacement is in
        # place: rename it aside, publish, then drop the old copy — so the
        # window in which no valid copy exists shrinks from a full rmtree
        # to the instant between two renames.
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
        os.rename(tmp, final)                   # atomic publish
        shutil.rmtree(old)
    else:
        os.rename(tmp, final)                   # atomic publish
    _fsync(ckpt_dir)      # persist the rename: the publish must survive a
    _gc(ckpt_dir, keep)   # power cut, not just a process crash
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def adopt_strays(ckpt_dir: str) -> None:
    """Recover from a save() that crashed between its two swap renames.

    Such a crash strands the previously published (complete, valid) copy at
    ``step_<N>.old`` with ``step_<N>`` gone: promote it back so the step
    stays recoverable.  With ``step_<N>`` present the ``.old`` copy is
    superseded leftovers and is removed.  Only the directory's writer (a
    fresh save, or recovery before any reads) may call this — a reader
    doing it would race a concurrent save's swap.
    """
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if (name.startswith("step_") and name.endswith(".old")
                and name[5:-4].isdigit()):
            stray = os.path.join(ckpt_dir, name)
            final = os.path.join(ckpt_dir, name[:-4])
            try:
                if os.path.exists(final):
                    shutil.rmtree(stray)
                else:
                    os.rename(stray, final)
            except OSError:
                pass                           # read-only fs etc.


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        # digits-only filter also skips in-flight .tmp / .old dirs
        if name.startswith("step_") and name[5:].isdigit():
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None):
    """Peek at a checkpoint's manifest without materialising arrays.
    Returns (manifest dict, step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f), step


def restore(ckpt_dir: str, expect: Optional[dict] = None,
            step: Optional[int] = None):
    """Read checkpoint ``step`` (default: the newest) as host arrays.

    ``expect`` ({key: (shape, true dtype name)}) plays the reference's
    template: the checkpoint must hold exactly those leaves with those
    shapes and dtypes, or this raises ``ValueError``.  Leaves of a
    :data:`RAW_DTYPES` dtype come back as their raw bits.  Returns
    (arrays, step, extra).
    """
    manifest, step = read_manifest(ckpt_dir, step)
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves = manifest["leaves"]
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    for key, arr in arrays.items():
        name = leaves.get(key, {}).get("dtype", arr.dtype.name)
        raw = RAW_DTYPES.get(name)
        if (arr.dtype != raw) if raw is not None else (arr.dtype.name != name):
            raise ValueError(f"{key}: stored as {arr.dtype}, manifest says "
                             f"{name}")
    if expect is not None:
        if set(expect) != set(arrays):
            raise ValueError(f"checkpoint leaves {sorted(arrays)} != "
                             f"expected {sorted(expect)}")
        for key, (shape, name) in expect.items():
            got = (tuple(arrays[key].shape),
                   leaves.get(key, {}).get("dtype", arrays[key].dtype.name))
            if got != (tuple(shape), name):
                raise ValueError(f"{key}: checkpoint {got} != model "
                                 f"{(tuple(shape), name)}")
    return arrays, step, manifest.get("extra", {})
