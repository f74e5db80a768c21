"""Meshes and shard placement, as ``repro.distributed.mesh``.

Two forms live here.  The one-process sharded index places its corpus
shards on a list of devices (:func:`shard_devices`); several shards may
share one device (the H100 the port is measured on holds four).  The mesh
helpers (:func:`make_mesh` and the axis helpers) build and read a
``torch.distributed.DeviceMesh`` with the reference's named axes
(``pod``, ``data``, ``model``), over the process group the caller brought
up: the dry run's fake group of 256 or 512 ranks, or a group of one on
the card.  All are functions, never module-level constants, so importing
this module touches no device or process-group state.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def visible_devices() -> list:
    """The visible CUDA devices; raises when there are none (as
    ``engine.resolve_device`` does for one device)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_devices(n_shards: Optional[int] = None,
                  devices: Union[None, DeviceLike,
                                 Sequence[DeviceLike]] = None) -> list:
    """The device of every shard: shard ``s`` on ``devices[s % len]``.

    ``devices`` is None (the visible CUDA devices), one device, or a list;
    ``n_shards`` None means one shard per listed device.
    """
    if devices is None:
        pool = visible_devices()
    elif isinstance(devices, (str, torch.device)):
        pool = [torch.device(devices)]
    else:
        pool = [torch.device(d) for d in devices]
    if not pool:
        raise ValueError("no shard devices given")
    for d in pool:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
    n = len(pool) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    return [pool[s % len(pool)] for s in range(n)]


# ---------------------------------------------------------------------------
# DeviceMesh helpers (the reference's mesh.py)
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with named ``axes`` over the first
    prod(shape) ranks of the default process group, which the caller has
    initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have} (dry-run scripts "
                         "must bring up a process group of that many ranks "
                         "first)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def single_device_mesh(axes: Sequence[str] = ("data", "model"),
                       device_type: str = "cuda"):
    """1x1 mesh — the same code path, no sharding."""
    return make_mesh((1,) * len(axes), axes, device_type)


def _names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def corpus_axes(mesh) -> Tuple[str, ...]:
    """Axes the retrieval corpus (document slots) is sharded over."""
    return tuple(a for a in _names(mesh) if a in ("pod", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the query/train batch is sharded over."""
    return tuple(a for a in _names(mesh) if a == "data")


def _size(mesh, a: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(a))
    return int(mesh.shape[a])


def n_shards(mesh, axes: Sequence[str]) -> int:
    return math.prod(_size(mesh, a) for a in axes)


def linear_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard index over ``axes``, major-to-minor in the order
    given, matching how a spec with ``axes`` as one tuple entry lays
    contiguous blocks over the mesh: shard ``i`` owns block ``i``."""
    coord = mesh.get_coordinate()
    names = _names(mesh)
    i = 0
    for ax in axes:
        i = i * _size(mesh, ax) + coord[names.index(ax)]
    return i


def named(mesh, *spec) -> tuple:
    """DTensor placements of the spec ``spec`` on ``mesh``."""
    from repro_torch.distributed import rules as R

    return R.placements_for(mesh, tuple(spec))
