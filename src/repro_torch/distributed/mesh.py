"""Shard placement: which device each corpus shard lives on.

The counterpart of ``repro.distributed.mesh``, reduced to what a list of
shard devices needs.  The reference lays its corpus shards over the mesh's
``(pod, model)`` axes; the port has no mesh axes, only a device per shard,
and several shards may share one device (the H100 the port is measured on
holds four).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

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
