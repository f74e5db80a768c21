"""Carry a reference index's state into the port.

The JAX index's state leaves come in as numpy arrays (``np.asarray`` of
each leaf) and become the port's tensors bit for bit:

* uint32 bitmap words become int32 by ``.view``;
* packed ``uint32[C, 2]`` (lo, hi) external ids become int64;
* bf16 and f8 cells (numpy extension dtypes) go through their int16 /
  uint8 bit views into torch ``bfloat16`` / ``float8_e4m3fn``;
* ``u`` and ``l`` are stacked into the port's ``[U; L]`` sketch.

With the free list and the id map, :meth:`SinnamonIndex.from_numpy` then
searches the same state the JAX index holds.

:func:`state_to_numpy` is the exact inverse: the port's state as the
reference's snapshot leaves (``.mappings``, ``.u``, ``.l``, ``.bits``,
``.store/.indices``, ``.store/.values``, ``.active``, ``.ids``, ``.dirty``,
the keys ``repro.checkpoint.ckpt`` writes), which is what
:mod:`repro_torch.persist.snapshot` stores.  :func:`state_from_numpy` reads
either key form.

:func:`recsys_params_from_numpy` carries a reference DLRM parameter tree
the same way into a :class:`repro_torch.models.recsys.DLRM`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import RAW_DTYPES
from repro_torch.core import engine as eng
from repro_torch.core import sketch
from repro_torch.storage import vecstore

#: Leaf names ``state_from_numpy`` reads (``l`` may be None).
LEAVES = ("mappings", "u", "l", "bits", "store_indices", "store_values",
          "active", "ids", "dirty")

#: Each leaf's key in a reference snapshot (the JAX state's tree paths).
SNAPSHOT_KEYS = {"mappings": ".mappings", "u": ".u", "l": ".l",
                 "bits": ".bits", "store_indices": ".store/.indices",
                 "store_values": ".store/.values", "active": ".active",
                 "ids": ".ids", "dirty": ".dirty"}

_BIT_VIEW = {1: np.uint8, 2: np.int16, 4: np.int32}


def cells_from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A numpy cell array (float32, or a 1/2-byte float of any numpy
    extension type) as a torch tensor of ``dtype``, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.itemsize != torch.empty((), dtype=dtype).element_size():
        raise ValueError(f"{arr.dtype} cannot hold {dtype} cells")
    bits = torch.from_numpy(arr.view(_BIT_VIEW[arr.dtype.itemsize]).copy())
    return bits.view(dtype)


def ids_from_packed(packed: np.ndarray) -> np.ndarray:
    """uint32[..., 2] (lo, hi) words -> int64[...]."""
    p = np.asarray(packed, np.uint32).astype(np.uint64)
    return (p[..., 0] | (p[..., 1] << np.uint64(32))).view(np.int64)


def ids_to_packed(ids) -> np.ndarray:
    """int64[...] -> uint32[..., 2] (lo, hi) words (the reference's
    ``engine.pack_ids64``)."""
    u = np.asarray(ids, np.int64).view(np.uint64)
    return np.stack([u & np.uint64(0xFFFFFFFF), u >> np.uint64(32)],
                    axis=-1).astype(np.uint32)


def cells_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array, bit for bit: float32 and integer
    tensors as they are, bf16 / f8 cells (dtypes numpy lacks) as their raw
    uint16 / uint8 bit patterns, through torch's own ``.view``."""
    name = str(t.dtype).removeprefix("torch.")
    if name in RAW_DTYPES:
        return sketch.cell_bits(t).cpu().numpy().view(RAW_DTYPES[name])
    return t.cpu().numpy()


def leaf_dtypes(spec: eng.EngineSpec) -> dict:
    """The true dtype name of every snapshot leaf of a ``spec`` state, as
    the reference's manifest records it (``"bfloat16"`` for a bf16 leaf
    that the npz holds as uint16)."""
    out = {".mappings": "int32", ".u": spec.dtype, ".l": spec.dtype,
           ".bits": "uint32", ".store/.indices": "int32",
           ".store/.values": str(spec.value_tdtype).removeprefix("torch."),
           ".active": "bool", ".ids": "uint32", ".dirty": "bool"}
    if spec.upper_only:
        del out[".l"]
    return out


def state_to_numpy(state: eng.SinnamonState, spec: eng.EngineSpec) -> dict:
    """The reference's snapshot leaves of the port's ``state``, as host
    numpy arrays keyed as in :data:`SNAPSHOT_KEYS` (no ``.l`` without a
    lower sketch); the exact inverse of :func:`state_from_numpy`.

    ``u`` and ``l`` are split out of the stacked sketch, bitmap words are
    viewed as uint32, ids packed into uint32 (lo, hi) pairs, and bf16 / f8
    cells are their raw uint16 / uint8 bits (:func:`leaf_dtypes` names
    their true dtypes).  On a CUDA state each leaf is one device-to-host
    copy.
    """
    out = {".mappings": cells_to_numpy(state.mappings),
           ".u": cells_to_numpy(state.u)}
    if state.l is not None:
        out[".l"] = cells_to_numpy(state.l)
    out[".bits"] = cells_to_numpy(state.bits).view(np.uint32)
    out[".store/.indices"] = cells_to_numpy(state.store.indices)
    out[".store/.values"] = cells_to_numpy(state.store.values)
    out[".active"] = cells_to_numpy(state.active)
    out[".ids"] = ids_to_packed(cells_to_numpy(state.ids))
    out[".dirty"] = cells_to_numpy(state.dirty)
    return out


def _on(arr, dtype, device: torch.device) -> torch.Tensor:
    """Host array ``arr`` as ``dtype`` on ``device``, in memory of its own
    (the index writes its tensors in place); a host copy is made only where
    the device copy alone would not give that."""
    a = np.asarray(arr, dtype)
    if device.type == "cpu" or not (a.flags.writeable
                                    and a.flags.c_contiguous):
        a = a.copy()
    return torch.from_numpy(a).to(device)


def state_from_numpy(leaves: dict, spec: eng.EngineSpec,
                     device=None) -> eng.SinnamonState:
    """The port's state from the reference's state leaves (keyed by
    :data:`LEAVES` or by their :data:`SNAPSHOT_KEYS`), on ``device``
    (None: the CUDA card)."""
    device = eng.resolve_device(device)
    if ".u" in leaves:
        leaves = {name: leaves.get(key) for name, key in SNAPSHOT_KEYS.items()}
    cell = sketch.torch_cell_dtype(spec.dtype)
    u = cells_from_numpy(leaves["u"], cell)
    parts = [u] if leaves.get("l") is None \
        else [u, cells_from_numpy(leaves["l"], cell)]
    sk = torch.cat([sketch.cell_bits(p) for p in parts]).to(device)
    values = np.asarray(leaves["store_values"])
    if spec.value_tdtype == torch.float32:
        vals = _on(values, np.float32, device)
    else:
        vals = cells_from_numpy(values, spec.value_tdtype).to(device)
    bits = np.asarray(leaves["bits"], np.uint32).view(np.int32)
    return eng.SinnamonState(
        mappings=_on(leaves["mappings"], np.int32, device),
        sketch=sk.view(cell),
        bits=_on(bits, np.int32, device),
        store=vecstore.VecStore(
            indices=_on(leaves["store_indices"], np.int32, device),
            values=vals),
        active=_on(leaves["active"], bool, device),
        ids=_on(ids_from_packed(leaves["ids"]), np.int64, device),
        dirty=_on(leaves["dirty"], bool, device),
        m=spec.m,
    )


def recsys_params_from_numpy(params: dict, cfg, device=None):
    """A :class:`~repro_torch.models.recsys.DLRM` holding the reference's
    DLRM parameters ``{"tables", "bot": {"w0", "b0", ...}, "top": ...}``
    (numpy arrays, or anything ``np.asarray`` reads), on ``device`` (None:
    the CUDA card).  Tables are copied as they are; each ``w{i}`` [in, out]
    becomes the transposed ``nn.Linear.weight`` [out, in]."""
    from repro_torch.models import recsys
    model = recsys.DLRM(cfg, device=device, draw=False)
    dtype = model.tables.dtype
    leaf = lambda a: cells_from_numpy(np.asarray(a), dtype)  # noqa: E731
    with torch.no_grad():
        model.tables.copy_(leaf(params["tables"]))
        for name in ("bot", "top"):
            for i, lin in enumerate(getattr(model, name)):
                lin.weight.copy_(leaf(params[name][f"w{i}"]).t())
                lin.bias.copy_(leaf(params[name][f"b{i}"]))
    return model
