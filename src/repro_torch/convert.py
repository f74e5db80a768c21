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

:func:`recsys_params_from_numpy` carries a reference DLRM parameter tree
the same way into a :class:`repro_torch.models.recsys.DLRM`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import sketch
from repro_torch.storage import vecstore

#: Leaf names ``state_from_numpy`` reads (``l`` may be None).
LEAVES = ("mappings", "u", "l", "bits", "store_indices", "store_values",
          "active", "ids", "dirty")

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


def state_from_numpy(leaves: dict, spec: eng.EngineSpec,
                     device=None) -> eng.SinnamonState:
    """The port's state from the reference's state leaves (see
    :data:`LEAVES`), on ``device`` (None: the CUDA card)."""
    device = eng.resolve_device(device)
    cell = sketch.torch_cell_dtype(spec.dtype)
    u = cells_from_numpy(leaves["u"], cell)
    parts = [u] if leaves.get("l") is None \
        else [u, cells_from_numpy(leaves["l"], cell)]
    sk = torch.cat([sketch.cell_bits(p) for p in parts]).to(device)
    values = np.asarray(leaves["store_values"])
    if spec.value_tdtype == torch.float32:
        vals = torch.from_numpy(np.asarray(values, np.float32).copy())
    else:
        vals = cells_from_numpy(values, spec.value_tdtype)
    bits = np.ascontiguousarray(np.asarray(leaves["bits"], np.uint32))
    return eng.SinnamonState(
        mappings=torch.from_numpy(np.asarray(leaves["mappings"], np.int32)
                                  .copy()).to(device),
        sketch=sk.view(cell),
        bits=torch.from_numpy(bits.view(np.int32).copy()).to(device),
        store=vecstore.VecStore(
            indices=torch.from_numpy(np.asarray(leaves["store_indices"],
                                                np.int32).copy()).to(device),
            values=vals.to(device)),
        active=torch.from_numpy(np.asarray(leaves["active"], bool)
                                .copy()).to(device),
        ids=torch.from_numpy(ids_from_packed(leaves["ids"]).copy()
                             ).to(device),
        dirty=torch.from_numpy(np.asarray(leaves["dirty"], bool)
                               .copy()).to(device),
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
