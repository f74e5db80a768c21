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

A reference *sharded* state is one global state whose slot axes run over
the shards in order (shard s owns slots ``[s·cap, (s+1)·cap)``).
:func:`split_leaves` cuts its leaves into per-shard leaves and
:func:`sharded_states_from_numpy` places each shard on its device; the way
back is ``ShardedSinnamonIndex.logical_state()`` (the shards concatenated
in order) through :func:`state_to_numpy`.

:func:`recsys_params_from_numpy` carries a reference recsys parameter tree
(DLRM, DIN, SASRec or MIND) the same way into the port's model, and
:func:`recsys_params_to_numpy` is its inverse; :func:`lm_params_from_numpy`
and :func:`lm_params_to_numpy` do the same for an LM's tree.
:func:`train_state_to_numpy` flattens a ``repro_torch.train.loop.TrainState`` to the leaves a JAX
``TrainState`` checkpoint holds (``.params/<path>``, ``.opt/.m/<path>``,
``.opt/.v/<path>``, ``.opt/.step``), and :func:`train_state_from_numpy`
loads such leaves, written by either package, back in place.
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
                     device=None, store_device=None) -> eng.SinnamonState:
    """The port's state from the reference's state leaves (keyed by
    :data:`LEAVES` or by their :data:`SNAPSHOT_KEYS`), on ``device``
    (None: the CUDA card); the raw store on ``store_device`` (None: on
    ``device``; the tiered index keeps it on the host)."""
    device = eng.resolve_device(device)
    sdev = device if store_device is None else torch.device(store_device)
    if ".u" in leaves:
        leaves = {name: leaves.get(key) for name, key in SNAPSHOT_KEYS.items()}
    cell = sketch.torch_cell_dtype(spec.dtype)
    u = cells_from_numpy(leaves["u"], cell)
    parts = [u] if leaves.get("l") is None \
        else [u, cells_from_numpy(leaves["l"], cell)]
    sk = torch.cat([sketch.cell_bits(p) for p in parts]).to(device)
    values = np.asarray(leaves["store_values"])
    if spec.value_tdtype == torch.float32:
        vals = _on(values, np.float32, sdev)
    else:
        vals = cells_from_numpy(values, spec.value_tdtype).to(sdev)
    bits = np.asarray(leaves["bits"], np.uint32).view(np.int32)
    return eng.SinnamonState(
        mappings=_on(leaves["mappings"], np.int32, device),
        sketch=sk.view(cell),
        bits=_on(bits, np.int32, device),
        store=vecstore.VecStore(
            indices=_on(leaves["store_indices"], np.int32, sdev),
            values=vals),
        active=_on(leaves["active"], bool, device),
        ids=_on(ids_from_packed(leaves["ids"]), np.int64, device),
        dirty=_on(leaves["dirty"], bool, device),
        m=spec.m,
    )


#: The axis of each snapshot leaf that runs over slots (None: the leaf is
#: the same on every shard).  Bitmap words hold 32 slots each.
SLOT_AXES = {".mappings": None, ".u": 1, ".l": 1, ".bits": 1,
             ".store/.indices": 0, ".store/.values": 0, ".active": 0,
             ".ids": 0, ".dirty": 0}


def split_leaves(leaves: dict, n_shards: int) -> list:
    """A global state's snapshot leaves (keyed as :data:`SNAPSHOT_KEYS`)
    cut into ``n_shards`` per-shard leaf dicts, shard s holding the s-th
    equal block of every slot axis (:data:`SLOT_AXES`).  The blocks are
    views where numpy can give them."""
    out = [{} for _ in range(n_shards)]
    for key, arr in leaves.items():
        ax = SLOT_AXES[key]
        parts = [arr] * n_shards if ax is None or arr is None \
            else np.split(np.asarray(arr), n_shards, axis=ax)
        for s in range(n_shards):
            out[s][key] = parts[s]
    return out


def sharded_states_from_numpy(leaves: dict, spec: eng.EngineSpec, devices,
                              store_device=None) -> list:
    """Per-shard port states of a reference sharded state's global leaves:
    shard s (``spec`` is the per-shard spec) on ``devices[s]``, its raw
    store on ``store_device`` (None: with the shard)."""
    return [state_from_numpy(lv, spec, dev, store_device=store_device)
            for lv, dev in zip(split_leaves(leaves, len(devices)), devices)]


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """A nested dict as {"a/b": leaf}, the reference's leaf paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    """{"a/b": leaf} as a nested dict (the inverse of
    :func:`flatten_tree`)."""
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _load(dst: dict, src: dict, what: str) -> None:
    """Copy host arrays ``src`` into the tensors ``dst`` (same keys and
    shapes) bit for bit; a raw-bits array becomes the tensor's dtype."""
    if set(dst) != set(src):
        raise ValueError(f"{what}: leaves {sorted(src)} != the model's "
                         f"{sorted(dst)}")
    with torch.no_grad():
        for k, t in dst.items():
            a = np.asarray(src[k])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{what} {k}: {a.shape} != the model's "
                                 f"{tuple(t.shape)}")
            if t.dtype.is_floating_point:
                t.copy_(cells_from_numpy(a, t.dtype).reshape(t.shape))
            else:
                t.copy_(torch.from_numpy(np.array(a, order="C")))


def recsys_params_from_numpy(params: dict, cfg, device=None):
    """The port's ``cfg.model`` model (:mod:`repro_torch.models.recsys`)
    holding the reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` reads), on ``device`` (None: the CUDA card).  Leaves are
    copied as they are; DLRM's ``w{i}`` [in, out] becomes the transposed
    ``nn.Linear.weight`` [out, in]."""
    from repro_torch.models import recsys
    if cfg.model not in recsys.MODELS:
        raise ValueError(f"unknown recsys model {cfg.model!r}")
    model = recsys.MODELS[cfg.model](cfg, device=device, draw=False)
    _load(model.leaves(), flatten_tree(params), cfg.model)
    return model


def _host(t: torch.Tensor) -> np.ndarray:
    """A C-ordered host copy of ``t`` (raw bits for bf16 / f8), which no
    later in-place update of ``t`` changes."""
    return np.array(cells_to_numpy(t.detach()), order="C", copy=True)


def recsys_params_to_numpy(model) -> dict:
    """The reference's parameter tree of a port model (recsys, LM or GNN), as
    nested dicts of host numpy arrays (bf16 leaves as their raw uint16
    bits); the inverse of :func:`recsys_params_from_numpy`,
    :func:`lm_params_from_numpy` and :func:`gnn_params_from_numpy`."""
    return unflatten_tree({k: _host(t) for k, t in model.leaves().items()})


def lm_params_from_numpy(params: dict, cfg, device=None):
    """The port's :class:`repro_torch.models.transformer.TransformerLM`
    holding the reference's LM parameter tree (``embed``, ``layers/...``,
    ``ln_f``, ``unembed``; numpy arrays, or anything ``np.asarray``
    reads) bit for bit, on ``device`` (None: the CUDA card).  The model's
    dtype is the leaves': bfloat16 for 2-byte leaves (ml_dtypes' bfloat16
    or raw uint16 bits), float32 otherwise."""
    from repro_torch.models import transformer
    flat = flatten_tree(params)
    wide = np.asarray(flat["embed"]).dtype.itemsize
    dtype = {2: torch.bfloat16, 4: torch.float32}[wide]
    model = transformer.TransformerLM(cfg, dtype=dtype, device=device,
                                      draw=False)
    _load(model.leaves(), flat, cfg.name)
    return model


#: An LM's parameter tree: the same flattening of ``leaves()``.
lm_params_to_numpy = recsys_params_to_numpy


def gnn_params_from_numpy(params: dict, cfg, device=None):
    """The port's :class:`repro_torch.models.gnn.EquiformerV2` holding the
    reference's GNN parameter tree (``embed_in``, ``layers/...``, ``ro1``,
    ``ro2``, ``force_w``; numpy arrays, or anything ``np.asarray`` reads)
    bit for bit, on ``device`` (None: the CUDA card), in the leaves' dtype
    (bfloat16 for 2-byte leaves, float32 otherwise)."""
    from repro_torch.models import gnn
    flat = flatten_tree(params)
    wide = np.asarray(flat["embed_in"]).dtype.itemsize
    dtype = {2: torch.bfloat16, 4: torch.float32}[wide]
    model = gnn.EquiformerV2(cfg, dtype=dtype, device=device, draw=False)
    _load(model.leaves(), flat, cfg.name)
    return model


#: A GNN's parameter tree: the same flattening of ``leaves()``.
gnn_params_to_numpy = recsys_params_to_numpy


def _state_leaves(state) -> dict:
    """{checkpoint key: tensor} of a TrainState, as the reference names
    its leaves."""
    out = {f".params/{k}": t for k, t in state.params.leaves().items()}
    out.update({f".opt/.m/{k}": t for k, t in state.opt.m.items()})
    out.update({f".opt/.v/{k}": t for k, t in state.opt.v.items()})
    out[".opt/.step"] = state.opt.step
    if state.ef_residual is not None:
        out.update({f".ef_residual/{k}": t
                    for k, t in state.ef_residual.items()})
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def train_state_to_numpy(state):
    """(arrays, dtypes) of a TrainState for ``checkpoint.ckpt.save``: host
    numpy arrays under the reference's keys (``.params/<path>``,
    ``.opt/.m/<path>``, ``.opt/.v/<path>``, ``.opt/.step``; no leaf for
    ``ef_residual=None``), and the true dtype of each leaf stored as raw
    bits."""
    arrays, dtypes = {}, {}
    for k, t in _state_leaves(state).items():
        arrays[k] = _host(t)
        if _dtype_name(t) in RAW_DTYPES:
            dtypes[k] = _dtype_name(t)
    return arrays, dtypes


def train_state_expect(state) -> dict:
    """{key: (shape, dtype name)} of a TrainState's checkpoint leaves, the
    ``expect`` of ``checkpoint.ckpt.restore``."""
    return {k: (tuple(t.shape), _dtype_name(t))
            for k, t in _state_leaves(state).items()}


def train_state_from_numpy(arrays: dict, state):
    """Load a train-state checkpoint's leaves (either package's) into
    ``state``'s tensors in place; returns ``state``."""
    _load(_state_leaves(state), arrays, "train state")
    return state
