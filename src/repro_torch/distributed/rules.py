"""Logical-axis sharding rules with divisibility fallback, as
``repro.distributed.rules``, mapped onto DTensor placements.

Models annotate every tensor dimension with a *logical* axis name; a rule
table maps each logical axis to an ordered list of candidate mesh-axis
tuples.  :func:`spec_for` picks, per dimension, the first candidate whose
mesh axes (a) are all unused so far in this spec and (b) have a product
that divides the dimension; otherwise the dimension is replicated.  This is
what lets every (architecture × shape × mesh) cell place: deepseek's 8 KV
heads cannot split over model=16, so the decode cache falls through to its
next rule (shard the KV *sequence* axis).

A spec is a plain tuple with one entry per leading dimension (``None``, an
axis name, or a tuple of names, trailing ``None``s trimmed), so it compares
directly with ``tuple(PartitionSpec)``.  :func:`placements_for` turns it
into one DTensor placement per mesh dimension: an axis a tensor dimension
takes is ``Shard(dim)``, every other axis ``Replicate()``.  A dimension
that takes several axes (``("pod", "data")``) lays its blocks out
major-to-minor over them, as a ``PartitionSpec`` does; DTensor shards a
dimension over several mesh dimensions in mesh order (the earlier mesh
dimension major), so the tuple must list its axes in mesh order, which
every rule does (:func:`placements_for` raises otherwise).

Every function takes anything with ``axis_names`` and ``shape[name]`` (a
mesh-shaped object without devices, as the reference's tests use) or a
``torch.distributed.DeviceMesh``; only :func:`constrain` and
:func:`placements_for` need the latter.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


AxisCandidates = Sequence[Tuple[str, ...]]
Rules = Dict[str, AxisCandidates]

# Candidates are tried in order.  () entries are implicit — a miss replicates.
TRAIN_RULES: Rules = {
    # activations
    "batch":    [("pod", "data"), ("data",)],
    "seq":      [],
    # Megatron-style sequence parallelism for the residual stream: the layer
    # carry is seq-sharded over 'model'; attention/MLP constraints re-shard
    # to heads/mlp.
    "act_seq":  [("model",)],
    "embed":    [],
    "heads":    [("model",)],
    "kv_heads": [("model",)],
    "kv_seq":   [("pod", "data", "model"), ("data", "model"), ("model",)],
    "mlp":      [("model",)],
    "vocab":    [("model",)],
    "expert":   [("model",)],
    "cap":      [],
    "group":    [("pod", "data"), ("data",)],
    # weights: fan-in dims get ZeRO/FSDP-style sharding over the data axes
    "fsdp":     [("data",), ("pod",)],
    # graph: node tensors are replicated on the node axis and sharded over
    # 'model' on the channel axis; edges shard over the data axes.
    "nodes":    [],
    "edges":    [("pod", "data"), ("data",)],
    "gnn_c":    [("model",)],
    "feat":     [],
    "coef":     [],
    # recsys
    "table_rows": [("pod", "model"), ("model",)],
    "fields":   [],
    "candidates": [("pod", "model"), ("model",)],
    # retrieval engine
    "slots":    [("pod", "model"), ("model",)],
    "slot_words": [("pod", "model"), ("model",)],
    "sketch_rows": [],
    "dim":      [],
}

# Serving differs only in how the (smaller) batch is placed.
SERVE_RULES: Rules = dict(TRAIN_RULES)

Spec = Tuple


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (``mesh_dim_names`` of a DeviceMesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None and not hasattr(mesh, "axis_names"):
        raise ValueError("a DeviceMesh needs mesh_dim_names")
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(name))
    return int(mesh.shape[name])


def mesh_size(mesh) -> int:
    """Devices in the mesh; 1 for ``None``."""
    if mesh is None:
        return 1
    return math.prod(axis_size(mesh, a) for a in axis_names(mesh))


def local_shape_of(x: torch.Tensor) -> torch.Size:
    """The shape of this device's block of ``x`` (a DTensor's local
    tensor), or ``x``'s shape for a plain tensor."""
    return getattr(x, "_local_tensor", x).shape


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def spec_for(mesh, shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> Spec:
    """The spec of ``shape`` given per-dimension logical axis names."""
    rules = rules if rules is not None else TRAIN_RULES
    names = axis_names(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        placed = None
        if name is not None:
            for cand in rules.get(name, []):
                cand = tuple(a for a in cand if a in names)
                if not cand or any(a in used for a in cand):
                    continue
                if dim % _axes_size(mesh, cand) == 0 and dim > 0:
                    placed = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        out.append(placed)
    while out and out[-1] is None:          # canonical form
        out.pop()
    return tuple(out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(mesh, spec: Spec) -> tuple:
    """One DTensor placement per mesh dimension for ``spec``: ``Shard(d)``
    on the axes tensor dimension d takes, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of dimension {d} are not in the "
                             f"mesh's order {names}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def local_shape(mesh, shape: Sequence[int], spec: Spec) -> tuple:
    """Each device's block of ``shape`` under ``spec`` (every placed
    dimension divides evenly, by :func:`spec_for`)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axes_size(mesh, _entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {entry}")
        out[d] //= n
    return tuple(out)


def block_offsets(mesh, shape: Sequence[int], spec: Spec,
                  coord: Sequence[int]) -> tuple:
    """The offset of the block of the device at mesh coordinate ``coord``
    in every dimension, as a ``PartitionSpec`` lays blocks out: over a
    tuple of axes, the block index is major-to-minor in the tuple's
    order."""
    names = axis_names(mesh)
    loc = local_shape(mesh, shape, spec)
    out = [0] * len(shape)
    for d, entry in enumerate(spec):
        i = 0
        for a in _entry_axes(entry):
            i = i * axis_size(mesh, a) + coord[names.index(a)]
        out[d] = i * loc[d]
    return tuple(out)


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending partial sums reduced (each ``Partial``
    mesh dimension made ``Replicate``); anything else as it is.  An
    embedding of a row-sharded table is such a partial, and DTensor keeps
    the mask of its rows only until the first reduction, so a gather that
    is read more than once settles first."""
    pl = getattr(x, "placements", None)
    if pl is None or not any(p.is_partial() for p in pl):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in pl))


def gathered(w: torch.Tensor, mesh, logical: Sequence[Optional[str]],
             rules: Optional[Rules] = None) -> torch.Tensor:
    """A weight at its use: constrained with its ``fsdp``
    dimensions whole (ZeRO-3 / FSDP: all-gathered over the data axes, its
    gradient reduce-scattered back in the backward)."""
    return constrain(w, mesh, tuple(None if a == "fsdp" else a
                                    for a in logical), rules)


class L:
    """Logical-axes annotation for one tensor (an opaque tree *leaf*)."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __repr__(self):
        return f"L{self.axes}"


def sharding_for(mesh, shape, logical, rules=None) -> tuple:
    """DTensor placements of ``shape`` on ``mesh`` by logical names."""
    return placements_for(mesh, spec_for(mesh, shape, logical, rules))


def tree_sharding(mesh, abstract_tree: dict, logical_tree: dict,
                  rules=None) -> dict:
    """{leaf path: placements} for matching {leaf path: tensor or shape}
    and {leaf path: :class:`L`} dicts (see :func:`flat_axes`)."""
    out = {}
    for k, ab in abstract_tree.items():
        shape = ab.shape if hasattr(ab, "shape") else tuple(ab)
        out[k] = sharding_for(mesh, shape, logical_tree[k].axes, rules)
    return out


def flat_axes(tree, prefix: str = "") -> dict:
    """{``a/b`` leaf path: :class:`L`} of a nested dict of ``L`` (a
    family's ``logical_axes``), in the reference's tree order (sorted keys
    at each level, as JAX flattens a dict)."""
    if isinstance(tree, L):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat_axes(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def constrain(x: torch.Tensor, mesh, logical: Sequence[Optional[str]],
              rules: Optional[Rules] = None) -> torch.Tensor:
    """Re-place a DTensor by logical axis names: ``x.redistribute`` to the
    spec's placements (its gradient is placed alike in the backward).
    ``x`` itself, unchanged, when ``mesh`` is None or of one device, or
    when ``x`` is not a DTensor (a single-device run)."""
    if mesh_size(mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    # redistributed even where the placements already agree: the gradient
    # then takes the same placement in the backward, as the reference's
    # constraint pins the cotangent too
    return x.redistribute(x.device_mesh,
                          sharding_for(mesh, x.shape, logical, rules))
