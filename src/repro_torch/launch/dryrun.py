"""Multi-pod dry run, as ``repro.launch.dryrun``: every (architecture ×
input shape) cell placed on the production mesh — 16×16 = 256 devices
single-pod and 2×16×16 = 512 devices multi-pod — with bytes, FLOPs and
collectives per device and H100 roofline terms.

The reference lowers and compiles each step with XLA over 512 forced host
devices and reads its memory and cost analyses and the collectives of the
optimised HLO.  Torch has no SPMD compiler, so the port runs the step
itself on DTensors in one process:

* a fake process group of the mesh's size (``FakeStore``: collectives
  return at once) and the production ``DeviceMesh`` on the CPU;
* ``FakeTensorMode``: every local shard is a fake tensor, so nothing is
  allocated or computed, whatever the shapes;
* the cell's inputs placed by the logical-axis rules
  (``repro_torch.launch.cells``), the step run eagerly: DTensor's sharding
  propagation inserts the collectives a placement needs, and the models'
  ``rules.constrain`` calls pin the reference's placements;
* a dispatch mode under DTensor that sees each device's ops on its local
  shards, and ``CommDebugMode`` above it.

What each result's figures mean:

``arg_bytes``            the local shards of every input (state, batch,
                         cache): exact, from the placements.
``temp_bytes``           the peak, over the step, of the bytes of local
                         storages the step allocated and still holds (a
                         tally of live storages: each output storage counts
                         from its creation until Python frees it).  Eager
                         peaks are not XLA's buffer assignment: no fusion,
                         and a temporary lives until its last reference.
``bytes_per_device``     ``arg_bytes + temp_bytes``.
``hlo_flops_per_device`` FLOPs of the local ops (``torch.utils.flop_counter``
                         formulas on local shapes: matmuls, convolutions,
                         attention; elementwise ops count 0, as there).
``flops_f32``            the part of them whose operands are f32 (or f64).
``hlo_bytes_per_device`` bytes read and written by the local ops that
                         move data (inputs + outputs; views move none): an
                         unfused upper bound of HBM traffic.
``collectives``          count and result bytes per kind of the
                         collectives DTensor issued, per device; the counts
                         are ``CommDebugMode``'s.
``t_compute``, ``t_memory``, ``t_collective``  the three roofline terms
                         with the H100 constants below (``t_compute`` takes
                         f32 FLOPs at the f32 peak, TF32 off, and the rest
                         at the bf16 peak); ``bottleneck`` the largest.
``useful_flops_frac``    ``model_flops / (hlo_flops_per_device · devices)``.

The collectives are what DTensor's sharding propagation issues for these
placements, not what GSPMD would; their counts are not the reference's.

Depth.  Eager dispatch costs per op, so an LM or GNN cell is traced at 1
and 2 layers (and, for interleaved local:global attention, at 1 layer of
each window kind) and every per-device figure is extrapolated linearly to
full depth; the result says so (``depth``).  (A GNN layer walks its edge
chunks four times: ``ogb_products`` on 16×16 takes about 76 s a traced
layer on one CPU core.)  Argument bytes, FLOPs and
collectives are linear in depth, and the suite checks the extrapolation
against a full-depth run; the temporary peak is extrapolated the same way
and is an estimate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b \\
        --shape train_4k [--multi-pod | --both-meshes] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        [--include-extra]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import threading
import time
import traceback
import weakref
from typing import Optional

import torch

from repro_torch.configs import registry
from repro_torch.launch import cells
from repro_torch.launch.mesh import production_shape

# H100 SXM constants (per device) for the roofline terms.
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s
PEAK_FLOPS_F32 = 67e12       # f32 FLOP/s (TF32 off)
HBM_BW = 3.35e12             # bytes/s
# Each 16-wide axis spans more than one 8-GPU node, so a collective crosses
# the network: NDR InfiniBand, 400 Gb/s = 50 GB/s a GPU.
NET_BW = 50e9                # bytes/s/device

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_COLL = {"all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "all-gather"}


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0),
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


_PROP = threading.local()


def _marked(inner, real: bool = False):
    """``inner`` with the tally's flag set (and, with ``real``, with the
    fake mode lifted: the function computes with small index tensors)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def call(*a, **k):
        prev = getattr(_PROP, "on", False)
        _PROP.on = True
        try:
            with (unset_fake_temporarily() if real
                  else contextlib.nullcontext()):
                return inner(*a, **k)
        finally:
            _PROP.on = prev

    return call


@contextlib.contextmanager
def _mark_propagation():
    """Flag the ops DTensor runs for its own bookkeeping, so the tally
    leaves them out: the sharding propagation's shape inference on global
    shapes, and the block arithmetic of strided shards (which indexes with
    real tensors, so it runs outside the fake mode)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    prop = DTensor._op_dispatcher.sharding_propagator
    prop._propagate_tensor_meta_non_cached = _marked(
        prop._propagate_tensor_meta_non_cached)
    strided = _StridedShard.local_shard_size_and_offset
    _StridedShard.local_shard_size_and_offset = _marked(strided, real=True)
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached
        _StridedShard.local_shard_size_and_offset = strided


def _tensors(tree):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local_leaves(tree) -> list:
    """Every tensor in a tree of dicts, tuples, NamedTuples, modules and
    DTensors, as local tensors."""
    out = []

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, torch.Tensor):
            out.append(getattr(x, "_local_tensor", x))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def compute_time(fig: dict) -> float:
    """Seconds of ``fig``'s FLOPs at the H100's peaks: f32 operands at
    :data:`PEAK_FLOPS_F32`, the rest at :data:`PEAK_FLOPS`."""
    f32 = fig["flops_f32"]
    return (fig["flops"] - f32) / PEAK_FLOPS + f32 / PEAK_FLOPS_F32


class Tally(torch.utils._python_dispatch.TorchDispatchMode):
    """Each device's FLOPs, bytes moved, collectives and live temporary
    bytes, from the ops on local shards (DTensor ops pass through to
    DTensor, whose local ops come back here)."""

    def __init__(self, known_storages=()):
        super().__init__()
        self.flops = 0
        self.flops_f32 = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.coll = {k: 0 for k in KINDS}
        self.coll_count = {k: 0 for k in KINDS}
        self._known = {id(s) for s in known_storages}
        self._seen: set = set()

    def _freed(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROP, "on", False):
            return out
        ins = _tensors((args, kwargs))
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = False
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in in_st or key in self._known or key in self._seen:
                continue
            fresh = True
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)
        pk = func._overloadpacket
        if fresh or func._schema.is_mutable:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in _tensors(out))
        if pk in flop_registry:
            n = int(flop_registry[pk](*args, **kwargs, out_val=out))
            self.flops += n
            if any(t.dtype in (torch.float32, torch.float64) for t in ins):
                self.flops_f32 += n
        kind = _COLL.get(pk.__name__) if pk._qualified_op_name.startswith(
            "_c10d_functional::") else None
        if kind is not None:
            self.coll[kind] += sum(_nbytes(t) for t in _tensors(out))
            self.coll_count[kind] += 1
        return out


def measure(fn, args) -> dict:
    """Run ``fn(*args)`` once under the tally and ``CommDebugMode``."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    arg_locals = _local_leaves(args)
    known = [t.untyped_storage() for t in arg_locals]
    tally = Tally(known)
    with _mark_propagation(), CommDebugMode() as comm, tally, \
            implicit_replication():
        out = fn(*args)
        del out
    counts = {k: 0 for k in KINDS}
    for op, n in comm.get_comm_counts().items():
        kind = _COLL.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if kind is not None:
            counts[kind] += n
    if counts != tally.coll_count:
        raise RuntimeError(f"collective counts differ: CommDebugMode "
                           f"{counts}, local ops {tally.coll_count}")
    coll = dict(tally.coll)
    coll["count"] = sum(counts.values())
    coll["counts"] = counts
    coll["total"] = sum(tally.coll[k] for k in KINDS)
    return {"arg_bytes": sum(_nbytes(t) for t in arg_locals),
            "temp_bytes": tally.peak, "flops": tally.flops,
            "flops_f32": tally.flops_f32, "bytes": tally.bytes,
            "collectives": coll}


def _combine(parts: list) -> dict:
    """Σ weight · figures (collectives per kind) for [(weight, figures)]."""
    nums = ("arg_bytes", "temp_bytes", "flops", "flops_f32", "bytes")
    out = dict.fromkeys(nums, 0)
    out["collectives"] = {k: 0 for k in KINDS}
    out["collectives"]["counts"] = {k: 0 for k in KINDS}
    for w, f in parts:
        for k in nums:
            out[k] += w * f[k]
        for k in KINDS:
            out["collectives"][k] += w * f["collectives"][k]
            out["collectives"]["counts"][k] += \
                w * f["collectives"]["counts"][k]
    c = out["collectives"]
    c["count"] = sum(c["counts"].values())
    c["total"] = sum(c[k] for k in KINDS)
    return out


def _measure_cell(mod, shape, mesh, rules, n_layers=None,
                  global_only=False) -> tuple:
    _clear_device_caches()
    bundle = cells.build_for(mod, shape, mesh, rules, n_layers=n_layers,
                             global_only=global_only)
    return measure(bundle.fn, bundle.args), bundle.meta


def _depth_config(mod, shape):
    """The full config whose depth a cell's trace cuts."""
    return mod.full_config(shape) if mod.FAMILY == "gnn" else \
        mod.full_config()


def measure_depth(mod, shape, mesh, rules=None) -> tuple:
    """Figures at full depth from traces at 1 and 2 layers (and, for an LM
    that interleaves window kinds, 1 global layer): with Δ = f(2) - f(1),
    f(n) = f(1) + (n_first - 1)·Δ + n_global·(f_global(1) - f(1) + Δ),
    n_first the layers of layer 0's kind."""
    cfg = _depth_config(mod, shape)
    f1, meta = _measure_cell(mod, shape, mesh, rules, 1)
    f2, _ = _measure_cell(mod, shape, mesh, rules, 2)
    n_glob, interleaved = 0, False
    if mod.FAMILY == "lm":
        from repro_torch.models.transformer import layer_is_global

        flags = layer_is_global(cfg)
        n_glob = int(flags.sum())
        interleaved = not flags[0] and n_glob > 0
    n_first = cfg.n_layers - (n_glob if interleaved else 0)
    fig = extrapolate(f1, f2, n_first)
    traced = ["1", "2"]
    if interleaved:
        fg, _ = _measure_cell(mod, shape, mesh, rules, 1, global_only=True)
        fig = _combine([(1, fig), (n_glob, fg), (-n_glob, f1), (n_glob, f2),
                        (-n_glob, f1)])
        traced.append("1 global")
    return fig, meta, depth_note(cfg.n_layers, traced)


def depth_note(n_layers: int, traced: list) -> dict:
    return {"n_layers": n_layers, "traced": traced, "extrapolated": True}


def extrapolate(f1: dict, f2: dict, n_layers: int) -> dict:
    """Figures at ``n_layers`` from those at 1 and 2 layers of a model
    whose layers are all alike: f(1) + (n - 1)·(f(2) - f(1))."""
    return _combine([(1, f1), (n_layers - 1, f2), (-(n_layers - 1), f1)])


def _measure(mod, shape, mesh, rules, full_depth: bool) -> tuple:
    layered = mod.FAMILY in ("lm", "gnn")
    if layered and not full_depth:
        return measure_depth(mod, shape, mesh, rules)
    fig, meta = _measure_cell(mod, shape, mesh, rules)
    depth = None
    if layered:
        depth = {"n_layers": _depth_config(mod, shape).n_layers,
                 "traced": ["all"], "extrapolated": False}
    return fig, meta, depth


def trace(mod, shape: dict, mesh_shape, axes, rules=None,
          full_depth: bool = False, n_layers: Optional[int] = None) -> tuple:
    """(figures, meta, depth) of one cell (a config module and a shape
    dict) on a mesh of ``mesh_shape`` with ``axes``, in a fake world of its
    size with ``FakeTensorMode`` on.  LM and GNN cells are traced at cut
    depth unless ``full_depth``; ``n_layers`` traces that depth alone
    (depth None: nothing extrapolated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import mesh as meshlib

    with fake_world(math.prod(mesh_shape)):
        # the mesh is built on real tensors, before the fake mode
        mesh = meshlib.make_mesh(mesh_shape, axes, "cpu")
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                if n_layers is not None:
                    return (*_measure_cell(mod, shape, mesh, rules,
                                           n_layers), None)
                return _measure(mod, shape, mesh, rules, full_depth)
        finally:
            _clear_device_caches()


def _clear_device_caches() -> None:
    """Drop the models' per-device constant tensors, made fake inside the
    trace: a later run in this process makes them anew (and a trace counts
    them every time)."""
    from repro_torch.models import gnn, sh

    for cached in (gnn._m_rows, gnn._coef_degree, sh._dz_tensors,
                   sh._j_tensors):
        cached.cache_clear()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             rules=None, full_depth: bool = False,
             mesh_shape: Optional[tuple] = None) -> dict:
    """One cell's result on the production mesh (or on ``mesh_shape``, a
    (shape, axis names) pair)."""
    shape, axes = mesh_shape or production_shape(multi_pod)
    t0 = time.time()
    mod = registry.get(arch)
    fig, meta, depth = trace(mod, mod.SHAPES[shape_name], shape, axes, rules,
                             full_depth)
    return report(arch, shape_name, shape, fig, meta, depth,
                  time.time() - t0)


def report(arch: str, shape_name: str, mesh_shape, fig: dict, meta: dict,
           depth: Optional[dict], trace_s: float) -> dict:
    """One cell's result from its figures on a mesh of ``mesh_shape``."""
    n_dev = math.prod(mesh_shape)
    flops = float(fig["flops"])
    coll = fig["collectives"]
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh_shape), "n_chips": n_dev,
        "ok": True, "trace_s": round(trace_s, 1),
        "bytes_per_device": int(fig["arg_bytes"] + fig["temp_bytes"]),
        "temp_bytes": int(fig["temp_bytes"]),
        "arg_bytes": int(fig["arg_bytes"]),
        "hlo_flops_per_device": flops,
        "flops_f32": float(fig["flops_f32"]),
        "hlo_bytes_per_device": float(fig["bytes"]),
        "collective_bytes_per_device": coll["total"],
        "collectives": coll,
        "t_compute": compute_time(fig),
        "t_memory": fig["bytes"] / HBM_BW,
        "t_collective": coll["total"] / NET_BW,
        "depth": depth,
        "meta": meta,
    }
    terms = {"compute": res["t_compute"], "memory": res["t_memory"],
             "collective": res["t_collective"]}
    res["bottleneck"] = max(terms, key=terms.get)
    mf = meta.get("model_flops")
    if mf:
        res["model_flops"] = mf
        res["useful_flops_frac"] = mf / (flops * n_dev) if flops else None
    return res


def _line(tag: str, res: dict) -> str:
    depth = res.get("depth") or {}
    extra = " depth=extrapolated" if depth.get("extrapolated") else ""
    return (f"[OK]   {tag}: bottleneck={res['bottleneck']} "
            f"mem/dev={res['bytes_per_device'] / 2**30:.2f}GiB "
            f"t=({res['t_compute']:.3e},{res['t_memory']:.3e},"
            f"{res['t_collective']:.3e})s "
            f"colls={res['collectives']['count']} "
            f"trace={res['trace_s']:.0f}s{extra}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run the sinnamon-engine cells")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace LM and GNN cells at full depth (slow)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        todo = list(registry.all_cells(include_extra=args.include_extra))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t_start = time.time()
    results = []
    for arch, shape in todo:
        for mp in meshes:
            tag = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
            try:
                res = run_cell(arch, shape, multi_pod=mp,
                               full_depth=args.full_depth)
                print(_line(tag, res), flush=True)
            except Exception as e:                     # noqa: BLE001
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16", "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            results.append(res)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"{n_ok}/{len(results)} cells OK ({time.time() - t_start:.0f}s)")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
