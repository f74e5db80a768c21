"""``repro_torch.api`` — the front door to the port (counterpart of
``repro.api``)::

    from repro_torch.api import IndexConfig, open_index
    from repro_torch.serving.serve import QueryServer

    index = open_index(IndexConfig(n=30_000, capacity=65_536))   # on CUDA
    index.insert_many(ids, idx, val)
    result = QueryServer(index, k=10).query_many(q_idx, q_val)

It serves every row of the reference's routing table: an ephemeral
``SinnamonIndex``, or with a :class:`DurabilityConfig` a
``DurableSinnamonIndex`` that recovers snapshot + WAL tail on open (on disk
in the reference's formats); ``shards > 1`` (or a list of devices) gives
the sharded index, ``ShardedSinnamonIndex`` or
``DurableShardedSinnamonIndex``: one process over S shard states, several
of which may share one card, with no ``torch.distributed``; with
``device_budget_mb`` each becomes its tiered twin (``TieredSinnamonIndex``
/ ``TieredShardedSinnamonIndex`` / ``DurableTieredSinnamonIndex``: the raw
rows in pinned host memory behind a device chunk cache of that many MiB
per device).  Durable + sharded + tiered raises ``NotImplementedError``,
as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import engine as eng
from repro_torch.serving.results import QueryResult, new_trace_id

__all__ = ["DurabilityConfig", "IndexConfig", "QueryResult", "new_trace_id",
           "open_index"]


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """WAL + snapshot policy block of an :class:`IndexConfig` (the
    reference's ``repro.api.DurabilityConfig``).

    Presence of this block makes :func:`open_index` return a durable index
    (``repro_torch.persist``): every mutation is logged before it is applied
    and opening again on the same directories recovers snapshot + WAL tail.
    """

    wal_dir: str
    snapshot_dir: Optional[str] = None
    snapshot_every: Optional[int] = None   # snapshot after N logged ops
    compact_threshold: Optional[float] = None  # compact when drift exceeds
    compact_check_every: int = 64
    fsync: bool = True
    segment_bytes: int = 4 << 20
    snapshot_keep: int = 3

    def __post_init__(self):
        if self.snapshot_every is not None and self.snapshot_dir is None:
            raise ValueError("snapshot_every requires snapshot_dir "
                             "(periodic snapshots need somewhere to go)")

    def kwargs(self) -> dict:
        """Keyword arguments for the Durable* constructors."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Declarative index configuration; the input to :func:`open_index`.

    Engine geometry: ``n`` (dimensionality), ``capacity`` (global document
    slots), ``max_nnz`` (padded CSR width), ``m``/``h`` (sketch size / hash
    count), ``sketch_kind`` (``full | lite``), ``cell_dtype`` (sketch cells
    ``f32 | bf16 | f8``), ``store_dtype`` (raw rows), ``positive_only``,
    ``index_buckets``, ``seed``.  ``backend`` pins the scoring backend
    (``reference | grouped | fused``, ``pallas`` an alias of ``fused``;
    None -> ``fused``).  ``shards`` > 1 serves the sharded index
    (``capacity`` stays the GLOBAL slot count; each shard gets
    :attr:`local_capacity`), which writes in blocks of ``update_block``
    documents per shard.  ``device_budget_mb`` caps the PER-SHARD device
    bytes of raw vector rows and serves the tiered index (results
    bit-identical to the resident one); ``tier_chunk_slots`` is its paging
    granularity in slots per chunk.
    """

    n: int
    capacity: int
    m: int = 60
    h: int = 1
    max_nnz: int = 256
    positive_only: bool = False
    index_buckets: Optional[int] = None
    sketch_kind: str = "full"
    cell_dtype: str = "bf16"
    store_dtype: str = "bfloat16"
    seed: int = 0
    backend: Optional[str] = None
    shards: int = 1
    update_block: int = 32
    durability: Optional[object] = None
    device_budget_mb: Optional[float] = None   # device raw-store budget
    tier_chunk_slots: int = 256                # slots per tiering chunk

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.backend is not None:
            from repro_torch.kernels import ops as _ops
            _ops.resolve_backend(self.backend)
        if self.device_budget_mb is not None and self.device_budget_mb <= 0:
            raise ValueError(f"device_budget_mb must be positive, "
                             f"got {self.device_budget_mb}")
        if self.tier_chunk_slots < 1:
            raise ValueError(f"tier_chunk_slots must be >= 1, "
                             f"got {self.tier_chunk_slots}")

    @property
    def local_capacity(self) -> int:
        """Per-shard slot count: ceil(capacity / shards), rounded up to 32."""
        per = -(-self.capacity // self.shards)
        return ((per + 31) // 32) * 32

    def engine_spec(self) -> eng.EngineSpec:
        return eng.EngineSpec(
            n=self.n, m=self.m, h=self.h, capacity=self.local_capacity,
            max_nnz=self.max_nnz, positive_only=self.positive_only,
            index_buckets=self.index_buckets, sketch_kind=self.sketch_kind,
            dtype=self.cell_dtype, value_dtype=self.store_dtype,
            seed=self.seed)


def open_index(config: IndexConfig, device=None):
    """Open (or recover) the index a config describes, on ``device`` (None:
    the CUDA card; raises when there is none unless ``device="cpu"`` is
    given).

    ========== ================ ================ ========================
    durability shards / devices device_budget_mb returns
    ========== ================ ================ ========================
    None       1, one device    None             ``SinnamonIndex``
    None       1, one device    set              ``TieredSinnamonIndex``
    None       >1 or a list     None             ``ShardedSinnamonIndex``
    None       >1 or a list     set              ``TieredShardedSinnamonIndex``
    set        1, one device    None             ``DurableSinnamonIndex.open``
    set        1, one device    set              ``DurableTieredSinnamonIndex.open``
    set        >1 or a list     None             ``DurableShardedSinnamonIndex.open``
    set        >1 or a list     set              ``NotImplementedError``
    ========== ================ ================ ========================

    ``device`` may be a list of devices, one per shard: the counterpart of
    the reference's ``mesh=``, it sets the shard count and forces the
    sharded index even for one shard.  Otherwise ``shards > 1`` places
    ``config.shards`` shards on ``device`` (None: the visible CUDA devices,
    round robin).  A durable index recovers what its directories hold.  The
    tiered cache holds ``int(device_budget_mb * 2**20)`` bytes of rows per
    device (per shard), rounded down to whole chunks.  The returned index
    carries ``config`` on ``.config`` and ``config.backend`` as its default
    scoring backend.
    """
    spec = config.engine_spec()
    listed = isinstance(device, (list, tuple))
    sharded = listed or config.shards > 1
    tiered = config.device_budget_mb is not None
    if sharded and tiered and config.durability is not None:
        raise NotImplementedError(
            "durability + shards + device_budget_mb is not supported yet: "
            "drop one of the three (tiered sharded serving is available "
            "without durability)")
    tkw = dict(tier_chunk_slots=config.tier_chunk_slots,
               device_budget_bytes=int(config.device_budget_mb * (1 << 20))
               ) if tiered else {}
    if sharded:
        from repro_torch.distributed import mesh as meshlib
        devices = meshlib.shard_devices(None if listed else config.shards,
                                        device)
        skw = dict(update_block=config.update_block)
    if config.durability is not None:
        from repro_torch.persist import durable
        dkw = config.durability.kwargs()
        if sharded:
            index = durable.DurableShardedSinnamonIndex.open(
                spec, devices, **skw, **dkw)
        elif tiered:
            index = durable.DurableTieredSinnamonIndex.open(
                spec, device=device, **dkw, **tkw)
        else:
            index = durable.DurableSinnamonIndex.open(spec, device=device,
                                                      **dkw)
    elif sharded:
        from repro_torch.serving import sharded as sharded_mod
        cls = sharded_mod.TieredShardedSinnamonIndex if tiered \
            else sharded_mod.ShardedSinnamonIndex
        index = cls(spec, devices, **skw, **tkw)
    elif tiered:
        index = eng.TieredSinnamonIndex(spec, device=device, **tkw)
    else:
        index = eng.SinnamonIndex(spec, device=device)
    index.default_backend = config.backend
    index.config = config
    return index
