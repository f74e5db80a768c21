"""``repro_torch.api`` — the front door to the port (counterpart of
``repro.api``)::

    from repro_torch.api import IndexConfig, open_index
    from repro_torch.serving.serve import QueryServer

    index = open_index(IndexConfig(n=30_000, capacity=65_536))   # on CUDA
    index.insert_many(ids, idx, val)
    result = QueryServer(index, k=10).query_many(q_idx, q_val)

It serves the single-device rows of the reference's routing table: an
ephemeral ``SinnamonIndex``, or with a :class:`DurabilityConfig` a
``DurableSinnamonIndex`` that recovers snapshot + WAL tail on open (on disk
in the reference's formats); with ``device_budget_mb`` each becomes its
tiered twin (``TieredSinnamonIndex`` / ``DurableTieredSinnamonIndex``: the
raw rows in pinned host memory behind a device chunk cache of that many
MiB).  ``shards > 1`` raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
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
    None -> ``fused``).  ``device_budget_mb`` caps the device bytes of raw
    vector rows and serves the tiered index (results bit-identical to the
    resident one); ``tier_chunk_slots`` is its paging granularity in slots
    per chunk.
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


def open_index(config: IndexConfig, device=None) -> eng.SinnamonIndex:
    """Open the index a config describes, on ``device`` (None: the CUDA
    card; raises when there is none unless ``device="cpu"`` is given).

    ========== ================ =================================
    durability device_budget_mb returns
    ========== ================ =================================
    None       None             ``SinnamonIndex``
    None       set              ``TieredSinnamonIndex``
    set        None             ``DurableSinnamonIndex.open``
    set        set              ``DurableTieredSinnamonIndex.open``
    ========== ================ =================================

    A durable index recovers what its directories hold.  The tiered cache
    holds ``int(device_budget_mb * 2**20)`` bytes of rows, rounded down to
    whole chunks.  The returned index carries ``config`` on ``.config`` and
    ``config.backend`` as its default scoring backend.
    """
    if config.shards > 1:
        raise NotImplementedError(
            "shards > 1, with or without durability, is not ported yet "
            "(ROADMAP Queue 1 item 11: serving/sharded.py on "
            "torch.distributed, then DurableShardedSinnamonIndex)")
    spec = config.engine_spec()
    tkw = dict(tier_chunk_slots=config.tier_chunk_slots,
               device_budget_bytes=int(config.device_budget_mb * (1 << 20))
               ) if config.device_budget_mb is not None else None
    if config.durability is not None:
        from repro_torch.persist import durable
        if tkw is None:
            index = durable.DurableSinnamonIndex.open(
                spec, device=device, **config.durability.kwargs())
        else:
            index = durable.DurableTieredSinnamonIndex.open(
                spec, device=device, **config.durability.kwargs(), **tkw)
    elif tkw is None:
        index = eng.SinnamonIndex(spec, device=device)
    else:
        index = eng.TieredSinnamonIndex(spec, device=device, **tkw)
    index.default_backend = config.backend
    index.config = config
    return index
