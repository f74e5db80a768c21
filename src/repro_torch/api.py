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
in the reference's formats).  ``shards > 1`` and ``device_budget_mb`` raise
``NotImplementedError`` naming the ROADMAP item that ports them.
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
    None -> ``fused``).
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
    device_budget_mb: Optional[float] = None

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.backend is not None:
            from repro_torch.kernels import ops as _ops
            _ops.resolve_backend(self.backend)

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

    With ``config.durability`` set it returns
    ``DurableSinnamonIndex.open(...)``, which recovers what its directories
    hold.  The returned index carries ``config`` on ``.config`` and
    ``config.backend`` as its default scoring backend.
    """
    if config.shards > 1:
        raise NotImplementedError(
            "shards > 1, with or without durability, is not ported yet "
            "(ROADMAP Queue 1 item 11: serving/sharded.py on "
            "torch.distributed, then DurableShardedSinnamonIndex)")
    if config.device_budget_mb is not None:
        raise NotImplementedError(
            "device_budget_mb (tiering), with or without durability, is not "
            "ported yet (ROADMAP Queue 1 item 10: storage/tiered.py, then "
            "DurableTieredSinnamonIndex)")
    if config.durability is not None:
        from repro_torch.persist import DurableSinnamonIndex
        index = DurableSinnamonIndex.open(config.engine_spec(), device=device,
                                          **config.durability.kwargs())
    else:
        index = eng.SinnamonIndex(config.engine_spec(), device=device)
    index.default_backend = config.backend
    index.config = config
    return index
