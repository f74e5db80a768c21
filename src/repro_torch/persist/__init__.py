"""Durability layer for the streaming retrieval engine (counterpart of
``repro.persist``, on disk in its formats).

* ``wal``      — append-only write-ahead log of insert/delete/grow/compact ops
                 (numpy record batches, fsync'd segments, CRC-checked replay).
* ``snapshot`` — full-state snapshots built on checkpoint/ckpt.py's atomic
                 rename layout, with the reference's leaves and recipe.
* ``compact``  — drift metrics + compaction policy (including a background
                 compactor thread) for §4.3 recycled-slot sketch residue.
* ``durable``  — ``DurableSinnamonIndex`` / ``DurableShardedSinnamonIndex``:
                 the WAL-on-write wrappers (one WAL partition per shard)
                 with recovery = snapshot + WAL tail.
"""

from repro_torch.persist.durable import (  # noqa: F401
    DurableShardedSinnamonIndex,
    DurableSinnamonIndex,
)
