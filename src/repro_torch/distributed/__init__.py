"""Sharding helpers of the port (counterpart of ``repro.distributed``).

The reference shards the corpus over a device mesh and merges shard-local
candidates inside ``shard_map``; the port keeps one process over a list
of shard devices (``mesh``) and merges the same candidate tuples on the
host's stream (``topk``).  No ``torch.distributed`` is involved.
"""
