"""Sharding helpers of the port (counterpart of ``repro.distributed``).

The reference shards the corpus over a device mesh and merges shard-local
candidates inside ``shard_map``.  The port's serving index keeps one
process over a list of shard devices (``mesh.shard_devices``) and merges
the same candidate tuples on the host's stream (``topk``).  The mesh
tooling (``rules``, the ``DeviceMesh`` helpers of ``mesh``) places tensors
as DTensors over a ``torch.distributed`` mesh, as the dry run does.
"""
