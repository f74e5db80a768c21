"""repro_torch — the PyTorch / CUDA port of the Sinnamon streaming sparse
MIPS engine, for NVIDIA Hopper (H100).

It mirrors the layout of the JAX reference package ``repro`` module for
module (``repro_torch.core.engine`` ↔ ``repro.core.engine``, ...) and
imports neither JAX nor any module of ``repro``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

    repro_torch.api      — IndexConfig, DurabilityConfig + open_index
                           (one device or S shards, ephemeral or durable,
                           resident or tiered)
    repro_torch.core     — sketch, bit-packed index, engine, SinnamonIndex,
                           §5 theory, LinScan and WAND baselines
    repro_torch.kernels  — CUDA kernels for Hopper + plain twins + dispatch
    repro_torch.storage  — padded-CSR vector store
    repro_torch.serving  — QueryServer, QueryResult, the front door, the
                           sharded index (one process over S shards)
    repro_torch.distributed — shard placement and the shard merge
    repro_torch.obs      — metrics registry, traces, flight recorder, SLO
                           monitor, event log, HTTP debug server
    repro_torch.fault    — seeded failpoints, retry, circuit breaker,
                           degradation ladder
    repro_torch.checkpoint — checkpoints in the reference's on-disk layout
    repro_torch.persist  — WAL, snapshots, compaction policy,
                           DurableSinnamonIndex, DurableShardedSinnamonIndex
                           (recover either package's files)
    repro_torch.convert  — carry a reference index's state, recsys
                           parameters and train states into the port and
                           back (snapshot and checkpoint leaves)
    repro_torch.data     — synthetic corpora and recsys batches
                           (draw-identical to repro's)
    repro_torch.eval     — recall frontier, §5 bound check, auto-tuner
    repro_torch.launch   — serving and training launchers
    repro_torch.models   — the recsys family (DLRM, DIN, SASRec, MIND),
                           served and trained; DLRM's bags on kernel D
                           and its backward kernel
    repro_torch.optim    — AdamW, int8 error-feedback compression
    repro_torch.train    — the train step (microbatches, clip, AdamW)
    repro_torch.configs  — the recsys configs, sinnamon-engine, the
                           recsys shape table and the arch registry
"""

__version__ = "0.1.0"
