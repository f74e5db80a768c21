"""repro_torch — the PyTorch / CUDA port of the Sinnamon streaming sparse
MIPS engine, for NVIDIA Hopper (H100).

It mirrors the layout of the JAX reference package ``repro`` module for
module (``repro_torch.core.engine`` ↔ ``repro.core.engine``, ...) and
imports neither JAX nor any module of ``repro``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

    repro_torch.api      — IndexConfig, DurabilityConfig + open_index
                           (single device, ephemeral or durable)
    repro_torch.core     — sketch, bit-packed index, engine, SinnamonIndex,
                           §5 theory, LinScan and WAND baselines
    repro_torch.kernels  — CUDA kernels for Hopper + plain twins + dispatch
    repro_torch.storage  — padded-CSR vector store
    repro_torch.serving  — QueryServer, QueryResult
    repro_torch.obs      — metrics registry, traces, flight recorder, SLO
                           monitor, event log, HTTP debug server
    repro_torch.fault    — seeded failpoints, retry, circuit breaker,
                           degradation ladder
    repro_torch.checkpoint — checkpoints in the reference's on-disk layout
    repro_torch.persist  — WAL, snapshots, compaction policy,
                           DurableSinnamonIndex (recovers either package's
                           files)
    repro_torch.convert  — carry a reference index's state into the port
                           and back (snapshot leaves)
    repro_torch.data     — synthetic corpora and recsys batches
                           (draw-identical to repro's)
    repro_torch.eval     — recall frontier, §5 bound check, auto-tuner
    repro_torch.launch   — serving launcher
    repro_torch.models   — DLRM serving (recsys), its bags on kernel D
    repro_torch.configs  — dlrm-rm2 and the recsys shape table
"""

__version__ = "0.1.0"
