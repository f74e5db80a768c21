"""repro_torch — the PyTorch / CUDA port of the Sinnamon streaming sparse
MIPS engine, for NVIDIA Hopper (H100).

It mirrors the layout of the JAX reference package ``repro`` module for
module (``repro_torch.core.engine`` ↔ ``repro.core.engine``, ...) and
imports neither JAX nor any module of ``repro``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.

    repro_torch.api      — IndexConfig + open_index (single device)
    repro_torch.core     — sketch, bit-packed index, engine, SinnamonIndex,
                           §5 theory, LinScan and WAND baselines
    repro_torch.kernels  — CUDA kernels for Hopper + plain twins + dispatch
    repro_torch.storage  — padded-CSR vector store
    repro_torch.serving  — QueryServer, QueryResult
    repro_torch.convert  — carry a reference index's state into the port
    repro_torch.data     — synthetic corpora and recsys batches
                           (draw-identical to repro's)
    repro_torch.eval     — recall frontier, §5 bound check, auto-tuner
    repro_torch.launch   — serving launcher
    repro_torch.models   — DLRM serving (recsys), its bags on kernel D
    repro_torch.configs  — dlrm-rm2 and the recsys shape table
"""

__version__ = "0.1.0"
