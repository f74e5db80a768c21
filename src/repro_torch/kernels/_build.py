"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch/`` at the repository root, at first use, keyed by a hash
of the source and the flags.  Nothing here runs at import time: the CPU
tests import every module of the package on machines without ``nvcc``.

Failures raise: a missing ``nvcc``, a compiler error or a library that does
not load is a :class:`KernelBuildFailure`, never a silent fallback.

Each first load in a process records a ``kernel_load`` trace
(``repro_torch.obs.trace``): one span named after the kernel, the host
time to build it (when ``nvcc`` runs) and open its library.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

KERNELS = ("sinnamon_score", "csr_score", "sinnamon_dense", "embed_bag",
           "csr_rerank", "embed_bag_backward")

#: Shared memory one block may use on Hopper (sm_90), in bytes.
SMEM_PER_BLOCK = 232_448

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no contraction into FMA: the kernels match their plain twins bit for
    # bit where the sum order is the same
    "-fmad=false",
    "-Xptxas", "-v",
)


class KernelBuildFailure(RuntimeError):
    """A kernel could not be compiled or loaded."""


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    library: Path
    ptxas_log: str          # nvcc's -Xptxas -v report (registers, smem)


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()    # one build of a kernel, whatever calls it
_SM_COUNT: Dict[int, int] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildFailure("nvcc not found (set CUDA_HOME or PATH); "
                               "the CUDA kernels are built from source")
    return found


def _target(name: str) -> tuple:
    """(source, library, log) of kernel ``name``; the library's name hashes
    the source, the shared headers of ``csrc/`` and the flags."""
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    return src, lib, lib.with_suffix(".log")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together.  Up-to-date libraries are reused."""
    names = tuple(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, log = _target(name)
        if lib.exists() and log.exists():
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        _, lib, log = _target(name)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
    if errors:
        raise KernelBuildFailure("\n".join(errors))
    return {name: Built(name, _target(name)[1], _target(name)[2].read_text())
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (once,
    when searches from several threads make the first call together)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            trace = None
            if not isinstance(obs_metrics.get_registry(),
                              obs_metrics.NullRegistry):
                trace = obs_trace.Trace("kernel_load", device_timed=True)
            with obs_trace.span(trace, name):
                path = build([name])[name].library
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    raise KernelBuildFailure(f"cannot load {path}: {e}") \
                        from e
            _LOADED[name] = lib
            if trace is not None:
                trace.finish()
    return lib


def sm_count(device) -> int:
    """Streaming multiprocessors of CUDA ``device``, read once per device
    (the launch wrappers size their grids by it on every call)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SM_COUNT.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNT[index] = n
    return n


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
