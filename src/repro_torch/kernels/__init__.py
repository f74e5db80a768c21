"""Hand-written CUDA kernels for Hopper, their plain-torch twins, and the
operand preparation around them (see ``ops``).

The kernels are built from ``csrc/`` at first use (``_build``); importing
this package builds nothing, so it imports on machines without a GPU.
"""

from repro_torch.kernels import csr_rerank as _rr
from repro_torch.kernels import csr_score as _csr
from repro_torch.kernels import embed_bag as _bag
from repro_torch.kernels import sinnamon_score as _sinn

#: Every kernel wrapper of the package; each carries a ``launches`` count.
WRAPPERS = {"sinnamon_score_topk": _sinn.sinnamon_score_topk,
            "sinnamon_score_threshold": _sinn.sinnamon_score_threshold,
            "csr_score": _csr.csr_score,
            "sinnamon_score": _sinn.sinnamon_score,
            "embed_bag": _bag.embed_bag,
            "embed_bag_backward": _bag.embed_bag_backward,
            "csr_rerank_topk": _rr.csr_rerank_topk}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
