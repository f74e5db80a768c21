"""Architecture registry: ``--arch <id>`` resolution for the launchers, as
``repro.configs.registry``.

``ARCHS`` and ``ASSIGNED`` are the reference's; every arch's config is
ported (the LM, GNN and recsys families and ``sinnamon-engine``).
"""
import importlib

ARCHS = {
    "deepseek-67b": "deepseek_67b",
    "stablelm-12b": "stablelm_12b",
    "gemma3-27b": "gemma3_27b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "equiformer-v2": "equiformer_v2",
    "sasrec": "sasrec",
    "mind": "mind",
    "din": "din",
    "dlrm-rm2": "dlrm_rm2",
    # extra: the paper's own workload (not part of the 40 assigned cells)
    "sinnamon-engine": "sinnamon_engine",
}

ASSIGNED = [a for a in ARCHS if a != "sinnamon-engine"]


def get(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def all_cells(include_extra: bool = False):
    """(arch, shape name) of every cell, in the reference's order."""
    names = list(ARCHS) if include_extra else ASSIGNED
    for a in names:
        for shape in get(a).SHAPES:
            yield a, shape
