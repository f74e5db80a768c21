"""The paper's own workload as an extra arch: a sharded Sinnamon index at
MS-MARCO scale (8.8M docs, SPLADE-like stats) serving batched queries, as
``repro.configs.sinnamon_engine`` sizes it.  Not one of the assigned
cells."""
from repro_torch.core.engine import EngineSpec

ARCH = "sinnamon-engine"
FAMILY = "retrieval"

SHAPES = {
    "serve_msmarco": {"kind": "retrieval_serve", "corpus": 8_912_896,
                      "batch": 256, "n": 30_000, "m": 64, "max_nnz": 128,
                      "kprime_local": 64, "k": 10, "psi_q": 64},
    # billion-scale needs the §4.1.2 approximate (hashed-bucket) inverted
    # index: the exact n×C bitmap would be ~4 PB; 4096 buckets bring it to
    # C/8·4096 bytes ≈ 0.5 TB across the fleet with a quantified recall cost.
    "serve_billion": {"kind": "retrieval_serve", "corpus": 1_073_741_824,
                      "batch": 256, "n": 30_000, "m": 64, "max_nnz": 128,
                      "kprime_local": 64, "k": 10, "psi_q": 64,
                      "index_buckets": 4096},
}


def full_config(shape: dict, n_corpus_shards: int) -> EngineSpec:
    return EngineSpec(
        n=shape["n"], m=shape["m"],
        capacity=shape["corpus"] // n_corpus_shards,
        max_nnz=shape["max_nnz"], h=1, positive_only=False,
        index_buckets=shape.get("index_buckets"))


def smoke_config() -> EngineSpec:
    return EngineSpec(n=512, m=16, capacity=1024, max_nnz=48, h=2)
