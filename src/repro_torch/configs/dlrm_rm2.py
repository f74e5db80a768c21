"""dlrm-rm2 [recsys] — [arXiv:1906.00091; paper]: 26 fields of 1,000,000
rows × 64 (6.66 GB of f32 tables), bottom MLP 13→512→256→64, top MLP
415→512→512→256→1."""
from repro_torch.configs.common import RECSYS_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.recsys import RecsysConfig

ARCH = "dlrm-rm2"
FAMILY = "recsys"


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH, model="dlrm", embed_dim=64, n_dense=13, n_sparse=26,
        vocab_per_field=1_000_000, multi_hot=1, n_items=1_000_000,
        bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH + "-smoke", model="dlrm", embed_dim=16, n_dense=13,
        n_sparse=6, vocab_per_field=1000, multi_hot=1, n_items=1000,
        bot_mlp=(32, 16), top_mlp=(32, 1))
