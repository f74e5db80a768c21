"""sasrec [recsys] — self-attentive sequential recommendation
[arXiv:1808.09781; paper]."""
from repro_torch.configs.common import RECSYS_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.recsys import RecsysConfig

ARCH = "sasrec"
FAMILY = "recsys"


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH, model="sasrec", embed_dim=50, n_blocks=2, n_heads=1,
        seq_len=50, n_items=1_000_000)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH + "-smoke", model="sasrec", embed_dim=16, n_blocks=2,
        n_heads=1, seq_len=12, n_items=500)
