"""din [recsys] — target attention over user history [arXiv:1706.06978]."""
from repro_torch.configs.common import RECSYS_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.recsys import RecsysConfig

ARCH = "din"
FAMILY = "recsys"


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH, model="din", embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), mlp=(200, 80), n_items=1_000_000)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH + "-smoke", model="din", embed_dim=8, seq_len=12,
        attn_mlp=(16, 8), mlp=(24, 8), n_items=500)
