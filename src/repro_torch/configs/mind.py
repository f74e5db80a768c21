"""mind [recsys] — multi-interest capsule routing [arXiv:1904.08030]."""
from repro_torch.configs.common import RECSYS_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.recsys import RecsysConfig

ARCH = "mind"
FAMILY = "recsys"


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH, model="mind", embed_dim=64, n_interests=4,
        capsule_iters=3, seq_len=50, n_items=1_000_000)


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH + "-smoke", model="mind", embed_dim=16, n_interests=3,
        capsule_iters=2, seq_len=12, n_items=500)
