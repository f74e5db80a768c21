"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-1_6b; hf]."""
from repro_torch.configs.common import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.transformer import LMConfig

ARCH = "stablelm-12b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH, n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab=100352, head_dim=160, rope_theta=10_000.0)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke", n_layers=3, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab=384, head_dim=16, attn_chunk=64)
