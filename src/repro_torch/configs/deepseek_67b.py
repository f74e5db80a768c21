"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.common import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.transformer import LMConfig

ARCH = "deepseek-67b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH, n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=102400, head_dim=128, rope_theta=10_000.0)


def smoke_config() -> LMConfig:
    # same family traits: GQA (kv < heads), llama MLP, deep-ish stack
    return LMConfig(
        name=ARCH + "-smoke", n_layers=4, d_model=128, n_heads=8,
        n_kv_heads=2, d_ff=352, vocab=512, head_dim=16, attn_chunk=64)
