"""gemma3-27b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.configs.common import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.transformer import LMConfig

ARCH = "gemma3-27b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH, n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
        d_ff=21504, vocab=262144, head_dim=128, rope_theta=1_000_000.0,
        local_window=1024, local_global_ratio=5)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke", n_layers=6, d_model=128, n_heads=8,
        n_kv_heads=4, d_ff=384, vocab=512, head_dim=16,
        local_window=16, local_global_ratio=5, attn_chunk=32)
