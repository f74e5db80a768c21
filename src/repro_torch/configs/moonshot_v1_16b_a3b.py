"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 fine-grained experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.common import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.transformer import LMConfig

ARCH = "moonshot-v1-16b-a3b"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=163840, head_dim=128, rope_theta=50_000.0,
        moe=True, n_experts=64, moe_top_k=6, group_size=4096)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=48, vocab=384, head_dim=16,
        moe=True, n_experts=8, moe_top_k=3, group_size=32, attn_chunk=32)
