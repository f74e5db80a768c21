"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.common import LM_SHAPES as SHAPES  # noqa: F401
from repro_torch.models.transformer import LMConfig

ARCH = "llama4-scout-17b-a16e"
FAMILY = "lm"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128, rope_theta=500_000.0,
        moe=True, n_experts=16, moe_top_k=1, group_size=4096,
        attn_q_chunk=256)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke", n_layers=3, d_model=96, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=384, head_dim=16,
        moe=True, n_experts=4, moe_top_k=1, group_size=32, attn_chunk=32)
