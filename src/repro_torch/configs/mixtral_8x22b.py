"""mixtral-8x22b [moe] — 8-expert top-2 MoE with sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088]

SWA (window 4096) makes this arch `long_500k`-eligible: the decode KV
cache is bounded by the window regardless of context length.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        activation="swiglu",
        norm="rmsnorm",
        window=4096,  # sliding-window attention
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2, capacity_factor=1.25),
        param_dtype="bfloat16",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        norm="rmsnorm",
        window=8,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, capacity_factor=2.0),
        dtype="float32",
    )
