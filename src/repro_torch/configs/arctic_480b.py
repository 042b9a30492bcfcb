"""arctic-480b [moe] — 128-expert top-2 MoE with parallel dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base]

Snowflake Arctic's "dense-MoE hybrid": every layer runs a small dense FFN
*in parallel* with the 128-expert MoE (``MoEConfig.parallel_dense``).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "arctic-480b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        activation="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=128,
            num_experts_per_tok=2,
            capacity_factor=1.25,
            parallel_dense=True,
            impl="einsum",
        ),
        param_dtype="bfloat16",  # 480B params: bf16 + fp32 master offline
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
        d_ff=96,
        vocab_size=256,
        activation="swiglu",
        norm="rmsnorm",
        moe=MoEConfig(
            num_experts=8,
            num_experts_per_tok=2,
            capacity_factor=2.0,
            parallel_dense=True,
        ),
        dtype="float32",
    )
