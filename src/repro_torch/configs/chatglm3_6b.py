"""chatglm3-6b [dense] — 2d RoPE (half-dim rotary), GQA kv=2, QKV bias.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "chatglm3-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        activation="swiglu",
        norm="rmsnorm",
        rope_fraction=0.5,  # GLM "2d" rotary: only half of each head rotates
        use_bias_attn=True,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        norm="rmsnorm",
        rope_fraction=0.5,
        use_bias_attn=True,
        dtype="float32",
    )
