"""starcoder2-7b [dense] — GQA kv=4, RoPE, GELU MLP with biases.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "starcoder2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        activation="gelu",
        norm="layernorm",
        use_bias_attn=True,
        use_bias_mlp=True,
        rope_theta=100_000.0,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=72,
        num_heads=6,
        num_kv_heads=2,
        d_ff=288,
        vocab_size=256,
        activation="gelu",
        norm="layernorm",
        use_bias_attn=True,
        use_bias_mlp=True,
        dtype="float32",
    )
