"""musicgen-large [audio] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048 [arXiv:2306.05284]

Backbone only per the assignment: the EnCodec frontend is a STUB —
``input_specs()`` provides precomputed frame embeddings (one fused
embedding per audio frame across the four codebooks).
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-large"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        activation="gelu",
        norm="layernorm",
        frontend="frame",
        frontend_dim=512,  # EnCodec latent width
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        activation="gelu",
        norm="layernorm",
        frontend="frame",
        frontend_dim=32,
        dtype="float32",
    )
