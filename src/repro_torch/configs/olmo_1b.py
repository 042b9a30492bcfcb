"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304 [arXiv:2402.00838]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        activation="swiglu",
        norm="nonparametric_ln",  # OLMo's distinguishing choice
        tie_embeddings=True,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        norm="nonparametric_ln",
        tie_embeddings=True,
        dtype="float32",
    )
