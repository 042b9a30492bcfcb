"""yi-34b [dense] — llama-architecture GQA, the largest dense arch.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 [arXiv:2403.04652]
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "yi-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=5_000_000.0,
        param_dtype="bfloat16",  # halves FSDP weight-gather bytes (§Perf yi iter 3)
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=3,
        d_model=56,
        num_heads=7,
        num_kv_heads=1,
        d_ff=160,
        vocab_size=256,
        activation="swiglu",
        norm="rmsnorm",
        dtype="float32",
    )
