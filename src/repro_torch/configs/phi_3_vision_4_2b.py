"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP patch stub.

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]

The modality frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed CLIP-L/14 patch embeddings (width 1024) which the
backbone projects and prepends to the text tokens.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        frontend="patch",
        frontend_dim=1024,
        num_prefix_tokens=256,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        activation="swiglu",
        norm="rmsnorm",
        frontend="patch",
        frontend_dim=32,
        num_prefix_tokens=4,
        dtype="float32",
    )
