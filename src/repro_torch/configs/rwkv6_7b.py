"""rwkv6-7b [ssm] — "Finch": attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 [arXiv:2404.05892]

O(1) decode state (per layer: WKV [H, N, N] + two token-shift vectors),
so `long_500k` runs natively. The flash-attention kernel is inapplicable
(no attention); the WKV Pallas kernel is the hot-spot instead.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,  # informational: d_model / rwkv_head_dim
        num_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        pattern=("rwkv",),
        rwkv_head_dim=64,
        activation="relu_sq",  # RWKV channel-mix uses squared ReLU
        norm="layernorm",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=224,
        vocab_size=256,
        pattern=("rwkv",),
        rwkv_head_dim=16,
        activation="relu_sq",
        norm="layernorm",
        dtype="float32",
    )
