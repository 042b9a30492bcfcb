"""distilgpt2-82m — the paper's own workload (§5.5, Fig. 14).

6L d_model=768 12H d_ff=3072 vocab=50257, ~82M parameters.  Both the
AllReduce (M2) and Parameter-Server (M1) geo-training experiments
fine-tune this model; per-batch gradient volume ~312 MB (DDP fp32 grads)
matches the paper's measurement.

(The original uses learned positional embeddings; we use RoPE — the
parameter count and communication volume, which is what the paper
measures, are preserved.)
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "distilgpt2-82m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=6,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=50257,
        activation="gelu",
        norm="layernorm",
        tie_embeddings=True,
        use_bias_attn=True,
        use_bias_mlp=True,
        remat="none",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        activation="gelu",
        norm="layernorm",
        tie_embeddings=True,
        use_bias_attn=True,
        use_bias_mlp=True,
        dtype="float32",
    )
