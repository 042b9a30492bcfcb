"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427]

Griffin block pattern: (recurrent, recurrent, local_attn) repeated; the
38-layer stack is 12 groups + a 2-layer recurrent remainder.  Local
attention window 2048 and O(1) recurrent state make `long_500k` eligible.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,  # MQA in the local-attention layers
        d_ff=12288,
        vocab_size=256_000,
        pattern=("recurrent", "recurrent", "local_attn"),
        local_window=2048,
        d_rnn=4096,
        activation="geglu",
        norm="rmsnorm",
        logits_softcap=30.0,
        tie_embeddings=True,  # gemma family ties in/out embeddings
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=5,  # one full group + (recurrent, recurrent) remainder
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        pattern=("recurrent", "recurrent", "local_attn"),
        local_window=8,
        d_rnn=64,
        activation="geglu",
        norm="rmsnorm",
        logits_softcap=30.0,
        dtype="float32",
    )
