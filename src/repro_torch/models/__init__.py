"""Model stack of the port: the attention and RWKV6 layer kinds, for serving and training (RWKV6 serves only);
the parameters and decode state of every arch, MoE and RG-LRU included."""

from .config import ATTN, LOCAL, RECURRENT, RWKV, ModelConfig, MoEConfig
from .lm import DecoderLM
from .transformer import (
    IGNORE_LABEL,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "ATTN",
    "LOCAL",
    "RECURRENT",
    "RWKV",
    "DecoderLM",
    "IGNORE_LABEL",
    "ModelConfig",
    "MoEConfig",
    "decode_step",
    "forward",
    "init_decode_cache",
    "init_params",
    "loss_fn",
    "prefill",
]
