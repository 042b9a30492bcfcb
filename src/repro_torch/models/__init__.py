"""Model stack of the port: the attention layer kinds, for serving and training."""

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
