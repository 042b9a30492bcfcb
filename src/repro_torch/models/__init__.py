"""Model stack of the port: the attention layer kinds, for serving."""

from .config import ATTN, LOCAL, RECURRENT, RWKV, ModelConfig, MoEConfig
from .lm import DecoderLM
from .transformer import (
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    prefill,
)

__all__ = [
    "ATTN",
    "LOCAL",
    "RECURRENT",
    "RWKV",
    "DecoderLM",
    "ModelConfig",
    "MoEConfig",
    "decode_step",
    "forward",
    "init_decode_cache",
    "init_params",
    "prefill",
]
