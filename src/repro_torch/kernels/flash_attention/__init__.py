from .ops import (
    BWD_ROUTE_LAUNCHES,
    ROUTE_LAUNCHES,
    FlashAttentionFn,
    bwd_route,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    fwd_route,
)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = [
    "BWD_ROUTE_LAUNCHES",
    "ROUTE_LAUNCHES",
    "FlashAttentionFn",
    "bwd_route",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_ref",
    "flash_attention_fwd",
    "flash_attention_ref",
    "fwd_route",
]
