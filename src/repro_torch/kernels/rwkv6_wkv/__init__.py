from .ops import GRAD_CHUNK, WKV_BWD_ROUTE_LAUNCHES, WKV6Fn, bwd_route, remat_contexts, wkv6, wkv6_bwd, wkv6_fwd
from .ref import wkv6_bwd_chunked_ref, wkv6_bwd_ref, wkv6_ref

__all__ = [
    "GRAD_CHUNK", "WKV_BWD_ROUTE_LAUNCHES", "WKV6Fn", "bwd_route", "remat_contexts", "wkv6", "wkv6_bwd",
    "wkv6_bwd_chunked_ref", "wkv6_bwd_ref", "wkv6_fwd", "wkv6_ref",
]
