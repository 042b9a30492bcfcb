from .ops import wkv6, wkv6_fwd
from .ref import wkv6_ref

__all__ = ["wkv6", "wkv6_fwd", "wkv6_ref"]
