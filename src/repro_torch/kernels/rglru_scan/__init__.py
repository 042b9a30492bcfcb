from .ops import rglru_scan
from .ref import CHUNK, rglru_scan_chunked_ref, rglru_scan_ref

__all__ = ["CHUNK", "rglru_scan", "rglru_scan_chunked_ref", "rglru_scan_ref"]
