from .ops import rglru_scan
from .ref import CHUNK, SEGMENT, rglru_scan_chunked_ref, rglru_scan_ref

__all__ = ["CHUNK", "SEGMENT", "rglru_scan", "rglru_scan_chunked_ref", "rglru_scan_ref"]
