from .ops import RGLRUScanFn, rglru_scan, rglru_scan_bwd, rglru_scan_fwd
from .ref import (CHUNK, SEGMENT, chunk_states, rglru_scan_bwd_chunked_ref, rglru_scan_bwd_ref,
                  rglru_scan_chunked_ref, rglru_scan_ref)

__all__ = ["CHUNK", "SEGMENT", "RGLRUScanFn", "chunk_states", "rglru_scan", "rglru_scan_bwd",
           "rglru_scan_bwd_chunked_ref", "rglru_scan_bwd_ref", "rglru_scan_chunked_ref", "rglru_scan_fwd",
           "rglru_scan_ref"]
