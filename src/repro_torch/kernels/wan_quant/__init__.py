from .ops import dequantize, quantize, wan_dequant, wan_quant
from .ref import BLOCK, wan_dequant_ref, wan_quant_ref

__all__ = [
    "BLOCK",
    "dequantize",
    "quantize",
    "wan_dequant",
    "wan_dequant_ref",
    "wan_quant",
    "wan_quant_ref",
]
