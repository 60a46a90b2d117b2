from .core import QuantizedTensor, dequantize, pack_planar, quantize, unpack_planar
from .reference import full_precision, reference_linear_qt

__all__ = [
    "QuantizedTensor",
    "dequantize",
    "full_precision",
    "pack_planar",
    "quantize",
    "reference_linear_qt",
    "unpack_planar",
]
