from .core import (
    QuantizedTensor,
    dequantize,
    pack_planar,
    planar_groups_to_planar,
    planar_to_planar_groups,
    quantize,
    unpack_planar,
)
from .reference import full_precision, reference_linear_qt

__all__ = [
    "QuantizedTensor",
    "dequantize",
    "full_precision",
    "pack_planar",
    "planar_groups_to_planar",
    "planar_to_planar_groups",
    "quantize",
    "reference_linear_qt",
    "unpack_planar",
]
