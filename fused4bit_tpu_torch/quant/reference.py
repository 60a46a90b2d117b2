"""Golden-reference quantized linear: dequantize, then a float32 matmul.

Counterpart of ``fused4bit_tpu/quant/reference.py``. Slow but obviously
correct: the oracle the kernels are held against. The product runs in full
float32: TF32 is switched off for the call, whatever the process set.
"""
from __future__ import annotations

import contextlib

import torch

from .core import QuantizedTensor, dequantize

__all__ = ["reference_linear_qt", "full_precision"]


@contextlib.contextmanager
def full_precision():
    """Run CUDA float32 matmuls in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def reference_linear_qt(x: torch.Tensor, qt: QuantizedTensor, dtype=torch.float32):
    """Oracle for a per_row planar QuantizedTensor: ``x @ dequant(W)^T``."""
    w = dequantize(qt, dtype=torch.float32)
    with full_precision():
        y = torch.matmul(x.float(), w.transpose(-1, -2))
    return y.to(dtype)
