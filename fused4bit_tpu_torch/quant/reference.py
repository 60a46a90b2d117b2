"""Golden-reference quantized linear: dequantize, then a float32 matmul.

Counterpart of ``fused4bit_tpu/quant/reference.py``. Slow but obviously
correct: the oracle the kernels are held against. The product runs in full
float32: TF32 is switched off for the call, whatever the process set.
"""
from __future__ import annotations

import contextlib

import torch

from .core import QuantizedTensor, dequantize, dequantize_weights

__all__ = ["reference_quantized_linear", "reference_linear_qt", "full_precision"]


@contextlib.contextmanager
def full_precision():
    """Run CUDA float32 matmuls in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def reference_quantized_linear(x: torch.Tensor, packed_weights: torch.Tensor,
                               scales: torch.Tensor, zero_points: torch.Tensor) -> torch.Tensor:
    """The reference library's oracle signature: ``x @ dequant(W)^T`` in
    float32, for x [K] or [..., K] and the interleaved bytes of
    :func:`~.core.quantize_weights` (packed [N, K/2], scales and zero points
    [N]). Returns [N] or [..., N]."""
    w = dequantize_weights(packed_weights, scales, zero_points)
    with full_precision():
        return torch.matmul(x.float(), w.t())


def reference_linear_qt(x: torch.Tensor, qt: QuantizedTensor, dtype=torch.float32):
    """Oracle for a QuantizedTensor of any granularity and layout:
    ``x @ dequant(W)^T``."""
    w = dequantize(qt, dtype=torch.float32)
    with full_precision():
        y = torch.matmul(x.float(), w.transpose(-1, -2))
    return y.to(dtype)
