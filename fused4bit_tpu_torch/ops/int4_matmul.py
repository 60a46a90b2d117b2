"""INT4 weight-only linear, ``x @ dequant(W)^T``, over kernel K1.

Counterpart of ``fused4bit_tpu/ops/int4_matmul.py:int4_matmul``. On a CUDA
tensor the wrapper launches ``csrc/int4_matmul.cu`` (the port of the TPU
kernel ``_int4_matmul_kernel``); on a CPU tensor it runs the plain version,
:func:`int4_matmul_reference`. Above ``prefill_threshold`` rows the product
is compute-bound, and, as in the JAX package, it is computed outside any
kernel: dequantize once, then a dense matmul.
"""
from __future__ import annotations

import torch

from ..quant.core import QuantizedTensor, dequantize
from ..quant.reference import reference_linear_qt
from . import _build

__all__ = ["int4_matmul", "int4_matmul_reference"]

_KERNELS = {torch.bfloat16: "f4b_int4_matmul_bf16", torch.float32: "f4b_int4_matmul_f32"}


def int4_matmul_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K1: dequantize, then a float32 matmul; x.dtype out."""
    int4_matmul_reference.calls += 1
    return reference_linear_qt(x, qt, dtype=x.dtype)


int4_matmul_reference.calls = 0


def _check_qt(qt: QuantizedTensor) -> None:
    if qt.granularity != "per_row":
        raise NotImplementedError(
            f"the fused kernel supports per_row scales; got {qt.granularity}"
        )
    if qt.layout != "planar":
        raise ValueError(f"the kernel requires the planar layout; got {qt.layout}")


def _launch(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    m, k = x2.shape
    n = qt.out_dim
    if x2.dtype not in _KERNELS:
        raise TypeError(f"K1 takes bf16 or f32 activations, got {x2.dtype}")
    if k % 32 != 0:
        raise ValueError(f"K1 needs K % 32 == 0 (16-byte packed rows), got K={k}")
    for name, t, dtype in (
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t.device != x2.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x2.device}")
    if tuple(qt.packed.shape) != (n, k // 2):
        raise ValueError(f"packed shape {tuple(qt.packed.shape)} != {(n, k // 2)}")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):
        err = getattr(_build.library(), _KERNELS[x2.dtype])(
            x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
            qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, _build.stream_of(x2),
        )
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return y


def int4_matmul(
    x: torch.Tensor, qt: QuantizedTensor, *, prefill_threshold: int = 512
) -> torch.Tensor:
    """``x @ dequant(qt)^T`` without materializing the dense weight.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N]
    in x.dtype. Rows above ``prefill_threshold`` dequantize once and run a
    dense matmul in x.dtype with float32 accumulation.
    """
    _check_qt(qt)
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m > prefill_threshold:
        wd = dequantize(qt, dtype=x.dtype)
        return torch.matmul(x2, wd.t()).reshape(*lead, n)
    if not x.is_cuda:
        return int4_matmul_reference(x2, qt).reshape(*lead, n)
    if m == 0:
        return x.new_empty((*lead, n))
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x with 16-byte loads
        x2 = x2.clone()
    return _launch(x2, qt).reshape(*lead, n)


int4_matmul.launches = 0
