"""INT4 weight-only linear, ``x @ dequant(W)^T``, over kernels K1, K4, K5.

Counterpart of ``fused4bit_tpu/ops/int4_matmul.py``:

* ``int4_matmul`` (w4a16): on a CUDA tensor it launches
  ``csrc/int4_matmul.cu`` (the port of the TPU kernel
  ``_int4_matmul_kernel``); on a CPU tensor it runs the plain version,
  :func:`int4_matmul_reference`. Above ``prefill_threshold`` rows the product
  is compute-bound, and, as in the JAX package, it is computed outside any
  kernel: dequantize once, then a dense matmul.
* ``int4_matmul_a8`` (w4a8): per-row int8 activations and an exact integer
  dot. On a CUDA tensor it launches ``csrc/int4_matmul_a8.cu``: K4 (the port
  of ``_int4_a8_kernel``) on activations quantized by
  :func:`~.int8_xla._quantize_acts`, or K5 (the port of
  ``_int4_a8_fused_kernel``) which quantizes inside the kernel. On a CPU
  tensor it runs :func:`int4_matmul_a8_reference`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize, unpack_planar
from ..quant.reference import reference_linear_qt
from . import _build
from .int8_xla import _quantize_acts

__all__ = ["int4_matmul", "int4_matmul_reference", "int4_matmul_a8", "int4_matmul_a8_reference"]

_KERNELS = {torch.bfloat16: "f4b_int4_matmul_bf16", torch.float32: "f4b_int4_matmul_f32"}
_A8_KERNELS = {torch.bfloat16: "f4b_int4_matmul_a8_bf16", torch.float32: "f4b_int4_matmul_a8_f32"}
_A8_FUSED_KERNELS = {
    torch.bfloat16: "f4b_int4_matmul_a8_fused_bf16",
    torch.float32: "f4b_int4_matmul_a8_fused_f32",
}
# The JAX fuse gate (int4_matmul.py:1289-1299), kept as it stands: fuse the
# quantization at K <= 2 * _SHALLOW_KH while the raw-x block and its i8 copy
# fit 4 MiB. It only moves time; re-deriving it for the H100 is later work.
_SHALLOW_KH = 3072


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


def _check_operands(x2: torch.Tensor, qt: QuantizedTensor, kernels, what: str) -> None:
    m, k = x2.shape
    n = qt.out_dim
    if x2.dtype not in kernels:
        raise TypeError(f"{what} takes bf16 or f32 activations, got {x2.dtype}")
    if k % 32 != 0:
        raise ValueError(f"{what} needs K % 32 == 0 (16-byte packed rows), got K={k}")
    for name, t, dtype in (
        ("packed", qt.packed, torch.uint8),
        ("scales", qt.scales, torch.float32),
        ("zero_points", qt.zero_points, torch.float32),
    ):
        if t.device != x2.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x2.device}")
    if tuple(qt.packed.shape) != (n, k // 2):
        raise ValueError(f"packed shape {tuple(qt.packed.shape)} != {(n, k // 2)}")


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    x2 = x2.contiguous()
    return x2.clone() if x2.data_ptr() % 16 else x2  # the kernels read x with 16-byte loads


def _launch(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    _check_operands(x2, qt, _KERNELS, "K1")
    m, k = x2.shape
    n = qt.out_dim
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
    return _launch(_aligned(x2), qt).reshape(*lead, n)


int4_matmul.launches = 0


def _a8_product(xq: torch.Tensor, sx: torch.Tensor, packed: torch.Tensor,
               scales: torch.Tensor, zero_points: torch.Tensor) -> torch.Tensor:
    """The w4a8 product in plain torch, f32 out: ``(s * sx) * (f32(xq . q) -
    zp * f32(sum(xq)))`` with q the 4-bit codes of the planar bytes.

    The dot runs in float64, which is exact here (every sum stays far below
    2^53), and equals the TPU kernel's int32 ``acc + 8 * xsum_hi``; the f32
    epilogue is JAX's, operation by operation."""
    q = unpack_planar(packed).double()                       # [N, K] codes 0..15
    acc = xq.double() @ q.t()
    xsum = xq.double().sum(dim=-1, keepdim=True)
    yq = acc.float() - zero_points.float()[None, :] * xsum.float()
    return scales.float()[None, :] * sx * yq


def int4_matmul_a8_reference(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: bool = False
) -> torch.Tensor:
    """Plain version of K4 and K5: quantize (with K5's quantizer when
    ``fuse_quant``, see :func:`~.int8_xla._quantize_acts`), exact dot, JAX's
    epilogue; x.dtype out."""
    int4_matmul_a8_reference.calls += 1
    xq, sx = _quantize_acts(x, fused=fuse_quant)
    return _a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points).to(x.dtype)


int4_matmul_a8_reference.calls = 0


def int4_matmul_a8(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: Optional[bool] = None
) -> torch.Tensor:
    """w4a8 linear: per-row int8 activations, exact integer dot.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N] in
    x.dtype, at every row count (no dequantize fallback, as in JAX).
    ``fuse_quant``: quantize inside the kernel (K5) rather than before it
    (K4); None applies the JAX gate. On a CPU tensor the plain version runs
    with the quantizer of the kernel that ``fuse_quant`` picks.
    """
    _check_qt(qt)
    n, k = qt.out_dim, qt.in_dim
    if x.shape[-1] != k:
        raise ValueError(f"x.shape[-1]={x.shape[-1]} != K={k}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if fuse_quant is None:
        tile_m = min(-(-max(m, 1) // 32) * 32, 256)
        fuse_quant = (k <= 2 * _SHALLOW_KH
                      and tile_m * k * (x.element_size() + 1) <= 4 * 1024 * 1024)
    if not x.is_cuda:
        return int4_matmul_a8_reference(x2, qt, fuse_quant=fuse_quant).reshape(*lead, n)
    if m == 0:
        return x.new_empty((*lead, n))
    x2 = _aligned(x2)
    kernels = _A8_FUSED_KERNELS if fuse_quant else _A8_KERNELS
    _check_operands(x2, qt, kernels, "K5" if fuse_quant else "K4")
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        if fuse_quant:
            err = getattr(lib, kernels[x2.dtype])(
                x2.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, _build.stream_of(x2),
            )
        else:
            xq, sx = _quantize_acts(x2)
            err = getattr(lib, kernels[x2.dtype])(
                xq.data_ptr(), sx.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                qt.zero_points.data_ptr(), y.data_ptr(), m, n, k, _build.stream_of(x2),
            )
    _build.check(err, "int4_matmul_a8")
    if fuse_quant:
        int4_matmul_a8.fused_launches += 1
    else:
        int4_matmul_a8.launches += 1
    return y.reshape(*lead, n)


int4_matmul_a8.launches = 0        # K4
int4_matmul_a8.fused_launches = 0  # K5
