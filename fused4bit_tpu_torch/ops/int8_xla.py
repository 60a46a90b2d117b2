"""INT4-valued weights in int8 containers, multiplied by integer GEMMs.

Counterpart of ``fused4bit_tpu/ops/int8_xla.py``, and home of the per-row
symmetric int8 activation quantizer that the w4a8 kernels' plain versions
share (K4, K10; K5, K11, K8 and K14 with ``fused=True``): the kernels
repeat it in the int8 body's first pass (``csrc/int8_mma.cuh``), and K8 and
K14 at group sizes that body does not take take its output. Two weight
forms:

* resident (``Int8Resident``, ``to_int8_resident``): the codes shifted by
  their zero point, ``q - zp`` in [-15, 15], kept permanently as i8 (2x the
  packed bytes) — the ``as_xla_turbo`` mode;
* transient (``int4_linear_transient``, ``int4_grouped_transient``): the
  packed u4 weights unpacked per call into a temporary i8 tensor — the
  prefill regime of the ``as_u4_turbo`` mode.

Either way ``y = (f32(xq @ w8^T) * sx) * s`` with an exact int32 product,
``s`` per row (per_row weights) or one per tensor (per_tensor weights, on
the transient path). The JAX package leaves that product to XLA, outside any
Pallas kernel; here it is ``torch._int_mm`` (a library GEMM, as XLA's is),
which on CUDA needs more than 16 rows and widths that are multiples of
:data:`ROW_MULTIPLE`: :func:`_int_dot` pads.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..quant.core import QuantizedTensor, dequantize, unpack_planar

__all__ = [
    "Int8Resident", "to_int8_resident", "int8_linear", "int8_grouped_capacity",
    "int4_linear_transient", "int4_grouped_transient", "ROW_MULTIPLE",
]

# torch._int_mm on CUDA takes widths that are multiples of this: _int_dot
# pads each call's weight rows to it, unless
# QuantizedLinear.padded_for_kernel padded them once at conversion.
ROW_MULTIPLE = 8


@dataclasses.dataclass(frozen=True)
class Int8Resident:
    """Int4-valued weights stored zero-point-shifted in i8.

    q8: [..., N, K] i8, values q - zp in [-15, 15]; scales: [..., N] f32.
    """

    q8: torch.Tensor
    scales: torch.Tensor

    @property
    def nbytes(self) -> int:
        return self.q8.numel() + self.scales.numel() * self.scales.element_size()

    @property
    def out_dim(self) -> int:
        return self.q8.shape[-2]

    @property
    def in_dim(self) -> int:
        return self.q8.shape[-1]


def to_int8_resident(qt: QuantizedTensor) -> Int8Resident:
    """Packed-u4 per-row weights -> the i8-resident form, by JAX's formula
    ``round(dequant(W) / s)`` (exact: zp is integer-valued)."""
    if qt.granularity != "per_row":
        raise ValueError("int8-resident conversion requires per_row scales")
    wd = dequantize(qt, dtype=torch.float32)
    q8 = torch.round(wd / qt.scales[..., None]).to(torch.int8)
    return Int8Resident(q8=q8, scales=qt.scales.float())


def _quantize_acts(x: torch.Tensor, *, fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``sx = max(amax, 1e-8) / 127``,
    ``xq = clamp(round(x / sx), -127, 127)``; returns (xq i8, sx f32 [..., 1]).

    ``fused=False`` is the host quantizer of the JAX package, run op by op:
    a true division by 127. ``fused=True`` is the prologue of its fused
    kernels (K5, K11), which XLA compiles with the division by the constant
    folded into a multiply by f32(1/127); sx then differs in the last bit for
    some rows. Both divide x by a tensor, never by a Python scalar, which on
    CUDA is a multiply by the reciprocal. ``torch.round`` rounds half to
    even, as ``jnp.round``.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8)
    if fused:
        sx = amax * torch.full_like(amax, 1.0 / 127.0)
    else:
        sx = amax / torch.full_like(amax, 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def _int_dot(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact ``xq [M, K] i8 @ w8 [N, K]^T`` -> [M, N] i32.

    On CUDA ``torch._int_mm`` takes M > 16 and K, N multiples of 8: rows and
    weight rows are zero-padded and the result sliced back."""
    m, k = xq.shape
    n = w8.shape[0]
    if not xq.is_cuda:
        return torch._int_mm(xq, w8.t())
    if k % ROW_MULTIPLE:
        raise ValueError(f"the int8 GEMM needs K % 8 == 0, got K={k}")
    m_pad = max(32, -(-m // ROW_MULTIPLE) * ROW_MULTIPLE)
    n_pad = -(-n // ROW_MULTIPLE) * ROW_MULTIPLE
    if m_pad != m:
        xq = F.pad(xq, (0, 0, 0, m_pad - m))
    if n_pad != n:
        w8 = F.pad(w8, (0, 0, 0, n_pad - n))
    return torch._int_mm(xq.contiguous(), w8.t())[:m, :n]


def int8_linear(x: torch.Tensor, w: Int8Resident) -> torch.Tensor:
    """``x @ dequant(W)^T`` from the resident i8 copy. x: [..., K] -> [..., N]."""
    int8_linear.calls += 1
    xq, sx = _quantize_acts(x)
    k = x.shape[-1]
    acc = _int_dot(xq.reshape(-1, k), w.q8).reshape(*x.shape[:-1], -1)
    return (acc.float() * sx * w.scales).to(x.dtype)


int8_linear.calls = 0


def int8_grouped_capacity(xe: torch.Tensor, w: Int8Resident) -> torch.Tensor:
    """Per-expert product on the capacity layout: xe [E, C, K], w.q8
    [E, N, K] -> [E, C, N]."""
    int8_grouped_capacity.calls += 1
    xq, sx = _quantize_acts(xe)
    acc = torch.stack([_int_dot(xq[e], w.q8[e]) for e in range(xe.shape[0])])
    return (acc.float() * sx * w.scales[:, None, :]).to(xe.dtype)


int8_grouped_capacity.calls = 0


def _transient_w8(qt: QuantizedTensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar per_row or per_tensor weights -> (w8 = q - zp [..., N, K] i8,
    scales f32 [..., N] per row, [..., 1] per tensor)."""
    if qt.layout != "planar" or qt.granularity not in ("per_row", "per_tensor"):
        raise ValueError("transient unpack requires per_row or per_tensor planar weights")
    codes = unpack_planar(qt.packed).to(torch.int8)
    zp8 = torch.round(qt.zero_points).to(torch.int8)[..., None]
    if qt.granularity == "per_tensor":
        zp8 = zp8[..., None]
    return codes - zp8, _row_scales(qt)


def _row_scales(qt: QuantizedTensor) -> torch.Tensor:
    """The scales as factors over the output rows: f32 [..., N] per row,
    [..., 1] per tensor."""
    s = qt.scales.float()
    return s[..., None] if qt.granularity == "per_tensor" else s


def int4_linear_transient(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(W)^T`` with packed residency: the weights are unpacked to
    a per-call i8 tensor, then one integer GEMM (numerics of int8_linear)."""
    int4_linear_transient.calls += 1
    w8, ws = _transient_w8(qt)
    xq, sx = _quantize_acts(x)
    k = x.shape[-1]
    acc = _int_dot(xq.reshape(-1, k), w8).reshape(*x.shape[:-1], -1)
    return (acc.float() * sx * ws).to(x.dtype)


int4_linear_transient.calls = 0


def int4_grouped_transient(xe: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Capacity-layout expert product with packed residency: xe [E, C, K],
    qt [E, N, K] -> [E, C, N], one expert's transient i8 weights at a time."""
    int4_grouped_transient.calls += 1
    xq, sx = _quantize_acts(xe)
    accs = []
    for e in range(xe.shape[0]):
        w8, _ = _transient_w8(dataclasses.replace(
            qt, packed=qt.packed[e], scales=qt.scales[e], zero_points=qt.zero_points[e],
            shape=tuple(qt.shape[1:])))
        accs.append(_int_dot(xq[e], w8))
    return (torch.stack(accs).float() * sx * _row_scales(qt)[:, None, :]).to(xe.dtype)


int4_grouped_transient.calls = 0
