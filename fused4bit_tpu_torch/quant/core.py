"""INT4 weight quantization core (PyTorch).

Counterpart of ``fused4bit_tpu/quant/core.py`` for the per_row granularity
and the planar layout, which is what the serving path runs. The byte format
is the JAX package's, unchanged, so both packages read the same bytes:

* asymmetric affine quantization to ``[0, 15]``:
  ``q = clamp(round(w / scale + zero_point), 0, 15)``,
  ``w = (q - zero_point) * scale``, ``scale = (max - min) / 15``,
  ``zero_point = clamp(round(-min / scale), 0, 15)``, with the constant-row
  guard ``scale = clamp(|max|, 1) / 15`` and a 1e-8 floor;
* planar packing: byte c of a row holds column c in its low nibble and
  column c + K/2, XOR 8, in its high nibble.

``torch.round`` rounds half to even like ``jnp.round``, so the codes match
the JAX package byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "pack_planar",
    "unpack_planar",
]


def _affine_params(w: torch.Tensor, dim: int, max_val: int):
    """scale/zp over ``dim`` with the reference's constant-row guard."""
    w_min = torch.amin(w, dim=dim)
    w_max = torch.amax(w, dim=dim)
    # Divide by a tensor, not a Python scalar: CUDA multiplies by the
    # scalar's reciprocal, which rounds differently from the CPU and JAX.
    mv = torch.full_like(w_max, float(max_val))
    scales = (w_max - w_min) / mv
    # A constant slice would give scale 0 and divide by zero: use
    # clamp(|max|, 1) / max_val instead.
    constant = w_max == w_min
    safe = torch.where(constant, torch.clamp(w_max.abs(), min=1.0) / mv, scales)
    safe = torch.clamp(safe, min=1e-8)
    zp = torch.clamp(torch.round(-w_min / safe), 0.0, float(max_val))
    return safe.float(), zp.float()


def pack_planar(q: torch.Tensor) -> torch.Tensor:
    """Pack nibbles [..., K] -> [..., K/2] u8, planar with the XOR-8 high nibble."""
    k = q.shape[-1]
    if k % 2 != 0:
        raise ValueError(f"K={k} must be even")
    half = k // 2
    lo = q[..., :half].to(torch.uint8)
    hi = q[..., half:].to(torch.uint8) ^ 0x8
    return (hi << 4) | lo


def unpack_planar(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_planar`: [..., K/2] u8 -> [..., K] u8."""
    lo = packed & 0x0F
    hi = (packed >> 4) ^ 0x8
    return torch.cat([lo, hi], dim=-1)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """An INT4-packed tensor plus its dequantization metadata.

    The fields of the JAX package's ``QuantizedTensor``: ``packed`` u8
    [..., N, K/2], per-row ``scales`` and ``zero_points`` f32 [..., N], the
    logical ``shape`` [..., N, K], and the static ``granularity``,
    ``layout``, ``block_k``, ``group_size`` and ``bits``. Only per_row /
    planar tensors are produced by this package.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zero_points: torch.Tensor
    shape: Tuple[int, ...]
    granularity: str = "per_row"
    layout: str = "planar"
    block_k: int = 0
    group_size: int = 0
    bits: int = 4

    @property
    def out_dim(self) -> int:
        return self.shape[-2]

    @property
    def in_dim(self) -> int:
        return self.shape[-1]


def quantize(
    w: torch.Tensor,
    *,
    bits: int = 4,
    granularity: str = "per_row",
    layout: str = "planar",
) -> QuantizedTensor:
    """Quantize a weight tensor [..., N, K] to packed INT4 (per_row, planar)."""
    if granularity != "per_row" or layout != "planar":
        raise NotImplementedError(
            f"only per_row/planar is ported; got {granularity}/{layout}"
        )
    if w.dim() < 2:
        raise ValueError("weight must be at least 2D [..., out_dim, in_dim]")
    k = w.shape[-1]
    if k % 2 != 0:
        raise ValueError("input_dim must be even for nibble packing")
    max_val = (1 << bits) - 1
    w = w.float()
    scales, zp = _affine_params(w, dim=-1, max_val=max_val)
    q = torch.clamp(torch.round(w / scales[..., None] + zp[..., None]), 0, max_val)
    return QuantizedTensor(
        packed=pack_planar(q.to(torch.uint8)),
        scales=scales,
        zero_points=zp,
        shape=tuple(w.shape),
        block_k=k,
        bits=bits,
    )


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense weight [..., N, K]."""
    if qt.granularity != "per_row" or qt.layout != "planar":
        raise NotImplementedError(
            f"only per_row/planar is ported; got {qt.granularity}/{qt.layout}"
        )
    q = unpack_planar(qt.packed).float()
    return ((q - qt.zero_points[..., None]) * qt.scales[..., None]).to(dtype)
