"""INT4 weight quantization core (PyTorch).

Counterpart of ``fused4bit_tpu/quant/core.py`` for the per_row and
per_group granularities and the planar and planar_groups layouts, which is
what the serving paths run. The byte format is the JAX package's, unchanged,
so both packages read the same bytes:

* asymmetric affine quantization to ``[0, 15]``, per row or per group of
  ``group_size`` columns: ``q = clamp(round(w / scale + zero_point), 0, 15)``,
  ``w = (q - zero_point) * scale``, ``scale = (max - min) / 15``,
  ``zero_point = clamp(round(-min / scale), 0, 15)``, with the constant-row
  guard ``scale = clamp(|max|, 1) / 15`` and a 1e-8 floor;
* planar packing: byte c of a row holds column c in its low nibble and
  column c + K/2, XOR 8, in its high nibble;
* planar_groups: the planar bytes reordered group-major, ``[..., Gh, N, gs]``
  with ``Gh = K/2 / gs``: slab g holds group g of the low half and group g of
  the high half (group ``Gh + g`` of the row).

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
    "planar_to_planar_groups",
    "planar_groups_to_planar",
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


def planar_to_planar_groups(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Reorder planar bytes group-major: [..., N, K/2] -> [..., Gh, N, gs]."""
    *lead, n, k_half = packed.shape
    if k_half % group_size != 0:
        raise ValueError(f"K/2={k_half} not divisible by group_size={group_size}")
    p3 = packed.reshape(*lead, n, k_half // group_size, group_size)
    return p3.movedim(-2, -3).contiguous()


def planar_groups_to_planar(packed3: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`planar_to_planar_groups`."""
    *lead, gh, n, gs = packed3.shape
    return packed3.movedim(-3, -2).reshape(*lead, n, gh * gs)


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """An INT4-packed tensor plus its dequantization metadata.

    The fields of the JAX package's ``QuantizedTensor``: ``packed`` u8
    [..., N, K/2] (planar) or [..., Gh, N, gs] (planar_groups), ``scales``
    and ``zero_points`` f32 [..., N] (per_row) or [..., N, K/gs]
    (per_group), the logical ``shape`` [..., N, K], and the static
    ``granularity``, ``layout``, ``block_k``, ``group_size`` and ``bits``.
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
    group_size: int = 128,
) -> QuantizedTensor:
    """Quantize a weight tensor [..., N, K] to packed INT4.

    ``granularity``: "per_row" or "per_group" (``group_size`` columns per
    scale); ``layout``: "planar" or, for per_group with ``gs | K/2``,
    "planar_groups". per_tensor and the interleaved layouts are not ported.
    """
    if granularity not in ("per_row", "per_group"):
        raise NotImplementedError(f"granularity {granularity!r} is not ported")
    if layout not in ("planar", "planar_groups"):
        raise NotImplementedError(f"layout {layout!r} is not ported")
    if w.dim() < 2:
        raise ValueError("weight must be at least 2D [..., out_dim, in_dim]")
    k = w.shape[-1]
    if k % 2 != 0:
        raise ValueError("input_dim must be even for nibble packing")
    max_val = (1 << bits) - 1
    w = w.float()
    if granularity == "per_row":
        scales, zp = _affine_params(w, dim=-1, max_val=max_val)
        q = torch.round(w / scales[..., None] + zp[..., None])
    else:
        if k % group_size != 0:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        wg = w.reshape(*w.shape[:-1], k // group_size, group_size)
        scales, zp = _affine_params(wg, dim=-1, max_val=max_val)
        q = torch.round(wg / scales[..., None] + zp[..., None]).reshape(w.shape)
    packed = pack_planar(torch.clamp(q, 0, max_val).to(torch.uint8))
    if layout == "planar_groups":
        if granularity != "per_group":
            raise ValueError("planar_groups layout requires per_group granularity")
        if (k // 2) % group_size != 0:
            raise ValueError(f"group_size={group_size} must divide K/2={k // 2} "
                             "(groups may not straddle the planar halves)")
        packed = planar_to_planar_groups(packed, group_size)
    return QuantizedTensor(
        packed=packed,
        scales=scales,
        zero_points=zp,
        shape=tuple(w.shape),
        granularity=granularity,
        layout=layout,
        block_k=k,
        group_size=group_size if granularity == "per_group" else 0,
        bits=bits,
    )


def _unpack(qt: QuantizedTensor) -> torch.Tensor:
    if qt.layout == "planar":
        return unpack_planar(qt.packed)
    if qt.layout == "planar_groups":
        return unpack_planar(planar_groups_to_planar(qt.packed))
    raise NotImplementedError(f"layout {qt.layout!r} is not ported")


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense weight [..., N, K]."""
    q = _unpack(qt).float()
    if qt.granularity == "per_row":
        return ((q - qt.zero_points[..., None]) * qt.scales[..., None]).to(dtype)
    if qt.granularity != "per_group":
        raise NotImplementedError(f"granularity {qt.granularity!r} is not ported")
    gs = qt.group_size
    qg = q.reshape(*q.shape[:-1], q.shape[-1] // gs, gs)
    w = (qg - qt.zero_points[..., None]) * qt.scales[..., None]
    return w.reshape(q.shape).to(dtype)
