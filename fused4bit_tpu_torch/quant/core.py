"""INT4 weight quantization core (PyTorch).

Counterpart of ``fused4bit_tpu/quant/core.py``: every granularity and
layout of the JAX package, in its byte format, unchanged, so both packages
read the same bytes:

* asymmetric affine quantization to ``[0, 15]``:
  ``q = clamp(round(w / scale + zero_point), 0, 15)``,
  ``w = (q - zero_point) * scale``, ``scale = (max - min) / 15``,
  ``zero_point = clamp(round(-min / scale), 0, 15)``, with the constant-row
  guard ``scale = clamp(|max|, 1) / 15`` and a 1e-8 floor;
* granularities: ``per_row`` (one scale per output row), ``per_tensor`` (one
  scalar per leading index, over the trailing [N, K]: one per expert of a
  stack, as the reference library's MoE quantizer) and ``per_group`` (one
  per group of ``group_size`` columns of a row);
* planar packing: byte c of a row holds column c in its low nibble and
  column c + K/2, XOR 8, in its high nibble (the kernels' layout);
* planar_groups: the planar bytes reordered group-major, ``[..., Gh, N, gs]``
  with ``Gh = K/2 / gs``: slab g holds group g of the low half and group g of
  the high half (group ``Gh + g`` of the row);
* interleaved: byte j holds columns 2j (low nibble) and 2j + 1 (high
  nibble), the reference library's own format;
* block_planar: within each block of ``block_k`` columns, byte j holds
  columns j (low nibble) and j + block_k/2 (high nibble), without the XOR.

``torch.round`` rounds half to even like ``jnp.round``, and every division
is by a tensor, so the codes match the JAX package byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "pad_rows",
    "quantize_weights",
    "dequantize_weights",
    "pack_interleaved",
    "unpack_interleaved",
    "pack_block_planar",
    "unpack_block_planar",
    "pack_planar",
    "unpack_planar",
    "interleaved_to_planar",
    "interleaved_to_block_planar",
    "planar_to_planar_groups",
    "planar_groups_to_planar",
    "choose_block_k",
    "DEFAULT_BLOCK_K",
]

# The JAX package's canonical k-tile of the block_planar layout.
DEFAULT_BLOCK_K = 512


def choose_block_k(k: int, preferred: int = DEFAULT_BLOCK_K) -> int:
    """Largest of (preferred, 1024, 512, 256, 128) at or below ``preferred``
    that divides K, else K itself (K must be even)."""
    if k % 2 != 0:
        raise ValueError(f"input dim must be even for nibble packing, got {k}")
    for cand in (preferred, 1024, 512, 256, 128):
        if cand <= preferred and k % cand == 0:
            return cand
    return k


def _affine_params(w: torch.Tensor, dim, max_val: int):
    """scale/zp over ``dim`` (an int or a tuple) with the reference's
    constant-row guard."""
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


def pack_interleaved(q: torch.Tensor) -> torch.Tensor:
    """Pack nibbles [..., K] -> [..., K/2] u8 in the reference layout: byte j
    holds column 2j in its low nibble and column 2j + 1 in its high one."""
    return (q[..., 1::2].to(torch.uint8) << 4) | q[..., 0::2].to(torch.uint8)


def unpack_interleaved(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_interleaved`: [..., K/2] u8 -> [..., K] u8."""
    out = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_block_planar(q: torch.Tensor, block_k: int) -> torch.Tensor:
    """Pack nibbles [..., K] -> [..., K/2] u8: within each block of
    ``block_k`` columns, byte j holds column j (low nibble) and column
    j + block_k/2 (high nibble)."""
    *lead, k = q.shape
    if k % block_k != 0:
        raise ValueError(f"K={k} not divisible by block_k={block_k}")
    blocks = q.to(torch.uint8).reshape(*lead, k // block_k, 2, block_k // 2)
    return ((blocks[..., 1, :] << 4) | blocks[..., 0, :]).reshape(*lead, k // 2)


def unpack_block_planar(packed: torch.Tensor, block_k: int) -> torch.Tensor:
    """Inverse of :func:`pack_block_planar`: [..., K/2] u8 -> [..., K] u8."""
    *lead, kh = packed.shape
    half = block_k // 2
    if kh % half != 0:
        raise ValueError(f"packed dim {kh} not divisible by block_k/2={half}")
    blocks = packed.reshape(*lead, kh // half, half)
    return torch.stack([blocks & 0x0F, blocks >> 4], dim=-2).reshape(*lead, kh * 2)


def interleaved_to_block_planar(packed: torch.Tensor, block_k: int) -> torch.Tensor:
    """Re-pack reference-layout bytes into the block_planar layout."""
    return pack_block_planar(unpack_interleaved(packed), block_k)


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


def interleaved_to_planar(packed: torch.Tensor) -> torch.Tensor:
    """Re-pack reference-layout bytes into the kernels' planar layout."""
    return pack_planar(unpack_interleaved(packed))


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
    [..., N, K/2] (planar_groups: [..., Gh, N, gs]), ``scales`` and
    ``zero_points`` f32 [..., N] (per_row), [...] (per_tensor) or
    [..., N, K/gs] (per_group), the logical ``shape`` [..., N, K], and the
    static ``granularity``, ``layout``, ``block_k`` (block_planar's block;
    K for planar and planar_groups, 0 for interleaved), ``group_size`` and
    ``bits``.
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

    @property
    def nbytes(self) -> int:
        """Bytes held: packed weights, scales and zero points."""
        return sum(t.numel() * t.element_size()
                   for t in (self.packed, self.scales, self.zero_points))

    def memory_reduction_vs(self, dtype=torch.float32) -> float:
        """The dense [..., N, K] tensor's bytes in ``dtype`` over :attr:`nbytes`."""
        dense = torch.tensor([], dtype=dtype).element_size()
        for d in self.shape:
            dense *= d
        return dense / self.nbytes


def quantize(
    w: torch.Tensor,
    *,
    bits: int = 4,
    granularity: str = "per_row",
    layout: str = "planar",
    group_size: int = 128,
    block_k: Optional[int] = None,
) -> QuantizedTensor:
    """Quantize a weight tensor [..., N, K] to packed INT4.

    ``granularity``: "per_row", "per_tensor" or "per_group" (``group_size``
    columns per scale); ``layout``: "planar", "planar_groups" (per_group with
    ``gs | K/2``), "interleaved" or "block_planar" (blocks of ``block_k``
    columns, K by default; per_group needs block and group to nest).
    """
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
    elif granularity == "per_tensor":
        scales, zp = _affine_params(w, dim=(-2, -1), max_val=max_val)
        q = torch.round(w / scales[..., None, None] + zp[..., None, None])
    elif granularity == "per_group":
        if k % group_size != 0:
            raise ValueError(f"K={k} not divisible by group_size={group_size}")
        wg = w.reshape(*w.shape[:-1], k // group_size, group_size)
        scales, zp = _affine_params(wg, dim=-1, max_val=max_val)
        q = torch.round(wg / scales[..., None] + zp[..., None]).reshape(w.shape)
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    q = torch.clamp(q, 0, max_val).to(torch.uint8)
    bk = k
    if layout == "planar":
        packed = pack_planar(q)
    elif layout == "planar_groups":
        if granularity != "per_group":
            raise ValueError("planar_groups layout requires per_group granularity")
        if (k // 2) % group_size != 0:
            raise ValueError(f"group_size={group_size} must divide K/2={k // 2} "
                             "(groups may not straddle the planar halves)")
        packed = planar_to_planar_groups(pack_planar(q), group_size)
    elif layout == "interleaved":
        bk = block_k or 0
        packed = pack_interleaved(q)
    elif layout == "block_planar":
        bk = block_k or k
        if granularity == "per_group" and bk % group_size != 0 and group_size % bk != 0:
            raise ValueError(f"block_k={bk} and group_size={group_size} must nest")
        packed = pack_block_planar(q, bk)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return QuantizedTensor(
        packed=packed,
        scales=scales,
        zero_points=zp,
        shape=tuple(w.shape),
        granularity=granularity,
        layout=layout,
        block_k=bk,
        group_size=group_size if granularity == "per_group" else 0,
        bits=bits,
    )


def pad_rows(qt: QuantizedTensor, multiple: int) -> QuantizedTensor:
    """Pad the output-row dim N up to a multiple of ``multiple``, once, at
    conversion time. Padded rows have scale and zero point 0, so they
    dequantize to exact zeros; callers slice outputs back to the logical
    rows (``QuantizedLinear.out_features``). per_tensor raises, as in JAX:
    its scalar scale would not zero the padded rows."""
    n = qt.shape[-2]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return qt
    if qt.granularity == "per_row":
        scale_row_axis = qt.scales.dim() - 1
    elif qt.granularity == "per_group":
        scale_row_axis = qt.scales.dim() - 2
    else:
        raise NotImplementedError("pad_rows supports per_row/per_group granularities")

    def pad(t: torch.Tensor, axis: int) -> torch.Tensor:
        widths = [0, 0] * (t.dim() - 1 - axis) + [0, n_pad - n]
        return torch.nn.functional.pad(t, widths)

    return dataclasses.replace(
        qt,
        packed=pad(qt.packed, qt.packed.dim() - 2),
        scales=pad(qt.scales, scale_row_axis),
        zero_points=pad(qt.zero_points, scale_row_axis),
        shape=tuple(qt.shape[:-2]) + (n_pad, qt.shape[-1]),
    )


def _unpack(qt: QuantizedTensor) -> torch.Tensor:
    if qt.layout == "interleaved":
        return unpack_interleaved(qt.packed)
    if qt.layout == "planar":
        return unpack_planar(qt.packed)
    if qt.layout == "planar_groups":
        return unpack_planar(planar_groups_to_planar(qt.packed))
    return unpack_block_planar(qt.packed, qt.block_k)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense weight [..., N, K]."""
    q = _unpack(qt).float()
    if qt.granularity == "per_row":
        return ((q - qt.zero_points[..., None]) * qt.scales[..., None]).to(dtype)
    if qt.granularity == "per_tensor":
        return ((q - qt.zero_points[..., None, None]) * qt.scales[..., None, None]).to(dtype)
    gs = qt.group_size
    qg = q.reshape(*q.shape[:-1], q.shape[-1] // gs, gs)
    w = (qg - qt.zero_points[..., None]) * qt.scales[..., None]
    return w.reshape(q.shape).to(dtype)


def quantize_weights(w: torch.Tensor, num_bits: int = 4):
    """The reference library's entry point: per-row quantization of [N, K]
    in its interleaved layout; returns (packed u8 [N, K/2], scales [N],
    zero_points [N])."""
    qt = quantize(w, bits=num_bits, granularity="per_row", layout="interleaved")
    return qt.packed, qt.scales, qt.zero_points


def dequantize_weights(packed: torch.Tensor, scales: torch.Tensor,
                       zero_points: torch.Tensor) -> torch.Tensor:
    """The reference library's inverse of :func:`quantize_weights`: f32 [N, K]."""
    q = unpack_interleaved(packed).float()
    return (q - zero_points[..., None]) * scales[..., None]
