"""INT4-quantized KV cache, sequence-pair-packed.

Counterpart of ``fused4bit_tpu/layers/kv_cache.py``, with the same bytes:

* ``k_packed``/``v_packed`` [B, H_kv, S/2, D] u8: byte (s', d) holds position
  2s' in its low nibble and position 2s'+1, XOR 8, in its high nibble;
* ``k_scale``/``k_zp``/``v_scale``/``v_zp`` [B, H_kv, S] f32, per position;
* ``lengths`` [B] i32, the filled positions of each slot.

Quantization is the weight quantizer's affine spec per (head, position)
vector over head_dim. Unlike the JAX cache, which is immutable, this one is
updated IN PLACE: :meth:`QuantizedKVCache.append`, :meth:`reset_slot` and
:meth:`merge_slot` write into the existing tensors and return ``self``, and
:meth:`slice_slot` returns views that share memory with the full cache.

A window layer's cache (``window`` > 0, built by :meth:`QuantizedKVCache.init`
with a window) is a ring: it holds ``max_seq`` slots, sized to the window
plus the longest multi-token forward its caller declares, and position p
lies in slot ``p % max_seq``. ``lengths`` still counts positions, so it
grows past the ring; an append longer than the ring keeps its last
positions. Attention masks each key by the position its slot holds
(:meth:`QuantizedKVCache.positions`) to ``q - window < p <= q``.

:class:`LatentKVCache` is the second kind: multi-head latent attention's
cache (DeepSeek-V3's). It holds one latent vector ``c_KV`` a position, in the
same INT4 per-vector format with one head (pair-packed codes, a scale and a
zero point per position), and beside it the position's RoPE key ``k_pe`` in
bf16, unquantized, as DeepSeek's own FP8 cache keeps those dimensions. It is
updated in place like the other and has the same slot methods.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import resolve_device
from ..quant.core import _affine_params, pack_planar, unpack_planar

__all__ = ["QuantizedKVCache", "LatentKVCache", "quantize_kv", "dequantize_kv"]

_MAXQ = 15


def _affine(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-vector codes q in [0, 15] (u8), scale and zp (f32). x: [..., D]."""
    x = x.float()
    scale, zp = _affine_params(x, dim=-1, max_val=_MAXQ)
    q = torch.clamp(torch.round(x / scale[..., None] + zp[..., None]), 0, _MAXQ)
    return q.to(torch.uint8), scale, zp


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize [..., D] vectors to INT4 packed planar along D, with a
    scale and zero point per vector: (packed u8 [..., D/2], scale, zp f32
    [...]). The generic per-vector packer; the cache itself packs pairs of
    positions."""
    q, scale, zp = _affine(x)
    return pack_planar(q), scale, zp


def dequantize_kv(packed: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: [..., D/2] u8 -> [..., D]."""
    q = unpack_planar(packed).float()
    return ((q - zp[..., None]) * scale[..., None]).to(dtype)


def _unpack_pairs(packed: torch.Tensor) -> torch.Tensor:
    """[B, H, S/2, D] bytes -> [B, H, S, D] u4 codes (positions interleaved back)."""
    b, h, s2, d = packed.shape
    lo = packed & 0x0F
    hi = (packed >> 4) ^ 0x8
    return torch.stack([lo, hi], dim=3).reshape(b, h, s2 * 2, d)


def _merge_packed(buf: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """Insert T new position codes into a pair-packed buffer, in place.

    buf: [B, H, S/2, D] u8; q: [B, H, T, D] u8 codes; s: [B] start positions.
    Row b is written at positions [s[b], s[b] + T). Odd starts and odd T
    read-modify-write the boundary bytes (keep one nibble, set the other).
    The touched window of byte rows is clamped into the buffer the way
    ``jax.lax.dynamic_slice`` clamps it, and positions are derived from the
    clamped window, as in the JAX package.
    """
    b, h, s2, d = buf.shape
    t_new = q.shape[2]
    t2 = min(t_new // 2 + 1, s2)
    s = s.long()
    r0 = torch.clamp(torch.div(s, 2, rounding_mode="floor"), max=s2 - t2)  # [B]
    rows = r0[:, None] + torch.arange(t2, device=buf.device)                # [B, t2]
    row_idx = rows[:, None, :, None].expand(b, h, t2, d)
    cur = torch.gather(buf, 2, row_idx)                                     # [B, H, t2, D]
    pos = 2 * rows[:, :, None] + torch.arange(2, device=buf.device)         # [B, t2, 2]
    rel = pos - s[:, None, None]
    valid = (rel >= 0) & (rel < t_new)
    src = rel.clamp(0, t_new - 1).reshape(b, 1, t2 * 2, 1).expand(b, h, t2 * 2, d)
    newq = torch.gather(q, 2, src).reshape(b, h, t2, 2, d)
    lo = torch.where(valid[:, None, :, 0, None], newq[:, :, :, 0], cur & 0x0F)
    hi = torch.where(valid[:, None, :, 1, None], newq[:, :, :, 1], (cur >> 4) ^ 0x8)
    buf.scatter_(2, row_idx, ((hi ^ 0x8) << 4) | lo)


def _merge_ring(buf: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """Insert T <= R new position codes into a pair-packed ring of R = 2 x
    ``buf.shape[2]`` slots, in place: position s[b] + t goes to slot
    (s[b] + t) % R. The touched byte rows are distinct modulo the ring;
    each nibble takes the new position that falls on its slot, if any, or
    keeps what it held."""
    b, h, r2, d = buf.shape
    ring, t_new = 2 * r2, q.shape[2]
    t2 = min(t_new // 2 + 1, r2)
    s = s.long()
    rows = (torch.div(s, 2, rounding_mode="floor")[:, None]
            + torch.arange(t2, device=buf.device)) % r2                   # [B, t2]
    row_idx = rows[:, None, :, None].expand(b, h, t2, d)
    cur = torch.gather(buf, 2, row_idx)                                     # [B, H, t2, D]
    slot = 2 * rows[:, :, None] + torch.arange(2, device=buf.device)        # [B, t2, 2]
    rel = torch.remainder(slot - s[:, None, None], ring)                   # new position's index
    valid = rel < t_new
    src = rel.clamp(max=t_new - 1).reshape(b, 1, t2 * 2, 1).expand(b, h, t2 * 2, d)
    newq = torch.gather(q, 2, src).reshape(b, h, t2, 2, d)
    lo = torch.where(valid[:, None, :, 0, None], newq[:, :, :, 0], cur & 0x0F)
    hi = torch.where(valid[:, None, :, 1, None], newq[:, :, :, 1], (cur >> 4) ^ 0x8)
    buf.scatter_(2, row_idx, ((hi ^ 0x8) << 4) | lo)


def _update_ring(plane: torch.Tensor, val: torch.Tensor, s: torch.Tensor) -> None:
    """plane [B, H, R] <- val [B, H, T] (T <= R) at slots (s[b] + t) % R."""
    b, h, ring = plane.shape
    t = val.shape[2]
    cols = ((s.long()[:, None] + torch.arange(t, device=plane.device)) % ring)[:, None, :]
    plane.scatter_(2, cols.expand(b, h, t), val)


def _update_positions(plane: torch.Tensor, val: torch.Tensor, s: torch.Tensor) -> None:
    """plane [B, H, S] <- val [B, H, T] at [s[b], s[b] + T), in place, with the
    start clamped to S - T as ``jax.lax.dynamic_update_slice`` clamps it."""
    b, h, s_max = plane.shape
    t = val.shape[2]
    start = torch.clamp(s.long(), 0, s_max - t)
    cols = (start[:, None] + torch.arange(t, device=plane.device))[:, None, :]
    plane.scatter_(2, cols.expand(b, h, t), val)


@dataclasses.dataclass
class QuantizedKVCache:
    """Per-layer INT4 KV cache with static capacity and per-slot lengths."""

    k_packed: torch.Tensor   # [B, H, S/2, D] u8 pair-packed
    v_packed: torch.Tensor
    k_scale: torch.Tensor    # [B, H, S] f32
    k_zp: torch.Tensor
    v_scale: torch.Tensor
    v_zp: torch.Tensor
    lengths: torch.Tensor    # [B] i32
    window: int = 0          # > 0: a query sees the last ``window`` positions
    ring: bool = False       # slots hold positions modulo max_seq

    _FIELDS = ("k_packed", "v_packed", "k_scale", "k_zp", "v_scale", "v_zp", "lengths")

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, max_seq: int, head_dim: int,
             device: Optional[torch.device] = None, *, window: int = 0,
             max_tokens: Optional[int] = None) -> "QuantizedKVCache":
        """An empty cache on ``device`` (None: the CUDA card). With a
        ``window``, a ring of ``window + max_tokens`` slots (rounded up to
        even, at most ``max_seq``): ``max_tokens`` is the most positions one
        forward appends (None: ``max_seq``)."""
        if max_seq % 2:
            raise ValueError(f"max_seq={max_seq} must be even (pair packing)")
        if window:
            ring = window + (max_seq if max_tokens is None else max_tokens)
            max_seq = min(max_seq, ring + ring % 2)
        device = resolve_device(device)

        def z8():
            return torch.zeros((batch, num_kv_heads, max_seq // 2, head_dim),
                               dtype=torch.uint8, device=device)
        def zf():
            return torch.zeros((batch, num_kv_heads, max_seq), dtype=torch.float32,
                               device=device)
        return cls(z8(), z8(), zf(), zf(), zf(), zf(),
                   torch.zeros((batch,), dtype=torch.int32, device=device),
                   window=window, ring=bool(window))

    @property
    def max_seq(self) -> int:
        return self.k_packed.shape[2] * 2

    @property
    def head_dim(self) -> int:
        return self.k_packed.shape[3]

    @property
    def length(self) -> torch.Tensor:
        """Scalar length when all slots are in lockstep (simple decode)."""
        return self.lengths.max()

    @property
    def nbytes(self) -> int:
        """Bytes of the codes and scale planes (the lengths aside)."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self._FIELDS[:6])

    def positions(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the position each slot holds [B, S] i64, whether the slot is
        written [B, S] bool): slot s holds position s, or on a ring the
        newest position p < length with p % S == s."""
        s = torch.arange(self.max_seq, device=self.lengths.device)
        length = self.lengths.long()[:, None]
        written = s[None, :] < length
        if not self.ring:
            return s[None, :].expand(written.shape), written
        last = length - 1
        return last - torch.remainder(last - s[None, :], self.max_seq), written

    def append(self, k: torch.Tensor, v: torch.Tensor,
               start: Optional[torch.Tensor] = None) -> "QuantizedKVCache":
        """Quantize and insert new steps, in place; returns ``self``.

        k, v: [B, H, T_new, D]; row b is written at positions
        [start[b], start[b] + T_new), ``start`` defaulting to the row's length.
        A ring takes each position at its slot and keeps the last
        ``max_seq`` of a longer append.
        """
        t_new = k.shape[2]
        start = (self.lengths if start is None else start).to(self.lengths.device)
        new_lengths = (start + t_new).to(torch.int32)
        if self.ring and t_new > self.max_seq:
            cut = t_new - self.max_seq
            k, v, start = k[:, :, cut:], v[:, :, cut:], start + cut
        qk, ks, kz = _affine(k)
        qv, vs, vz = _affine(v)
        merge, update = (_merge_ring, _update_ring) if self.ring else (_merge_packed,
                                                                         _update_positions)
        merge(self.k_packed, qk, start)
        merge(self.v_packed, qv, start)
        for plane, val in ((self.k_scale, ks), (self.k_zp, kz),
                           (self.v_scale, vs), (self.v_zp, vz)):
            update(plane, val, start)
        self.lengths.copy_(new_lengths)
        return self

    def reset_slot(self, slot: int) -> "QuantizedKVCache":
        """Mark one batch slot empty (its stale data is masked by length)."""
        self.lengths[slot] = 0
        return self

    def slice_slot(self, slot: int) -> "QuantizedKVCache":
        """Batch-1 view of one slot; writes to it land in this cache."""
        return dataclasses.replace(self, **{f: getattr(self, f)[slot:slot + 1]
                                            for f in self._FIELDS})

    def merge_slot(self, part: "QuantizedKVCache", slot: int) -> "QuantizedKVCache":
        """Write a batch-1 cache back into ``slot`` (nothing to copy when
        ``part`` is this slot's own :meth:`slice_slot` view)."""
        for f in self._FIELDS:
            dst = getattr(self, f)[slot:slot + 1]
            src = getattr(part, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self

    def dequantize(self, dtype=torch.bfloat16):
        """Dense K, V [B, H, S, D] by slot (:meth:`positions` gives each
        slot's position; unwritten slots are junk)."""
        def dq(packed, scale, zp):
            q = _unpack_pairs(packed).float()
            return ((q - zp[..., None]) * scale[..., None]).to(dtype)

        return (dq(self.k_packed, self.k_scale, self.k_zp),
                dq(self.v_packed, self.v_scale, self.v_zp))


# The latent cache's capacity is a whole number of the blocks of positions
# the MLA kernel reads (``csrc/mla_attention.cu``).
LATENT_BLOCK = 32


@dataclasses.dataclass
class LatentKVCache:
    """Per-layer latent cache of multi-head latent attention, static capacity,
    per-slot lengths:

    * ``c_packed`` [B, 1, S/2, L] u8: the latent vectors' INT4 codes,
      pair-packed along positions as :class:`QuantizedKVCache`'s (one head);
    * ``c_scale``/``c_zp`` [B, 1, S] f32, per position;
    * ``k_pe`` [B, S, R] bf16: each position's RoPE key, shared by the heads;
    * ``lengths`` [B] i32, the filled positions of each slot.
    """

    c_packed: torch.Tensor
    c_scale: torch.Tensor
    c_zp: torch.Tensor
    k_pe: torch.Tensor
    lengths: torch.Tensor

    _FIELDS = ("c_packed", "c_scale", "c_zp", "k_pe", "lengths")

    @classmethod
    def init(cls, batch: int, max_seq: int, latent_dim: int, rope_dim: int,
             device: Optional[torch.device] = None) -> "LatentKVCache":
        """An empty cache on ``device`` (None: the CUDA card) of ``max_seq``
        positions a slot, rounded up to a whole block of
        :data:`LATENT_BLOCK`."""
        s = -(-max_seq // LATENT_BLOCK) * LATENT_BLOCK
        device = resolve_device(device)

        def zf():
            return torch.zeros((batch, 1, s), dtype=torch.float32, device=device)
        return cls(torch.zeros((batch, 1, s // 2, latent_dim), dtype=torch.uint8, device=device),
                   zf(), zf(),
                   torch.zeros((batch, s, rope_dim), dtype=torch.bfloat16, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.c_packed.shape[2] * 2

    @property
    def latent_dim(self) -> int:
        return self.c_packed.shape[3]

    @property
    def nbytes(self) -> int:
        """Bytes of the codes, planes and RoPE keys (the lengths aside)."""
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self._FIELDS[:4])

    def append(self, c_kv: torch.Tensor, k_pe: torch.Tensor,
               start: Optional[torch.Tensor] = None) -> "LatentKVCache":
        """Quantize and insert new positions, in place; returns ``self``.
        c_kv [B, T, L], k_pe [B, T, R]; row b is written at positions
        [start[b], start[b] + T), ``start`` defaulting to the row's length
        (clamped into the cache as :class:`QuantizedKVCache` clamps it)."""
        t_new = c_kv.shape[1]
        start = (self.lengths if start is None else start).to(self.lengths.device)
        q, scale, zp = _affine(c_kv[:, None])
        _merge_packed(self.c_packed, q, start)
        _update_positions(self.c_scale, scale, start)
        _update_positions(self.c_zp, zp, start)
        b, s, r = self.k_pe.shape
        first = torch.clamp(start.long(), 0, s - t_new)
        rows = (first[:, None] + torch.arange(t_new, device=first.device))[:, :, None]
        self.k_pe.scatter_(1, rows.expand(b, t_new, r), k_pe.to(self.k_pe.dtype))
        self.lengths.copy_((start + t_new).to(torch.int32))
        return self

    def reset_slot(self, slot: int) -> "LatentKVCache":
        """Mark one batch slot empty (its stale data is masked by length)."""
        self.lengths[slot] = 0
        return self

    def slice_slot(self, slot: int) -> "LatentKVCache":
        """Batch-1 view of one slot; writes to it land in this cache."""
        return dataclasses.replace(self, **{f: getattr(self, f)[slot:slot + 1]
                                            for f in self._FIELDS})

    def merge_slot(self, part: "LatentKVCache", slot: int) -> "LatentKVCache":
        """Write a batch-1 cache back into ``slot`` (nothing to copy when
        ``part`` is this slot's own :meth:`slice_slot` view)."""
        for f in self._FIELDS:
            dst = getattr(self, f)[slot:slot + 1]
            src = getattr(part, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self

    def codes(self) -> torch.Tensor:
        """The latent codes [B, S, L] u8 (0..15), position-major."""
        return _unpack_pairs(self.c_packed)[:, 0]

    def dequantize(self, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c_KV [B, S, L], k_pe [B, S, R]) by position, in ``dtype``
        (unwritten positions are junk)."""
        c = (self.codes().float() - self.c_zp[:, 0, :, None]) * self.c_scale[:, 0, :, None]
        return c.to(dtype), self.k_pe.to(dtype)
