"""Sequence (context) parallelism: ring and Ulysses attention over a mesh
axis.

Counterpart of ``fused4bit_tpu/parallel/sequence.py``, in plain PyTorch (the
JAX package computes it with jnp, no Pallas kernel). The SEQUENCE dim of Q,
K, V is split over a mesh axis: each rank holds one contiguous [T / P] chunk
(:func:`shard_sequence`, :func:`shard_cache_sequence`) and gets its chunk of
the output back.

Ring attention keeps the rank's Q chunk resident and walks the K/V ring: P
steps, each combining the chunk it holds into the flash online-softmax state
(m, l, acc) and passing the chunk to the next rank (isend/irecv). Chunks in
a Q chunk's future drop out numerically, through the masked-probability
form (p = where(mask, exp(s - m), 0)): a row whose every column is masked
keeps m = -1e30, where exp(s - m) would be 1, and the mask zeroes it. GQA
repeats the chunk's K/V heads to the query head count, as the fused
attention kernel does. :func:`ring_attention_quantized` rotates the INT4
cache's pair-packed codes and per-position scales, ~3.5x fewer bytes per
hop than bf16 K/V, and masks each slot by its ``lengths``.

Ulysses attention trades the sequence split for a head split with one
``all_to_all``, runs full causal attention on Hq / P heads, and trades back.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..layers.kv_cache import QuantizedKVCache, _unpack_pairs
from .mesh import all_to_all, axis_index, axis_size, ring_shift
from .sharding import Shard, shard_tensor

__all__ = [
    "ring_attention", "ring_attention_quantized", "ulysses_attention",
    "sequence_sharded_attention", "shard_sequence", "shard_cache_sequence",
]

_NEG = -1e30


def shard_sequence(x: torch.Tensor, mesh: DeviceMesh, *, axis: str = "seq",
                   dim: int = 2) -> torch.Tensor:
    """This rank's contiguous chunk of ``x``'s sequence dim (dim 2 of
    [B, H, T, D]). Raises ``ValueError`` unless the axis size divides T."""
    t, p_sz = x.shape[dim], axis_size(mesh, axis)
    if t % p_sz:
        raise ValueError(f"T={t} must divide by {axis} size {p_sz}")
    return shard_tensor(x, mesh, Shard(axis, dim))


def shard_cache_sequence(cache: QuantizedKVCache, mesh: DeviceMesh, *,
                         axis: str = "seq") -> QuantizedKVCache:
    """This rank's chunk of positions of a whole cache: its codes [B, H,
    C/2, D] and scale planes [B, H, C], every slot's ``lengths`` whole.
    Raises ``ValueError`` unless max_seq splits into even chunks (pair
    packing)."""
    t, p_sz = cache.max_seq, axis_size(mesh, axis)
    if t % p_sz or (t // p_sz) % 2:
        raise ValueError(f"T={t} must split into even chunks over {axis} size {p_sz}")
    spec = Shard(axis, 2)   # codes [B, H, S/2, D] and scale planes [B, H, S] alike
    return QuantizedKVCache(*(shard_tensor(getattr(cache, f), mesh, spec)
                              for f in QuantizedKVCache._FIELDS[:6]),
                            lengths=shard_tensor(cache.lengths, mesh, None))


def _flash_step(m, l, acc, qf, kr, vr, q_pos, k_pos, causal, lengths):
    """One online-softmax chunk update. qf pre-scaled f32; kr/vr f32 with
    the query head count; masked-probability form (module docstring)."""
    s = torch.einsum("bhid,bhjd->bhij", qf, kr)                # [B, Hq, C, C]
    mask = None
    if causal:
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    if lengths is not None:
        lmask = (k_pos[None, :] < lengths[:, None])[:, None, None, :]
        mask = lmask if mask is None else (mask & lmask)
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    prob = torch.exp(s - m_new)
    if mask is not None:
        prob = torch.where(mask, prob, 0.0)
    alpha = torch.exp(m - m_new)
    l = alpha * l + prob.sum(dim=-1, keepdim=True)
    acc = alpha * acc + torch.einsum("bhij,bhjd->bhid", prob, vr)
    return m_new, l, acc


def _ring(q: torch.Tensor, chunk, kv_of, mesh: DeviceMesh, axis: str, causal: bool,
          lengths=None) -> torch.Tensor:
    """Walk the ring: P uses of the chunk held, P - 1 rotations (a P-th
    would move the chunk home for nothing). ``kv_of(chunk)`` gives its f32
    K and V with the query head count."""
    p_sz, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    b, hq, c, d = q.shape
    qf = q.float() * (d ** -0.5)
    ar = torch.arange(c, dtype=torch.int32, device=q.device)
    q_pos = idx * c + ar
    m = torch.full((b, hq, c, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, c, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, c, d), dtype=torch.float32, device=q.device)
    for p_i in range(p_sz):
        k_pos = ((idx - p_i) % p_sz) * c + ar                      # the chunk held now
        kr, vr = kv_of(chunk)
        m, l, acc = _flash_step(m, l, acc, qf, kr, vr, q_pos, k_pos, causal, lengths)
        if p_i < p_sz - 1:
            chunk = ring_shift(chunk, mesh, axis)
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def _check_heads(hq: int, hkv: int) -> int:
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    return hq // hkv


def ring_attention(
    q: torch.Tensor,   # [B, Hq, C, D], this rank's chunk
    k: torch.Tensor,   # [B, Hkv, C, D]
    v: torch.Tensor,   # [B, Hkv, C, D]
    mesh: DeviceMesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> torch.Tensor:
    """Attention with the sequence split over ``mesh[axis]``: chunk i holds
    positions [i * C, (i + 1) * C). Returns this rank's [B, Hq, C, D]; peak
    memory O(B * H * C * D) per rank, and each rank sends (P - 1) / P of the
    K and V bytes."""
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"K/V chunk of {k.shape[2]} positions for a Q chunk of {q.shape[2]}")
    rep = _check_heads(q.shape[1], k.shape[1])

    def kv_of(chunk):
        return tuple(a.float().repeat_interleave(rep, dim=1) for a in chunk)

    return _ring(q, [k, v], kv_of, mesh, axis, causal)


def ring_attention_quantized(
    q: torch.Tensor,          # [B, Hq, C, D], this rank's chunk
    cache: QuantizedKVCache,  # this rank's chunk of positions (shard_cache_sequence)
    mesh: DeviceMesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> torch.Tensor:
    """Ring attention whose K/V ring carries the packed INT4 cache: each hop
    moves the chunk's pair-packed codes and its four per-position affine
    rows stacked as one [4, B, Hkv, C] tensor (three sends a hop, not six),
    and the chunk is dequantized right before its use. Slot b attends to
    positions below ``cache.lengths[b]`` only, as the fused kernel does.
    Returns this rank's [B, Hq, C, D]."""
    if q.shape[2] != cache.max_seq:
        raise ValueError(f"T={q.shape[2]} must equal the cache chunk's max_seq={cache.max_seq}")
    rep = _check_heads(q.shape[1], cache.k_packed.shape[1])

    def dq(packed, s, z):
        codes = _unpack_pairs(packed).float()                       # [B, Hkv, C, D]
        return ((codes - z[..., None]) * s[..., None]).repeat_interleave(rep, dim=1)

    def kv_of(chunk):
        kp, vp, sz4 = chunk
        return dq(kp, sz4[0], sz4[1]), dq(vp, sz4[2], sz4[3])

    sz4 = torch.stack([cache.k_scale, cache.k_zp, cache.v_scale, cache.v_zp])
    return _ring(q, [cache.k_packed, cache.v_packed, sz4], kv_of, mesh, axis, causal,
                 lengths=cache.lengths)


def ulysses_attention(
    q: torch.Tensor,   # [B, Hq, C, D], this rank's chunk
    k: torch.Tensor,   # [B, Hkv, C, D]
    v: torch.Tensor,   # [B, Hkv, C, D]
    mesh: DeviceMesh,
    *,
    axis: str = "seq",
    causal: bool = True,
) -> torch.Tensor:
    """Ulysses sequence parallelism: one ``all_to_all`` re-splits over HEADS
    (each rank gets the full sequence for Hq / P query heads and Hkv / P kv
    heads; contiguous head blocks keep the GQA grouping), plain full-context
    attention runs locally, and a second ``all_to_all`` restores the
    sequence split. Requires Hq % P == 0 and Hkv % P == 0; prefer the ring
    when P exceeds the kv-head count. Returns this rank's [B, Hq, C, D]."""
    p_sz = axis_size(mesh, axis)
    if q.shape[1] % p_sz or k.shape[1] % p_sz:
        raise ValueError(f"Hq={q.shape[1]} and Hkv={k.shape[1]} must divide by {axis} size "
                         f"{p_sz} (use ring_attention otherwise)")
    rep = _check_heads(q.shape[1], k.shape[1])
    b, _, c, d = q.shape

    def fwd(a):   # [B, H, C, D] -> [B, H/P, T, D]: split heads, gather sequence
        h = a.shape[1] // p_sz
        send = a.reshape(b, p_sz, h, c, d).transpose(0, 1).reshape(p_sz * b, h, c, d)
        recv = all_to_all(send, mesh, axis).reshape(p_sz, b, h, c, d)
        return recv.permute(1, 2, 0, 3, 4).reshape(b, h, p_sz * c, d)

    qh, kh, vh = fwd(q), fwd(k), fwd(v)
    t = qh.shape[2]
    kr = kh.float().repeat_interleave(rep, dim=1)
    vr = vh.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhid,bhjd->bhij", qh.float() * (d ** -0.5), kr)
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where((pos[None, :] <= pos[:, None])[None, None], s, _NEG)
    out = torch.einsum("bhij,bhjd->bhid", torch.softmax(s, dim=-1), vr).to(q.dtype)
    # [B, Hq/P, T, D] -> [B, Hq, C, D]: split sequence back, gather heads
    h = out.shape[1]
    send = out.reshape(b, h, p_sz, c, d).permute(2, 0, 1, 3, 4).reshape(p_sz * b, h, c, d)
    recv = all_to_all(send, mesh, axis).reshape(p_sz, b, h, c, d)
    return recv.transpose(0, 1).reshape(b, p_sz * h, c, d)


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               mesh: DeviceMesh, **kw) -> torch.Tensor:
    """Alias for :func:`ring_attention` (the sequence-parallel entry point)."""
    return ring_attention(q, k, v, mesh, **kw)
