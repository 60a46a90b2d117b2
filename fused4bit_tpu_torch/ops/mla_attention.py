"""Multi-head latent attention over the INT4 latent cache, over kernel K15.

It has no counterpart in the JAX package, which runs no latent attention.
On a CUDA tensor :func:`mla_attention` launches ``csrc/mla_attention.cu``;
on a CPU tensor it runs the plain version, :func:`mla_attention_reference`.
Both compute the absorbed form of DeepSeek-V3's attention over a
``LatentKVCache``: for each head, ``softmax(scale * (q_lat . c_KV[s] +
q_pe . k_pe[s]))`` over the positions s the query sees, and the output
``sum_s p c_KV[s]`` in latent space (the caller takes q into latent space
before, through ``W_UK``, and the output back after, through ``W_UV``).

Layouts: ``q_lat`` [H, rows, L] and the output [H, rows, L] head-major, so
that they are the x and y of the grouped matmul that absorbs ``W_UK`` and
``W_UV`` with the heads as its groups; ``q_pe`` [B, T, H, R]. Row ``b * T + t``
is query t of batch row b, at position ``starts[b] + t``; it sees positions
``s <= starts[b] + t`` with ``s < lengths[b]``, so the cache must already hold
the T new positions. Rows past B * T (padding of the grouped matmul's
tiles) are written as zeros.
"""
from __future__ import annotations

import torch

from ..layers.kv_cache import LatentKVCache
from ..quant.reference import full_precision
from . import _build

__all__ = ["mla_attention", "mla_attention_reference"]

_LATENT = 512             # the kernel's latent width (kv_lora_rank)
_ROPE = 64                # and RoPE key width (qk_rope_head_dim)
_HEAD_TILE = 64           # heads per CTA
_BLOCK = 32               # positions per block of the kernel's walk
_SEG_TARGET = 2048        # positions a segment holds at least (below: one segment)


def _mla_segment(s: int) -> int:
    """Positions per segment of K15 for a cache of ``s`` positions a slot: the
    segments are as few as hold at least 2048 positions each (one below
    4096), so that a segment's f32 partial (64 heads x 512 channels, 128 KB
    a CTA) stays under a sixth of the cache bytes it reads (392 bytes a
    position), and split as evenly as whole blocks of 32 allow. It reads
    the capacity alone, never the batch, the queries or the lengths: every
    query row walks the same segments in the same order."""
    z = max(1, s // _SEG_TARGET)
    blocks = -(-s // _BLOCK)
    return _BLOCK * -(-blocks // z)


def _check(q_lat: torch.Tensor, q_pe: torch.Tensor, cache: LatentKVCache,
           starts: torch.Tensor) -> tuple:
    b, t, h, r = q_pe.shape
    if q_lat.dim() != 3 or q_lat.shape[0] != h or q_lat.shape[1] < b * t:
        raise ValueError(f"q_lat must be [H={h}, rows >= {b * t}, L], got {tuple(q_lat.shape)}")
    if q_lat.shape[2] != cache.latent_dim or r != cache.k_pe.shape[2]:
        raise ValueError(f"q_lat [.., {q_lat.shape[2]}] and q_pe [.., {r}] do not match the "
                         f"cache's {cache.latent_dim} latent and {cache.k_pe.shape[2]} RoPE widths")
    if cache.lengths.shape[0] != b or starts.shape != (b,):
        raise ValueError(f"cache of {cache.lengths.shape[0]} rows and starts "
                         f"{tuple(starts.shape)} for q_pe of {b} rows")
    return b, t, h


def mla_attention_reference(q_lat: torch.Tensor, q_pe: torch.Tensor, cache: LatentKVCache,
                            starts: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K15, in float32, with its numerics: scores
    ``(s_c (q_lat . codes) - s_c zp_c sum(q_lat) + q_pe . k_pe) * scale``,
    the row's max, ``ps = exp(s - max) * s_c`` rounded once to q's type and
    feeding both the code product and the zero-point term, the denominator
    over the unrounded numerator. Returns [H, rows, L] in q_lat.dtype."""
    mla_attention_reference.calls += 1
    b, t, h = _check(q_lat, q_pe, cache, starts)
    dev = q_lat.device
    codes = cache.codes().float()                                        # [B, S, L]
    sc, zp = cache.c_scale[:, 0].float(), cache.c_zp[:, 0].float()       # [B, S]
    ql = q_lat[:, :b * t].float().reshape(h, b, t, -1)                   # [H, B, T, L]
    with full_precision():
        raw = torch.einsum("hbtl,bsl->hbts", ql, codes)
        pe = torch.einsum("bthr,bsr->hbts", q_pe.float(), cache.k_pe.float())
    qsum = ql.sum(dim=-1, keepdim=True)
    scores = (raw * sc[None, :, None] - qsum * (sc * zp)[None, :, None] + pe) * torch.tensor(
        scale, dtype=torch.float32)
    qpos = starts.to(dev).long()[:, None] + torch.arange(t, device=dev)             # [B, T]
    kpos = torch.arange(cache.max_seq, device=dev)
    seen = (kpos[None, None] <= qpos[:, :, None]) & (
        kpos[None, None] < cache.lengths.to(dev).long()[:, None, None])             # [B, T, S]
    scores = scores.masked_fill(~seen[None], float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(scores - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    ps = (p * sc[None, :, None]).to(q_lat.dtype).float()
    with full_precision():
        num = torch.einsum("hbts,bsl->hbtl", ps, codes)
    num = num - (ps * zp[None, :, None]).sum(dim=-1, keepdim=True)
    out = torch.where(denom > 0, num / denom, torch.zeros_like(num))
    full = torch.zeros_like(q_lat)
    full[:, :b * t] = out.reshape(h, b * t, -1).to(q_lat.dtype)
    return full


mla_attention_reference.calls = 0


def mla_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, cache: LatentKVCache,
                  starts: torch.Tensor, scale: float) -> torch.Tensor:
    """K15: latent attention of q_lat [H, rows, L] and q_pe [B, T, H, R] over
    the latent cache; [H, rows, L] out, q_lat.dtype. The kernel takes bf16,
    L = 512, R = 64 and H a multiple of 64 (DeepSeek-V3's widths), and any
    strides of 16-byte rows."""
    if not q_lat.is_cuda:
        return mla_attention_reference(q_lat, q_pe, cache, starts, scale)
    b, t, h = _check(q_lat, q_pe, cache, starts)
    if q_lat.dtype != torch.bfloat16 or q_pe.dtype != torch.bfloat16:
        raise TypeError(f"K15 takes bf16 queries, got {q_lat.dtype} and {q_pe.dtype}")
    if cache.latent_dim != _LATENT or q_pe.shape[3] != _ROPE or h % _HEAD_TILE:
        raise ValueError(f"K15 is built for L={_LATENT}, R={_ROPE} and heads in multiples of "
                         f"{_HEAD_TILE}; got L={cache.latent_dim}, R={q_pe.shape[3]}, H={h}")
    if q_lat.stride(2) != 1 or q_pe.stride(3) != 1 or q_lat.stride(1) % 8 or \
            q_lat.stride(0) % 8 or q_pe.stride(2) % 8 or q_pe.stride(1) != h * q_pe.stride(2) \
            or q_pe.stride(0) != t * q_pe.stride(1) or q_lat.data_ptr() % 16 or \
            q_pe.data_ptr() % 16:
        raise ValueError("K15 reads q_lat and q_pe in 16-byte pieces of contiguous rows")
    for name, tensor, want in (("c_packed", cache.c_packed, torch.uint8),
                               ("c_scale", cache.c_scale, torch.float32),
                               ("c_zp", cache.c_zp, torch.float32),
                               ("k_pe", cache.k_pe, torch.bfloat16),
                               ("lengths", cache.lengths, torch.int32)):
        if tensor.device != q_lat.device or tensor.dtype != want or not tensor.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on {q_lat.device}")
    rows = b * t
    s = cache.max_seq
    seg = _mla_segment(s)
    z = -(-s // seg)
    out = torch.empty_like(q_lat)
    if q_lat.shape[1] > rows:
        out[:, rows:].zero_()
    partial = (torch.empty(z * h * rows * (_LATENT + 2), dtype=torch.float32, device=q_lat.device)
               if z > 1 else None)
    starts = starts.to(torch.int32).contiguous()
    _build.launch(q_lat, "f4b_mla_attention_bf16", q_lat, q_pe, cache.c_packed, cache.c_scale,
                  cache.c_zp, cache.k_pe, cache.lengths, starts, out, partial, b, t, h, s,
                  q_lat.stride(0), q_lat.stride(1), q_pe.stride(1), q_pe.stride(2),
                  out.stride(0), out.stride(1), seg, z, float(scale), what="K15")
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
