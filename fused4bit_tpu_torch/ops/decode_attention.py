"""Attention over the pair-packed INT4 KV cache, over kernels K3 and K3'.

Counterpart of ``fused4bit_tpu/ops/decode_attention.py``
(``int4_decode_attention``, ``int4_prefill_attention`` and their paged
forms). On a CUDA tensor the wrappers launch ``csrc/decode_attention.cu``
(the port of the TPU kernel ``_attn_kernel``), which reads the packed cache
directly: K3 on a contiguous ``QuantizedKVCache``, K3' on a
``PagedKVCache`` through its page table. bf16 queries run its tensor-core
body, split over fixed segments of the cache (:func:`_attn_segment`), f32
queries its CUDA-core body. On a CPU tensor they run the plain
versions, :func:`int4_attention_reference` and
:func:`paged_int4_attention_reference`: dequantize the cache (gathered
through the table for the paged one), then masked softmax attention in
float32.

The query layout is the JAX package's, [B, Hq, T, D], GQA with
G = Hq / Hkv query heads per kv head. Query t of row b sits at position
``starts[b] + t`` and attends to cache positions ``s <= starts[b] + t`` with
``s < lengths[b]``; the cache must already hold the T new steps.
``int4_decode_attention`` and ``int4_prefill_attention`` take either cache
and dispatch on its type, as the JAX package does.

A cache with a ``window`` narrows that to ``starts[b] + t - window < p``,
where p is the position the key's slot holds: its slot on a paged cache, on
a window layer's contiguous ring the newest position at that slot
(``QuantizedKVCache.positions``). A cache without one runs as before, the
same kernels and the same bits.
"""
from __future__ import annotations

import math

import torch

from ..layers.kv_cache import _unpack_pairs
from ..layers.paged_kv import PagedKVCache
from ..quant.reference import full_precision
from . import _build
from ._front import _sm_count

__all__ = [
    "int4_attention",
    "int4_attention_reference",
    "int4_decode_attention",
    "int4_prefill_attention",
    "paged_int4_attention",
    "paged_int4_attention_reference",
    "paged_int4_decode_attention",
    "paged_int4_prefill_attention",
]

_KERNELS = {torch.bfloat16: "f4b_int4_attention_bf16", torch.float32: "f4b_int4_attention_f32"}
_PAGED_KERNELS = {torch.bfloat16: "f4b_paged_int4_attention_bf16",
                  torch.float32: "f4b_paged_int4_attention_f32"}
_MAX_ROWS = 16            # query rows (positions x grouped heads) per CTA of the kernel
_HEAD_DIMS = (64, 128)    # head dims the kernel is instantiated for
_S_TILE = 32              # cache positions per kernel unit; K3' needs page % _S_TILE == 0
_SEG_BLOCK = 64           # positions per block of a warp's walk (tensor-core body)
_SEG_WARPS = 4            # segments (warps) per CTA


def _attn_segment(s: int, h_kv: int, sms: int) -> int:
    """Positions per segment of the tensor-core body for a cache of ``s``
    positions per row and ``h_kv`` kv heads on a card of ``sms`` SMs: a
    multiple of 64, about ``s`` over 4 segments per CTA times the CTAs that
    give one per SM at batch 1, so a long row at batch 1 still reaches every
    SM and a long row at batch 8 walks longer segments with fewer CTAs and
    partials (``scripts/attention_sweep.py`` times the candidates).
    Each segment runs its own online softmax and the segments merge in
    order.

    It reads neither the lengths nor the number of queries nor the batch:
    every query row then walks the same segments in the same order, so a
    row's output does not depend on T or on the rows beside it (the decode
    row at position p equals the row at p of a chunked prefill bit for bit).
    """
    ctas = -(-sms // h_kv)
    return _SEG_BLOCK * max(1, round(s / (_SEG_WARPS * _SEG_BLOCK * ctas)))


def _attn_ctas(s: int, seg: int) -> int:
    """The CTAs along one row's positions (grid z): 4 segments each."""
    return -(-s // (_SEG_WARPS * seg))


def _check(q: torch.Tensor, cache, starts: torch.Tensor) -> int:
    b, hq, _, d = q.shape
    h_kv = (cache.k_pool if isinstance(cache, PagedKVCache) else cache.k_packed).shape[1]
    if hq % h_kv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={h_kv}")
    if cache.lengths.shape[0] != b or cache.head_dim != d:
        raise ValueError(
            f"cache of {cache.lengths.shape[0]} rows, head_dim {cache.head_dim} does not "
            f"match q [{tuple(q.shape)}]"
        )
    if starts.shape != (b,):
        raise ValueError(f"starts must be [B]={b}, got {tuple(starts.shape)}")
    return hq // h_kv


def _attention_math(q: torch.Tensor, cache, starts: torch.Tensor, g: int) -> torch.Tensor:
    """The plain versions' arithmetic over a contiguous cache (see
    :func:`int4_attention_reference`)."""
    b, hq, t, d = q.shape
    kc = _unpack_pairs(cache.k_packed).float().repeat_interleave(g, dim=1)   # codes [B, Hq, S, D]
    vc = _unpack_pairs(cache.v_packed).float().repeat_interleave(g, dim=1)

    def per_position(plane):                                               # [B, Hq, 1, S]
        return plane.float().repeat_interleave(g, dim=1)[:, :, None, :]

    ks, vs, vz = per_position(cache.k_scale), per_position(cache.v_scale), per_position(cache.v_zp)
    ksz = per_position(cache.k_scale * cache.k_zp)
    qf = q.float()
    with full_precision():
        raw = torch.matmul(qf, kc.transpose(-1, -2))                       # [B, Hq, T, S]
    qsum = qf.sum(dim=-1, keepdim=True)
    scores = (raw * ks - qsum * ksz) * torch.tensor(1.0 / math.sqrt(d), device=q.device)
    qpos = starts.to(q.device).long()[:, None] + torch.arange(t, device=q.device)  # [B, T]
    mask = key_mask(cache, qpos)[:, None]                                  # [B, 1, T, S]
    scores = scores.masked_fill(~mask, float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True).clamp(min=-1e30)   # finite for empty rows
    p = torch.exp(scores - row_max)                         # masked entries: exactly 0
    denom = p.sum(dim=-1, keepdim=True)
    ps = (p * vs).to(q.dtype).float()
    with full_precision():
        num = torch.matmul(ps, vc) - (ps * vz).sum(dim=-1, keepdim=True)
    out = torch.where(denom > 0, num / denom, torch.zeros_like(num))
    return out.to(q.dtype)


def key_mask(cache, qpos: torch.Tensor) -> torch.Tensor:
    """[B, T, S]: whether query t of row b, at position ``qpos`` [B, T],
    sees the key in slot s of the contiguous ``cache``: the slot is written
    and holds a position at or before the query, and inside the cache's
    window where it has one."""
    kpos, written = cache.positions()
    kpos, written = kpos.to(qpos.device)[:, None, :], written.to(qpos.device)[:, None, :]
    q = qpos[:, :, None]
    mask = written & (kpos <= q)
    if cache.window:
        mask = mask & (kpos > q - cache.window)
    return mask


def int4_attention_reference(
    q: torch.Tensor, cache, starts: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3: causal softmax attention over the packed cache in
    float32, the per-position affines applied after the dots, as the TPU
    kernel (and K3) does: scores ``(s_k (q . c_k) - s_k zp_k sum(q)) *
    f32(1/sqrt(D))``; out ``(ps . c_v - sum(ps zp_v)) / sum(p)``.
    q [B, Hq, T, D] -> [B, Hq, T, D] in q.dtype.

    It keeps the numerics contract of the TPU kernel: the softmax
    numerator times the value scale, ``ps = exp(s - max) * s_v``, is rounded
    once to q.dtype and feeds both the code dot and the zero-point term;
    the denominator sums the unrounded numerator. The max is the row's (the
    TPU kernel and K3 take a running max per block of positions). In float32
    that is plain attention over the dequantized cache.
    """
    int4_attention_reference.calls += 1
    return _attention_math(q, cache, starts, _check(q, cache, starts))


int4_attention_reference.calls = 0


def paged_int4_attention_reference(
    q: torch.Tensor, cache: PagedKVCache, starts: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3': gather the pool through the page table into the
    logical contiguous view (``PagedKVCache.logical``, as JAX's
    ``PagedKVCache.dequantize`` gathers), then :func:`int4_attention_reference`'s
    arithmetic. Takes any even page size. On the same content it equals the
    contiguous plain version bit for bit."""
    paged_int4_attention_reference.calls += 1
    return _attention_math(q, cache.logical(), starts, _check(q, cache, starts))


paged_int4_attention_reference.calls = 0


def _launch(kernels: dict, q: torch.Tensor, g: int, operands, sizes,
            positions: int, masks: tuple) -> torch.Tensor:
    """Check the operands of K3 or K3' (``kernels``: its C entry point per
    query dtype) and launch it; q [B, Hq, T, D] over a cache of
    ``positions`` logical positions per row; ``masks``: the window and, for
    K3, the ring flag."""
    d = q.shape[-1]
    if q.dtype not in kernels:
        raise TypeError(f"K3 takes bf16 or f32 queries, got {q.dtype}")
    kernel = kernels[q.dtype]
    if d not in _HEAD_DIMS:
        raise ValueError(f"K3 is built for head_dim in {_HEAD_DIMS}, got {d}")
    if g > _MAX_ROWS:
        raise ValueError(f"K3 takes at most {_MAX_ROWS} query heads per kv head, got {g}")
    for name, tensor, want in operands:
        if tensor.device != q.device or tensor.dtype != want or not tensor.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {want} tensor on {q.device}; "
                f"got {tensor.dtype} on {tensor.device}, contiguous={tensor.is_contiguous()}"
            )
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()  # the kernels read q with 16-byte loads
    out = torch.empty_like(q)
    qt = max(1, _MAX_ROWS // g)
    b, hq, t, _ = q.shape
    h_kv = hq // g
    tail = (d, qt)
    partial = []
    if q.dtype == torch.bfloat16:
        seg = _attn_segment(positions, h_kv, _sm_count(q.device.index))
        z = _attn_ctas(positions, seg)
        scratch = (torch.empty(b * h_kv * -(-t // qt) * z * (_MAX_ROWS * d + 2 * _MAX_ROWS),
                               dtype=torch.float32, device=q.device) if z > 1 else None)
        partial = [None if scratch is None else scratch.data_ptr()]
        tail = (d, qt, seg)
    tail += masks
    _build.launch(q, kernel, q, *(tensor for _, tensor, _ in operands), out, *partial, *sizes,
                  *tail)
    return out


def _cache_operands(cache, packed: str) -> list:
    return [
        ("k_" + packed, getattr(cache, "k_" + packed), torch.uint8),
        ("k_scale", cache.k_scale, torch.float32), ("k_zp", cache.k_zp, torch.float32),
        ("v_" + packed, getattr(cache, "v_" + packed), torch.uint8),
        ("v_scale", cache.v_scale, torch.float32), ("v_zp", cache.v_zp, torch.float32),
    ]


def int4_attention(q: torch.Tensor, cache, starts: torch.Tensor) -> torch.Tensor:
    """K3: flash attention of q [B, Hq, T, D] over the contiguous packed
    cache; q.dtype out."""
    if not q.is_cuda:
        return int4_attention_reference(q, cache, starts)
    g = _check(q, cache, starts)
    b, hq, t, _ = q.shape
    operands = _cache_operands(cache, "packed") + [
        ("lengths", cache.lengths, torch.int32), ("starts", starts, torch.int32)]
    out = _launch(_KERNELS, q, g, operands,
                  (b, hq // g, g, t, cache.max_seq), cache.max_seq,
                  (cache.window, int(cache.ring)))
    int4_attention.launches += 1
    int4_attention.window_launches += bool(cache.window)
    return out


int4_attention.launches = 0
int4_attention.window_launches = 0    # the share of .launches over a window layer's cache


def paged_int4_attention(q: torch.Tensor, cache: PagedKVCache,
                         starts: torch.Tensor) -> torch.Tensor:
    """K3': flash attention of q [B, Hq, T, D] over the page pool through
    the page table; q.dtype out. The kernel looks pages up per tile of 32
    positions, so on the card the page size must be a multiple of 32."""
    if not q.is_cuda:
        return paged_int4_attention_reference(q, cache, starts)
    g = _check(q, cache, starts)
    page = cache.page_size
    if page % _S_TILE != 0:
        raise ValueError(
            f"K3' reads pages in tiles of {_S_TILE} positions: page_size must be a multiple "
            f"of {_S_TILE}, got page_size={page} (the serving default is 128)"
        )
    b, hq, t, _ = q.shape
    operands = _cache_operands(cache, "pool") + [
        ("page_table", cache.page_table, torch.int32),
        ("lengths", cache.lengths, torch.int32), ("starts", starts, torch.int32)]
    out = _launch(_PAGED_KERNELS, q, g, operands,
                  (b, hq // g, g, t, page, cache.max_pages_per_slot),
                  page * cache.max_pages_per_slot, (cache.window,))
    paged_int4_attention.launches += 1
    paged_int4_attention.window_launches += bool(cache.window)
    return out


paged_int4_attention.launches = 0
paged_int4_attention.window_launches = 0


def paged_int4_decode_attention(q: torch.Tensor, cache: PagedKVCache) -> torch.Tensor:
    """One decode step over the paged cache: q [B, Hq, D] -> [B, Hq, D]; the
    current step's K/V must already be appended."""
    starts = (cache.lengths - 1).to(torch.int32)
    return paged_int4_attention(q[:, :, None, :], cache, starts)[:, :, 0, :]


def paged_int4_prefill_attention(q: torch.Tensor, cache: PagedKVCache,
                                 starts: torch.Tensor) -> torch.Tensor:
    """Chunked prefill over the paged cache: q [B, Hq, T, D], ``starts`` [B];
    the cache holds the T new steps. Returns [B, Hq, T, D]."""
    return paged_int4_attention(q, cache, starts.to(torch.int32).contiguous())


def int4_decode_attention(q: torch.Tensor, cache) -> torch.Tensor:
    """One decode step: q [B, Hq, D] -> [B, Hq, D]; K3' on a paged cache.

    The current step's K/V must already be appended (entry ``length - 1`` is
    the current step, so the causal mask is ``s < length``).
    """
    if isinstance(cache, PagedKVCache):
        return paged_int4_decode_attention(q, cache)
    starts = (cache.lengths - 1).to(torch.int32)
    return int4_attention(q[:, :, None, :], cache, starts)[:, :, 0, :]


def int4_prefill_attention(q: torch.Tensor, cache, starts: torch.Tensor) -> torch.Tensor:
    """Chunked prefill: q [B, Hq, T, D], ``starts`` [B] the position of each
    row's first query; the cache holds the T new steps. Returns [B, Hq, T, D].
    K3' on a paged cache."""
    if isinstance(cache, PagedKVCache):
        return paged_int4_prefill_attention(q, cache, starts)
    return int4_attention(q, cache, starts.to(torch.int32).contiguous())
