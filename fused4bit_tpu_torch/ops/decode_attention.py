"""Attention over the pair-packed INT4 KV cache, over kernel K3.

Counterpart of ``fused4bit_tpu/ops/decode_attention.py``
(``int4_decode_attention`` and ``int4_prefill_attention``). On a CUDA tensor
the wrappers launch ``csrc/decode_attention.cu`` (the port of the TPU kernel
``_attn_kernel``), which reads the packed cache directly; on a CPU tensor
they run the plain version, :func:`int4_attention_reference`: dequantize the
cache, then masked softmax attention in float32.

The query layout is the JAX package's, [B, Hq, T, D], GQA with
G = Hq / Hkv query heads per kv head. Query t of row b sits at position
``starts[b] + t`` and attends to cache positions ``s <= starts[b] + t`` with
``s < lengths[b]``; the cache must already hold the T new steps.
"""
from __future__ import annotations

import math

import torch

from ..layers.kv_cache import _unpack_pairs
from ..quant.reference import full_precision
from . import _build

__all__ = [
    "int4_attention",
    "int4_attention_reference",
    "int4_decode_attention",
    "int4_prefill_attention",
]

_KERNELS = {torch.bfloat16: "f4b_int4_attention_bf16", torch.float32: "f4b_int4_attention_f32"}
_MAX_ROWS = 16            # query rows (positions x grouped heads) per CTA of the kernel
_HEAD_DIMS = (64, 128)    # head dims the kernel is instantiated for


def _check(q: torch.Tensor, cache, starts: torch.Tensor) -> int:
    b, hq, _, d = q.shape
    h_kv = cache.k_packed.shape[1]
    if hq % h_kv != 0:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={h_kv}")
    if cache.k_packed.shape[0] != b or cache.head_dim != d:
        raise ValueError(
            f"cache [{tuple(cache.k_packed.shape)}] does not match q [{tuple(q.shape)}]"
        )
    if starts.shape != (b,):
        raise ValueError(f"starts must be [B]={b}, got {tuple(starts.shape)}")
    return hq // h_kv


def int4_attention_reference(
    q: torch.Tensor, cache, starts: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3: dequantize the cache, then causal softmax
    attention in float32. q [B, Hq, T, D] -> [B, Hq, T, D] in q.dtype.

    It keeps the numerics contract of the TPU kernel: the softmax
    numerator times the value scale, ``ps = exp(s - max) * s_v``, is rounded
    once to q.dtype and multiplies the centered value codes ``c_v - z_v``;
    the denominator sums the unrounded numerator. In float32 that is plain
    attention over the dequantized cache.
    """
    int4_attention_reference.calls += 1
    g = _check(q, cache, starts)
    b, hq, t, d = q.shape
    kd, _ = cache.dequantize(torch.float32)                # [B, Hkv, S, D]
    vc = _unpack_pairs(cache.v_packed).float() - cache.v_zp[..., None]
    kd = kd.repeat_interleave(g, dim=1)
    vc = vc.repeat_interleave(g, dim=1)
    vs = cache.v_scale.repeat_interleave(g, dim=1)[:, :, None, :]     # [B, Hq, 1, S]
    with full_precision():
        scores = torch.matmul(q.float(), kd.transpose(-1, -2)) / math.sqrt(d)
    span = torch.arange(cache.max_seq, device=q.device)
    qpos = starts.to(q.device).long()[:, None] + torch.arange(t, device=q.device)  # [B, T]
    lengths = cache.lengths.to(q.device).long()
    mask = ((span[None, None, :] <= qpos[:, :, None])
            & (span[None, None, :] < lengths[:, None, None]))[:, None]  # [B, 1, T, S]
    scores = scores.masked_fill(~mask, float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True).clamp(min=-1e30)   # finite for empty rows
    p = torch.exp(scores - row_max)                         # masked entries: exactly 0
    denom = p.sum(dim=-1, keepdim=True)
    ps = (p * vs).to(q.dtype).float()
    with full_precision():
        num = torch.matmul(ps, vc)
    out = torch.where(denom > 0, num / denom, torch.zeros_like(num))
    return out.to(q.dtype)


int4_attention_reference.calls = 0


def int4_attention(q: torch.Tensor, cache, starts: torch.Tensor) -> torch.Tensor:
    """Flash attention of q [B, Hq, T, D] over the packed cache; q.dtype out."""
    if not q.is_cuda:
        return int4_attention_reference(q, cache, starts)
    g = _check(q, cache, starts)
    b, hq, t, d = q.shape
    h_kv = hq // g
    if q.dtype not in _KERNELS:
        raise TypeError(f"K3 takes bf16 or f32 queries, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"K3 is built for head_dim in {_HEAD_DIMS}, got {d}")
    if g > _MAX_ROWS:
        raise ValueError(f"K3 takes at most {_MAX_ROWS} query heads per kv head, got {g}")
    operands = [
        ("k_packed", cache.k_packed, torch.uint8), ("k_scale", cache.k_scale, torch.float32),
        ("k_zp", cache.k_zp, torch.float32), ("v_packed", cache.v_packed, torch.uint8),
        ("v_scale", cache.v_scale, torch.float32), ("v_zp", cache.v_zp, torch.float32),
        ("lengths", cache.lengths, torch.int32), ("starts", starts, torch.int32),
    ]
    for name, tensor, want in operands:
        if tensor.device != q.device or tensor.dtype != want or not tensor.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {want} tensor on {q.device}; "
                f"got {tensor.dtype} on {tensor.device}, contiguous={tensor.is_contiguous()}"
            )
    q = q.contiguous()
    out = torch.empty_like(q)
    qt = max(1, _MAX_ROWS // g)
    with torch.cuda.device(q.device):
        err = getattr(_build.library(), _KERNELS[q.dtype])(
            q.data_ptr(), *(tensor.data_ptr() for _, tensor, _ in operands),
            out.data_ptr(), b, h_kv, g, t, cache.max_seq, d, qt, _build.stream_of(q),
        )
    _build.check(err, "int4_attention")
    int4_attention.launches += 1
    return out


int4_attention.launches = 0


def int4_decode_attention(q: torch.Tensor, cache) -> torch.Tensor:
    """One decode step: q [B, Hq, D] -> [B, Hq, D].

    The current step's K/V must already be appended (entry ``length - 1`` is
    the current step, so the causal mask is ``s < length``).
    """
    starts = (cache.lengths - 1).to(torch.int32)
    return int4_attention(q[:, :, None, :], cache, starts)[:, :, 0, :]


def int4_prefill_attention(q: torch.Tensor, cache, starts: torch.Tensor) -> torch.Tensor:
    """Chunked prefill: q [B, Hq, T, D], ``starts`` [B] the position of each
    row's first query; the cache holds the T new steps. Returns [B, Hq, T, D]."""
    return int4_attention(q, cache, starts.to(torch.int32).contiguous())
