"""Mixtral-style INT4 decoder (the serving slice) as ``nn.Module``s.

Counterpart of ``fused4bit_tpu/models/transformer.py`` on the default
execution mode: GQA attention with RoPE over the INT4 KV cache, SwiGLU MoE
blocks on the grouped INT4 kernel, RMSNorm, every projection a
``QuantizedLinear``. Weights, norms and the embedding are registered
buffers (the package serves; it does not train). KV caches are updated in
place (``layers.kv_cache``); ``forward`` still returns them, as the JAX
model does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.kv_cache import QuantizedKVCache
from ..layers.linear import QuantizedLinear
from ..layers.moe import MoEINT4, combine, dispatch, make_dispatch_plan, topk_route
from ..ops.decode_attention import int4_decode_attention, int4_prefill_attention
from .config import ModelConfig

__all__ = [
    "QuantizedTransformer", "TransformerBlock", "MoEBlock", "Attention",
    "rms_norm", "rotary_embedding",
]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE over [B, H, T, D] (half-split convention).

    positions: [T] (shared across the batch) or [B, T] (per slot).
    """
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]      # [T, half]
    else:
        angles = positions[:, None, :, None].float() * freqs      # [B, 1, T, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, wq: QuantizedLinear, wk: QuantizedLinear, wv: QuantizedLinear,
                 wo: QuantizedLinear, *, num_heads: int, num_kv_heads: int, head_dim: int,
                 rope_theta: float, use_fused_attention: bool = True):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.use_fused_attention = use_fused_attention

    @classmethod
    def init(cls, cfg: ModelConfig, hidden: int, *, generator=None, device=None) -> "Attention":
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        kw = dict(generator=generator, device=device)
        return cls(
            QuantizedLinear.init(hidden, nh * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(nh * hd, hidden, **kw),
            num_heads=nh, num_kv_heads=nkv, head_dim=hd, rope_theta=cfg.rope_theta,
        )

    def forward(self, x: torch.Tensor, cache: QuantizedKVCache,
                positions: torch.Tensor) -> Tuple[torch.Tensor, QuantizedKVCache]:
        """x [B, T, H]; positions [B, T] (per-slot offsets)."""
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.wq(x).reshape(b, t, nh, hd).transpose(1, 2)
        k = self.wk(x).reshape(b, t, nkv, hd).transpose(1, 2)
        v = self.wv(x).reshape(b, t, nkv, hd).transpose(1, 2)
        q = rotary_embedding(q, positions, self.rope_theta)
        k = rotary_embedding(k, positions, self.rope_theta)

        # Cache index == sequence position: row b writes at positions[b, 0].
        cache = cache.append(k, v, start=positions[:, 0])

        if self.use_fused_attention:
            if t == 1:
                out = int4_decode_attention(q[:, :, 0, :], cache)          # [B, nh, D]
            else:
                out = int4_prefill_attention(q, cache, positions[:, 0]).transpose(1, 2)
            return self.wo(out.reshape(b, t, nh * hd)), cache

        # Golden path: dequantize the whole cache, dense masked attention.
        kd, vd = cache.dequantize(dtype=q.dtype)                  # [B, nkv, S, D]
        rep = nh // nkv
        kd = kd.repeat_interleave(rep, dim=1)
        vd = vd.repeat_interleave(rep, dim=1)
        scores = torch.einsum("bhtd,bhsd->bhts", q, kd) / math.sqrt(hd)
        span = torch.arange(cache.max_seq, device=x.device)
        causal = span[None, None, :] <= positions[:, :, None]    # [B, T, S]
        scores = torch.where(causal[:, None], scores.float(), torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhts,bhsd->bhtd", probs, vd)
        return self.wo(out.transpose(1, 2).reshape(b, t, nh * hd)), cache


class MoEBlock(nn.Module):
    """SwiGLU experts on the grouped INT4 kernel, dropless tile-packed
    dispatch at every batch size: ``tile_m`` rows per tile up to
    ``prefill_threshold`` tokens, ``prefill_tile_m`` above."""

    def __init__(self, router: QuantizedLinear, w_gate: MoEINT4, w_up: MoEINT4,
                 w_down: MoEINT4, *, num_experts: int, top_k: int, tile_m: int = 16,
                 prefill_threshold: int = 512, prefill_impl: str = "grouped",
                 prefill_tile_m: int = 128, moe_impl: str = "kernel"):
        super().__init__()
        if prefill_impl != "grouped":
            raise NotImplementedError(f"prefill_impl={prefill_impl!r} is not ported yet")
        if moe_impl != "kernel":
            raise NotImplementedError(f"moe_impl={moe_impl!r} is not ported yet")
        self.router, self.w_gate, self.w_up, self.w_down = router, w_gate, w_up, w_down
        self.num_experts = num_experts
        self.top_k = top_k
        self.tile_m = tile_m
        self.prefill_threshold = prefill_threshold
        self.prefill_tile_m = prefill_tile_m

    @classmethod
    def init(cls, num_experts: int, hidden: int, ffn: int, top_k: int, tile_m: int = 16,
             *, generator=None, device=None) -> "MoEBlock":
        def experts(n, k):
            w = torch.randn((num_experts, n, k), generator=generator, device=device,
                            dtype=torch.float32) * (k ** -0.5)
            return MoEINT4.from_dense(w)

        router = QuantizedLinear.init(hidden, num_experts, generator=generator, device=device)
        return cls(router, experts(ffn, hidden), experts(ffn, hidden), experts(hidden, ffn),
                   num_experts=num_experts, top_k=top_k, tile_m=tile_m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H]
        b, t, h = x.shape
        xf = x.reshape(b * t, h)
        routing = topk_route(self.router(xf), self.top_k, self.num_experts)
        tile_m = self.prefill_tile_m if b * t > self.prefill_threshold else self.tile_m
        return self._grouped_forward(xf, routing, tile_m).reshape(b, t, h)

    def _grouped_forward(self, xf, routing, tile_m: int) -> torch.Tensor:
        """Dropless path: tile-packed dispatch -> grouped kernel -> combine."""
        plan = make_dispatch_plan(routing, self.num_experts, tile_m=tile_m)
        xs = dispatch(xf, routing, plan)                       # [T_pad, H]
        g = self.w_gate(xs, plan.tile_group_ids, tile_m=tile_m)
        u = self.w_up(xs, plan.tile_group_ids, tile_m=tile_m)
        hsw = (F.silu(g.float()) * u.float()).to(xs.dtype)
        d = self.w_down(hsw, plan.tile_group_ids, tile_m=tile_m)
        return combine(d, routing, plan)


class TransformerBlock(nn.Module):
    def __init__(self, attn_norm: torch.Tensor, attn: Attention, moe_norm: torch.Tensor,
                 moe: MoEBlock, *, rms_eps: float):
        super().__init__()
        self.register_buffer("attn_norm", attn_norm)
        self.attn = attn
        self.register_buffer("moe_norm", moe_norm)
        self.moe = moe
        self.rms_eps = rms_eps

    def forward(self, x, cache, positions):
        h, cache = self.attn(rms_norm(x, self.attn_norm, self.rms_eps), cache, positions)
        x = x + h
        x = x + self.moe(rms_norm(x, self.moe_norm, self.rms_eps))
        return x, cache


class QuantizedTransformer(nn.Module):
    """INT4 weight-only Mixtral-style decoder."""

    def __init__(self, embed: torch.Tensor, blocks: Sequence[TransformerBlock],
                 final_norm: torch.Tensor, lm_head: QuantizedLinear, *, rms_eps: float):
        super().__init__()
        self.register_buffer("embed", embed)         # [V, H]
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head
        self.rms_eps = rms_eps

    @classmethod
    def init(cls, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
             device=None, dtype=torch.bfloat16) -> "QuantizedTransformer":
        """Random weights drawn from ``generator``, built on ``device``."""
        hidden = cfg.num_heads * cfg.head_dim
        kw = dict(generator=generator, device=device)
        blocks = [
            TransformerBlock(
                torch.ones((hidden,), dtype=dtype, device=device),
                Attention.init(cfg, hidden, **kw),
                torch.ones((hidden,), dtype=dtype, device=device),
                MoEBlock.init(cfg.moe.num_experts, hidden, cfg.moe.ffn_dim, cfg.moe.top_k, **kw),
                rms_eps=cfg.rms_eps,
            )
            for _ in range(cfg.num_layers)
        ]
        embed = (torch.randn((cfg.vocab_size, hidden), generator=generator, device=device,
                             dtype=torch.float32) * 0.02).to(dtype)
        return cls(embed, blocks, torch.ones((hidden,), dtype=dtype, device=device),
                   QuantizedLinear.init(hidden, cfg.vocab_size, **kw), rms_eps=cfg.rms_eps)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int) -> Tuple[QuantizedKVCache, ...]:
        return tuple(
            QuantizedKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim, device=self.device)
            for _ in self.blocks
        )

    def forward(self, tokens: torch.Tensor, caches, positions: torch.Tensor):
        """tokens [B, T] int; positions [T] or [B, T]. Returns (logits [B, T, V],
        caches)."""
        if positions.dim() == 1:
            positions = positions[None, :].expand(tokens.shape)
        x = F.embedding(tokens, self.embed)
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, positions)
            new_caches.append(cache)
        x = rms_norm(x, self.final_norm, self.rms_eps)
        return self.lm_head(x), tuple(new_caches)
