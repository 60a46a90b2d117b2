"""Dense bf16 twin of the INT4 model: the model-level baseline (PyTorch).

Counterpart of ``fused4bit_tpu/models/dense_baseline.py``: the same
architecture with dense weights, a dense KV cache and plain PyTorch matmuls,
built from a ``QuantizedTransformer`` by dequantizing its weights
(:func:`dense_from_quantized`: the same function up to quantization error)
or straight from a checkpoint dict (:func:`dense_from_params`: the
full-precision reference a quantized conversion is measured against). It
holds no kernel. The cache is updated in place (the JAX twin returns a new
one); ``forward`` still returns it.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..layers.linear import DenseLinear
from ..layers.moe import topk_route
from ..quant.core import dequantize
from .config import ModelConfig
from .convert import Array, _dense
from .transformer import QuantizedTransformer, rms_norm, rotary_embedding

__all__ = ["DenseKVCache", "DenseBlock", "DenseTransformer", "dense_from_quantized",
           "dense_from_params"]

MOE_IMPLS = ("gather", "dense_all")


class DenseKVCache:
    """Dense K/V cache [B, H, S, D] and per-row lengths [B], updated in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor):
        self.k, self.v, self.lengths = k, v, lengths

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, max_seq: int, head_dim: int,
             dtype=torch.bfloat16, device=None) -> "DenseKVCache":
        device = resolve_device(device)
        shape = (batch, num_kv_heads, max_seq, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def nbytes(self) -> int:
        return self.k.numel() * self.k.element_size() * 2

    def append(self, k: torch.Tensor, v: torch.Tensor,
               start: Optional[torch.Tensor] = None) -> "DenseKVCache":
        """Write k, v [B, H, T, D] at positions start[b] .. start[b] + T - 1
        of each row (default: its length); the lengths become start + T."""
        start = self.lengths if start is None else start
        b, _, t, _ = k.shape
        rows = torch.arange(b, device=k.device)[:, None]
        cols = start.long()[:, None] + torch.arange(t, device=k.device)[None, :]   # [B, T]
        self.k[rows, :, cols] = k.to(self.k.dtype).transpose(1, 2)
        self.v[rows, :, cols] = v.to(self.v.dtype).transpose(1, 2)
        self.lengths.copy_(start + t)
        return self


class DenseBlock(nn.Module):
    """One decoder block with dense weights.

    ``moe_impl``: ``"gather"`` (per-token expert weight gather, the naive
    baseline: [T*k, ffn, H] weight copies) or ``"dense_all"`` (the strong
    baseline: every token through every expert, one batched einsum per
    projection, weighted by the router's top-k scores; dropless and
    gather-free). The two compute the same function."""

    def __init__(self, attn_norm, wq, wk, wv, wo, moe_norm, router, w_gate, w_up, w_down, *,
                 num_heads: int, num_kv_heads: int, head_dim: int, rope_theta: float,
                 top_k: int, rms_eps: float, moe_impl: str = "gather"):
        super().__init__()
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl={moe_impl!r} is not one of {MOE_IMPLS}")
        for name, t in (("attn_norm", attn_norm), ("wq", wq), ("wk", wk), ("wv", wv),
                        ("wo", wo), ("moe_norm", moe_norm), ("router", router),
                        ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
            self.register_buffer(name, t)   # w_gate/w_up [E, ffn, H], w_down [E, H, ffn]
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.top_k = top_k
        self.rms_eps = rms_eps
        self.moe_impl = moe_impl

    def forward(self, x: torch.Tensor, cache: DenseKVCache, positions: torch.Tensor,
                capture: Optional[list] = None):
        """x [B, T, H]; positions [B, T]. ``capture``: an optional list that
        collects ("attn_in" / "moe_in", h), the norm outputs."""
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        h = rms_norm(x, self.attn_norm, self.rms_eps)
        if capture is not None:
            capture.append(("attn_in", h))
        q = (h @ self.wq.t()).reshape(b, t, nh, hd).transpose(1, 2)
        k = (h @ self.wk.t()).reshape(b, t, nkv, hd).transpose(1, 2)
        v = (h @ self.wv.t()).reshape(b, t, nkv, hd).transpose(1, 2)
        q = rotary_embedding(q, positions, self.rope_theta)
        k = rotary_embedding(k, positions, self.rope_theta)
        cache = cache.append(k, v, start=positions[:, 0])
        rep = nh // nkv
        kd = cache.k.to(q.dtype).repeat_interleave(rep, dim=1)
        vd = cache.v.to(q.dtype).repeat_interleave(rep, dim=1)
        scores = torch.einsum("bhtd,bhsd->bhts", q, kd) / math.sqrt(hd)
        span = torch.arange(cache.max_seq, device=x.device)
        causal = span[None, None, :] <= positions[:, :, None]
        # masked_fill, not torch.where with torch.tensor(-1e30): that copies a
        # host scalar to the card, which a CUDA graph capture refuses
        scores = scores.float().masked_fill(~causal[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        attn = torch.einsum("bhts,bhsd->bhtd", probs, vd)
        x = x + attn.transpose(1, 2).reshape(b, t, nh * hd) @ self.wo.t()

        h = rms_norm(x, self.moe_norm, self.rms_eps)
        if capture is not None:
            capture.append(("moe_in", h))
        hf = h.reshape(b * t, -1)
        routing = topk_route(hf @ self.router.t(), self.top_k, self.router.shape[0])
        if self.moe_impl == "dense_all":
            g = torch.einsum("th,efh->tef", hf, self.w_gate)
            u = torch.einsum("th,efh->tef", hf, self.w_up)
            act = (F.silu(g.float()) * u.float()).to(hf.dtype)
            d = torch.einsum("tef,ehf->teh", act, self.w_down)            # [T, E, H]
            wmat = torch.zeros((b * t, self.router.shape[0]), dtype=torch.float32,
                               device=x.device)
            wmat.scatter_add_(1, routing.expert_indices.long(), routing.expert_weights.float())
            y = torch.einsum("teh,te->th", d.float(), wmat).to(hf.dtype)
        else:
            idx = routing.expert_indices.long()
            g = torch.einsum("bh,bkfh->bkf", hf, self.w_gate[idx])
            u = torch.einsum("bh,bkfh->bkf", hf, self.w_up[idx])
            act = (F.silu(g.float()) * u.float()).to(hf.dtype)
            d = torch.einsum("bkf,bkhf->bkh", act, self.w_down[idx])
            y = (d * routing.expert_weights[..., None].to(d.dtype)).sum(dim=1)
        return x + y.reshape(b, t, -1), cache


class DenseTransformer(nn.Module):
    """The dense decoder: embedding, :class:`DenseBlock` s, final norm and a
    dense lm_head."""

    def __init__(self, embed: torch.Tensor, blocks: Sequence[DenseBlock],
                 final_norm: torch.Tensor, lm_head: torch.Tensor, *, rms_eps: float):
        super().__init__()
        self.register_buffer("embed", embed)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.register_buffer("lm_head", lm_head)
        self.rms_eps = rms_eps

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int,
                   dtype=torch.bfloat16) -> Tuple[DenseKVCache, ...]:
        return tuple(DenseKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim, dtype,
                                       device=self.embed.device)
                     for _ in self.blocks)

    def forward(self, tokens: torch.Tensor, caches, positions: torch.Tensor,
                capture: Optional[list] = None):
        """tokens [B, T]; positions [T] or [B, T]. Returns (logits [B, T, V],
        caches)."""
        if positions.dim() == 1:
            positions = positions[None, :].expand(tokens.shape)
        x = self.embed[tokens]
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, positions, capture=capture)
            new_caches.append(cache)
        x = rms_norm(x, self.final_norm, self.rms_eps)
        if capture is not None:
            capture.append(("final_in", x))
        return x @ self.lm_head.t(), tuple(new_caches)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.buffers())


def _dense_weight(lin, dtype) -> torch.Tensor:
    """A linear's weight, dense, in ``dtype``: a ``DenseLinear``'s as held, a
    ``QuantizedLinear``'s dequantized."""
    if isinstance(lin, DenseLinear):
        return lin.weight.to(dtype)
    return dequantize(lin.weight, dtype=dtype)


def dense_from_quantized(model: QuantizedTransformer, dtype=torch.bfloat16,
                         moe_impl: str = "gather") -> DenseTransformer:
    """Dequantize an INT4 model into its dense twin (``moe_impl``: see
    :class:`DenseBlock`)."""
    blocks = []
    for blk in model.blocks:
        attn, moe = blk.attn, blk.moe
        blocks.append(DenseBlock(
            blk.attn_norm, *(_dense_weight(lin, dtype) for lin in (attn.wq, attn.wk, attn.wv,
                                                                   attn.wo)),
            blk.moe_norm, _dense_weight(moe.router, dtype),
            *(dequantize(ex.weight, dtype=dtype) for ex in (moe.w_gate, moe.w_up, moe.w_down)),
            num_heads=attn.num_heads, num_kv_heads=attn.num_kv_heads, head_dim=attn.head_dim,
            rope_theta=attn.rope_theta, top_k=moe.top_k, rms_eps=blk.rms_eps,
            moe_impl=moe_impl,
        ))
    return DenseTransformer(model.embed.to(dtype), blocks, model.final_norm,
                            _dense_weight(model.lm_head, dtype), rms_eps=model.rms_eps)


def dense_from_params(params: Mapping[str, Array], cfg: ModelConfig, dtype=torch.bfloat16,
                      moe_impl: str = "gather", device=None) -> DenseTransformer:
    """The dense twin straight from a flat checkpoint dict (the key schema of
    ``models.convert``), every weight in ``dtype`` on ``device`` (None: the
    CUDA card): the reference a quantized conversion of the same checkpoint
    is measured against."""
    device = resolve_device(device)

    def g(key: str) -> torch.Tensor:
        return _dense(params[key], device).to(dtype)

    e = cfg.moe.num_experts
    blocks = []
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        blocks.append(DenseBlock(
            g(f"{pre}.attn_norm.weight"),
            *(g(f"{pre}.attn.{p}_proj.weight") for p in "qkvo"),
            g(f"{pre}.moe_norm.weight"), g(f"{pre}.moe.router.weight"),
            *(torch.stack([g(f"{pre}.moe.experts.{i}.{w}.weight") for i in range(e)])
              for w in ("w1", "w3", "w2")),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, top_k=cfg.moe.top_k, rms_eps=cfg.rms_eps,
            moe_impl=moe_impl,
        ))
    return DenseTransformer(g("embed.weight"), blocks, g("final_norm.weight"),
                            g("lm_head.weight"), rms_eps=cfg.rms_eps)
