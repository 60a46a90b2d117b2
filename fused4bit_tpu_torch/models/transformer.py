"""Mixtral-style INT4 decoder (the serving slice) as ``nn.Module``s.

Counterpart of ``fused4bit_tpu/models/transformer.py``: GQA attention with
RoPE over the INT4 KV cache, SwiGLU MoE blocks on the grouped INT4 kernels,
RMSNorm, every projection a ``QuantizedLinear``. Weights, norms and the
embedding are registered buffers (the package serves; it does not train).
KV caches are updated in place (``layers.kv_cache``); ``forward`` still
returns them, as the JAX model does.

Execution modes, as in the JAX package: the default (w4a16 kernels K1, K2),
and the converters ``as_turbo`` (w4a8 kernels K5/K4 and K10 everywhere),
``as_u4_turbo`` (w4a8 kernels at decode; transient i8 unpack + integer GEMM
and the capacity MoE layout at prefill) and ``as_xla_turbo`` (i8-resident
weight copies and integer GEMMs); ``as_per_group`` requantizes the weights
per group (kernels K7 and K13, or K8 and K14 after ``as_turbo``).

Every constructor builds on the CUDA card unless ``device`` names another.

Beside Mixtral's decoder the same modules build the port's other decoders
from a ``ModelConfig`` (``models.config``): window layers whose contiguous
caches are rings (``layers.kv_cache``) beside full layers; a sigmoid router
with a selection bias and a routed scale; a shared SwiGLU expert added to
the routed sum; leading dense SwiGLU layers (:class:`DenseMLP`); an expert
layer that holds a share of the experts (it routes over all of them and
computes its own experts' part); and the EXAONE 4.0 block (``block=
"exaone4"``): RMSNorm over head_dim on q and k, RoPE on the window layers
only, and each sublayer's output normed before its residual add, with no
norm before it; DeepSeek-V3's multi-head latent attention
(:class:`MLAttention`, a config with a ``kv_lora_rank``) over a latent
cache, with YaRN RoPE, and its router limited to the best groups of
experts.

Each layer's work runs inside a layer span (``utils.profiling.span``:
``embed``, ``norm``, ``residual``, ``attention.rope``,
``attention.kv_append``, ``attention.kernel`` (on a window layer inside
``attention.window``; on a latent layer these three and
``attention.mla.absorb`` inside ``attention.mla``), ``moe.route``,
``moe.swiglu``, ``moe.shared``, ``moe.combine``, ``mlp.dense``; ``linear``
and ``experts`` in the layers),
and :meth:`QuantizedTransformer.forward` is a top-level entry of them.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..layers.kv_cache import LatentKVCache, QuantizedKVCache
from ..layers.linear import DenseLinear, QuantizedLinear
from ..layers.paged_kv import PagedKVCache
from ..layers.moe import (
    DispatchPlan,
    MoEINT4,
    RoutingResult,
    combine,
    dispatch,
    local_routing,
    make_capacity_plan,
    make_dispatch_plan,
    sigmoid_route,
    topk_route,
)
from ..ops.decode_attention import int4_decode_attention, int4_prefill_attention, key_mask
from ..ops.grouped_matmul import grouped_int4_matmul, grouped_int4_matmul_per_group
from ..ops.mla_attention import mla_attention
from ..ops.int8_xla import int4_grouped_transient, int8_grouped_capacity, to_int8_resident
from ..quant.core import dequantize, quantize
from ..utils.profiling import entry, span
from .config import ModelConfig, YaRN, port_config

KVCache = Union[QuantizedKVCache, PagedKVCache, LatentKVCache]

__all__ = [
    "QuantizedTransformer", "TransformerBlock", "MoEBlock", "DenseMLP", "Attention",
    "MLAttention", "rms_norm", "rotary_embedding", "yarn_inv_freq", "yarn_mscale", "as_turbo",
    "as_u4_turbo", "as_xla_turbo", "as_per_group",
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


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor: ``0.1 mscale ln(scale) + 1`` above a scale
    of 1, else 1 (DeepSeek-V3's ``yarn_get_mscale``)."""
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(dim: int, theta: float, yarn: Optional[YaRN], device=None) -> torch.Tensor:
    """The rotary frequencies [dim / 2] (f32) of a RoPE of ``dim`` channels:
    ``theta^(-2i/dim)``, and with YaRN those of the channels below the
    correction range of ``beta_fast``..``beta_slow`` rotations over the
    original positions divided by ``factor``, a linear ramp between
    (DeepSeek-V3's ``precompute_freqs_cis``)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if yarn is None:
        return freqs

    def correction_dim(rotations):
        return dim * math.log(yarn.original_max_position_embeddings
                              / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return freqs / yarn.factor * ramp + freqs * (1 - ramp)


def rotary_interleaved(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                       factor: float = 1.0) -> torch.Tensor:
    """RoPE over channel pairs (2i, 2i + 1) of x [B, T, ..., R] at positions
    [B, T] (the published DeepSeek-V3 code's layout), cos and sin times
    ``factor``; computed in f32, returned in x.dtype."""
    angles = positions.float()[..., None] * inv_freq                       # [B, T, R/2]
    angles = angles.reshape(*angles.shape[:2], *([1] * (x.dim() - 3)), angles.shape[-1])
    cos, sin = torch.cos(angles) * factor, torch.sin(angles) * factor
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2).to(x.dtype)


class Attention(nn.Module):
    """GQA attention over the INT4 KV cache. ``window``: the positions a
    query sees on this layer (0: all), held by the layer's cache (built by
    ``QuantizedTransformer.init_cache``); ``q_norm``/``k_norm``: RMSNorm
    weights over head_dim applied to q and k (None: none); ``rope``: whether
    q and k are rotated."""

    def __init__(self, wq: QuantizedLinear, wk: QuantizedLinear, wv: QuantizedLinear,
                 wo: QuantizedLinear, *, num_heads: int, num_kv_heads: int, head_dim: int,
                 rope_theta: float, use_fused_attention: bool = True, window: int = 0,
                 q_norm: Optional[torch.Tensor] = None, k_norm: Optional[torch.Tensor] = None,
                 rope: bool = True, rms_eps: float = 1e-5):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta
        self.use_fused_attention = use_fused_attention
        self.window = window
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("k_norm", k_norm)
        self.rope = rope
        self.rms_eps = rms_eps

    # the projections, by attribute name (the mode converters walk them)
    LINEARS = ("wq", "wk", "wv", "wo")

    @classmethod
    def init(cls, cfg: ModelConfig, hidden: int, *, layer: int = 0, generator=None,
             device=None, dtype=torch.bfloat16) -> "Attention":
        cfg = port_config(cfg)
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        window = cfg.window(layer)
        exaone = cfg.block == "exaone4"
        norm = (lambda: torch.ones((hd,), dtype=dtype, device=device)) if exaone else (lambda: None)
        return cls(
            QuantizedLinear.init(hidden, nh * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(nh * hd, hidden, **kw),
            num_heads=nh, num_kv_heads=nkv, head_dim=hd, rope_theta=cfg.rope_theta,
            window=window, q_norm=norm(), k_norm=norm(), rope=bool(window) or not exaone,
            rms_eps=cfg.rms_eps,
        )

    def forward(self, x: torch.Tensor, cache: KVCache,
                positions: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """x [B, T, H]; positions [B, T] (per-slot offsets). ``cache`` is
        contiguous or paged; the fused path dispatches on its type (K3 or
        K3'), the golden path reads its logical dequantized view."""
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if getattr(cache, "ring", False) and t > cache.max_seq - cache.window:
            raise ValueError(f"a forward of {t} positions overruns the ring of {cache.max_seq} "
                             f"slots at window {cache.window}; size the cache for it "
                             "(QuantizedTransformer.init_cache's max_tokens)")
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        with span("attention.rope"):
            q = q.reshape(b, t, nh, hd).transpose(1, 2)
            k = k.reshape(b, t, nkv, hd).transpose(1, 2)
            v = v.reshape(b, t, nkv, hd).transpose(1, 2)
            if self.q_norm is not None:
                q = rms_norm(q, self.q_norm, self.rms_eps)
                k = rms_norm(k, self.k_norm, self.rms_eps)
            if self.rope:
                q = rotary_embedding(q, positions, self.rope_theta)
                k = rotary_embedding(k, positions, self.rope_theta)

        # Cache index == sequence position: row b writes at positions[b, 0].
        with span("attention.kv_append"):
            cache = cache.append(k, v, start=positions[:, 0])

        if self.use_fused_attention:
            # a window layer's call sits inside ``attention.window``, so that
            # ``attention.kernel``'s own nodes are every K3 call
            with (span("attention.window") if self.window else contextlib.nullcontext()), \
                    span("attention.kernel"):
                if t == 1:
                    out = int4_decode_attention(q[:, :, 0, :], cache)      # [B, nh, D]
                else:
                    out = int4_prefill_attention(q, cache, positions[:, 0]).transpose(1, 2)
                out = out.reshape(b, t, nh * hd)
            return self.wo(out), cache

        # Golden path: dequantize the whole (logical) cache, dense masked attention.
        view = cache.logical() if isinstance(cache, PagedKVCache) else cache
        kd, vd = view.dequantize(dtype=q.dtype)                   # [B, nkv, S, D]
        rep = nh // nkv
        kd = kd.repeat_interleave(rep, dim=1)
        vd = vd.repeat_interleave(rep, dim=1)
        scores = torch.einsum("bhtd,bhsd->bhts", q, kd) / math.sqrt(hd)
        causal = key_mask(view, positions.long())                  # [B, T, S]
        scores = torch.where(causal[:, None], scores.float(), torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhts,bhsd->bhtd", probs, vd)
        return self.wo(out.transpose(1, 2).reshape(b, t, nh * hd)), cache


class MLAttention(nn.Module):
    """DeepSeek-V3's multi-head latent attention over a :class:`LatentKVCache`.

    Per layer: ``c_q = RMSNorm(W_DQ x)`` (``wq_a``), ``[q_nope, q_pe] = W_UQ
    c_q`` per head (``wq_b``); ``[c_KV, k_pe] = W_DKV x`` (``wkv_a``),
    ``c_KV = RMSNorm(c_KV)``, ``k_pe = RoPE(k_pe)`` shared by every head;
    ``q_pe = RoPE(q_pe)``; attention over ``q_nope . k_nope + q_pe . k_pe``
    with ``k_nope, v = W_UKV c_KV``, then ``wo``. RoPE is YaRN's over channel
    pairs; the softmax scale ``(qk_nope + qk_rope)^-0.5 mscale^2``.

    Every forward, decode and prefill alike, runs the absorbed form: the
    cache holds c_KV and k_pe; each head's q_nope is taken into latent space
    by ``W_UK^T`` (``w_uk``: [H, L, qk_nope], one group of 128 a row along
    its input, per row on K2), kernel K15 (``ops.mla_attention``) attends in
    latent space, and ``W_UV`` (``w_uv``: [H, v, L], per group of 128 along L,
    K13) takes each head's output back. Both absorptions run the grouped
    matmul with the heads as its groups, each head taking every row, in
    tiles of :attr:`TILE_M` rows (the rows padded to a whole tile). The mode
    converters convert :attr:`LINEARS`; ``w_uk`` and ``w_uv`` keep their
    layout and bf16 activations in every mode."""

    window = 0               # every position is seen
    LINEARS = ("wq_a", "wq_b", "wkv_a", "wo")
    TILE_M = 16
    UV_GROUP = 128

    def __init__(self, wq_a, q_norm: torch.Tensor, wq_b, wkv_a, kv_norm: torch.Tensor,
                 w_uk: MoEINT4, w_uv: MoEINT4, wo, *, num_heads: int, qk_nope_dim: int,
                 qk_rope_dim: int, v_head_dim: int, rope_theta: float,
                 yarn: Optional[YaRN] = None, rms_eps: float = 1e-6):
        super().__init__()
        self.wq_a, self.wq_b, self.wkv_a, self.wo = wq_a, wq_b, wkv_a, wo
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("kv_norm", kv_norm)
        self.w_uk, self.w_uv = w_uk, w_uv
        self.num_heads = num_heads
        self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim = qk_nope_dim, qk_rope_dim, v_head_dim
        self.kv_lora_rank = kv_norm.shape[0]
        self.register_buffer("inv_freq", yarn_inv_freq(qk_rope_dim, rope_theta, yarn,
                                                       device=q_norm.device), persistent=False)
        self.rope_factor = (yarn_mscale(yarn.factor, yarn.mscale)
                            / yarn_mscale(yarn.factor, yarn.mscale_all_dim)) if yarn else 1.0
        mscale = yarn_mscale(yarn.factor, yarn.mscale_all_dim) if yarn else 1.0
        self.softmax_scale = (qk_nope_dim + qk_rope_dim) ** -0.5 * mscale * mscale
        self.rms_eps = rms_eps

    @staticmethod
    def absorbed(kv_b: torch.Tensor, num_heads: int,
                 qk_nope_dim: int) -> Tuple[MoEINT4, MoEINT4]:
        """(``w_uk``, ``w_uv``) from a dense ``W_UKV`` [H (qk_nope + v), L]
        (``kv_b_proj``, head-major): ``W_UK^T`` [H, L, qk_nope] quantized per
        row (one group along qk_nope), ``W_UV`` [H, v, L] per group of
        :attr:`UV_GROUP` along L."""
        w = kv_b.reshape(num_heads, -1, kv_b.shape[-1])
        w_uk = MoEINT4.from_dense(w[:, :qk_nope_dim].transpose(1, 2).contiguous())
        return w_uk, MoEINT4.from_dense(w[:, qk_nope_dim:].contiguous(), granularity="per_group",
                                        group_size=MLAttention.UV_GROUP)

    @classmethod
    def init(cls, cfg: ModelConfig, hidden: int, *, generator=None, device=None,
             dtype=torch.bfloat16) -> "MLAttention":
        device = resolve_device(device)
        kw = dict(generator=generator, device=device)
        nh, dn, dr, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        lr = cfg.kv_lora_rank
        kv_b = torch.randn((nh * (dn + dv), lr), generator=generator, device=device,
                           dtype=torch.float32) * (lr ** -0.5)
        w_uk, w_uv = cls.absorbed(kv_b, nh, dn)
        return cls(QuantizedLinear.init(hidden, cfg.q_lora_rank, **kw),
                   torch.ones((cfg.q_lora_rank,), dtype=dtype, device=device),
                   QuantizedLinear.init(cfg.q_lora_rank, nh * (dn + dr), **kw),
                   QuantizedLinear.init(hidden, lr + dr, **kw),
                   torch.ones((lr,), dtype=dtype, device=device), w_uk, w_uv,
                   QuantizedLinear.init(nh * dv, hidden, **kw),
                   num_heads=nh, qk_nope_dim=dn, qk_rope_dim=dr, v_head_dim=dv,
                   rope_theta=cfg.rope_theta, yarn=cfg.yarn, rms_eps=cfg.rms_eps)

    def _grouped(self, x: torch.Tensor, w: MoEINT4) -> torch.Tensor:
        """x [H, rows, K] -> [H, rows_pad, N]: each head's rows times its own
        weight, through the grouped matmul (rows padded to whole tiles)."""
        h, rows, k = x.shape
        tile = self.TILE_M
        tiles = -(-rows // tile)
        if tiles * tile > rows:
            x = F.pad(x, (0, 0, 0, tiles * tile - rows))
        xs = x.reshape(h * tiles * tile, k)
        gids = torch.div(torch.arange(h * tiles, dtype=torch.int32, device=x.device), tiles,
                         rounding_mode="floor")
        qt = w.weight
        op = grouped_int4_matmul if qt.granularity == "per_row" else grouped_int4_matmul_per_group
        return op(xs, gids, qt, tile_m=tile).reshape(h, tiles * tile, -1)

    def forward(self, x: torch.Tensor, cache: LatentKVCache,
                positions: torch.Tensor) -> Tuple[torch.Tensor, LatentKVCache]:
        """x [B, T, H]; positions [B, T] (per-slot offsets)."""
        b, t, _ = x.shape
        nh, dn, lr = self.num_heads, self.qk_nope_dim, self.kv_lora_rank
        with span("attention.mla"):
            cq, kv = self.wq_a(x), self.wkv_a(x)
            with span("attention.rope"):
                cq = rms_norm(cq, self.q_norm, self.rms_eps)
            q = self.wq_b(cq).reshape(b, t, nh, -1)
            with span("attention.rope"):
                c_kv = rms_norm(kv[..., :lr], self.kv_norm, self.rms_eps)
                k_pe = rotary_interleaved(kv[..., lr:], positions, self.inv_freq,
                                          self.rope_factor)
                q_pe = rotary_interleaved(q[..., dn:], positions, self.inv_freq,
                                          self.rope_factor)
            with span("attention.kv_append"):
                cache = cache.append(c_kv, k_pe, start=positions[:, 0])
            with span("attention.mla.absorb"):
                q_lat = self._grouped(q[..., :dn].reshape(b * t, nh, dn).transpose(0, 1),
                                      self.w_uk)                             # [H, rows_pad, L]
            with span("attention.kernel"):
                o_lat = mla_attention(q_lat, q_pe, cache, positions[:, 0], self.softmax_scale)
            with span("attention.mla.absorb"):
                o = self._grouped(o_lat, self.w_uv)[:, :b * t]              # [H, rows, v]
                o = o.transpose(0, 1).reshape(b, t, -1)
            return self.wo(o), cache


class MoEBlock(nn.Module):
    """SwiGLU experts on the grouped INT4 kernels.

    ``moe_impl="kernel"``: dropless tile-packed dispatch, ``tile_m`` rows per
    tile up to ``prefill_threshold`` tokens; above it ``prefill_impl``
    picks the dropless grouped kernel at ``prefill_tile_m`` ("grouped") or
    the capacity layout with dequantize-once einsums ("einsum").
    ``"u4_turbo"`` / ``"xla_turbo"``: dropless grouped kernel up to the
    threshold; above it the capacity layout (pairs past ``capacity_factor``
    x the mean load are dropped) with integer GEMMs on transient (u4) or
    resident (xla) i8 weights. ``router``: a ``QuantizedLinear``, or the
    ``DenseLinear`` (a plain matmul) that ``models.convert`` builds by
    default; the mode converters pass a ``DenseLinear`` through unchanged.

    ``router_bias`` (f32 [E]): the router is a sigmoid one
    (``layers.moe.sigmoid_route``: this bias added for the selection,
    weights scaled by ``routed_scale``); None: softmax top-k. The expert
    stacks may hold a share of the ``num_experts`` the router routes over,
    experts [``first_expert``, ``first_expert`` + E_held): every path then
    computes their part alone (the grouped path through
    ``layers.moe.local_routing``, the capacity paths on the whole block's
    plan cut to their segment), with no exchange. ``shared``: a
    :class:`DenseMLP` every token runs, added to the routed sum.
    ``n_group``/``topk_group``: the sigmoid router chooses inside the
    ``topk_group`` best of ``n_group`` groups of experts.
    """

    def __init__(self, router: Union[QuantizedLinear, DenseLinear], w_gate: MoEINT4,
                 w_up: MoEINT4, w_down: MoEINT4, *, num_experts: int, top_k: int,
                 tile_m: int = 16, prefill_threshold: int = 512, prefill_impl: str = "grouped",
                 prefill_tile_m: int = 128, capacity_factor: float = 2.0,
                 moe_impl: str = "kernel", router_bias: Optional[torch.Tensor] = None,
                 routed_scale: float = 1.0, first_expert: int = 0,
                 shared: Optional["DenseMLP"] = None, n_group: int = 1, topk_group: int = 1):
        super().__init__()
        if prefill_impl not in ("grouped", "einsum"):
            raise ValueError(f"prefill_impl={prefill_impl!r} is not 'grouped' or 'einsum'")
        if moe_impl not in ("kernel", "u4_turbo", "xla_turbo"):
            raise ValueError(f"moe_impl={moe_impl!r} is not 'kernel', 'u4_turbo' or 'xla_turbo'")
        self.router, self.w_gate, self.w_up, self.w_down = router, w_gate, w_up, w_down
        self.register_buffer("router_bias", router_bias)
        self.routed_scale = routed_scale
        self.first_expert = first_expert
        self.shared = shared
        self.n_group, self.topk_group = n_group, topk_group
        self.num_experts = num_experts
        self.top_k = top_k
        self.tile_m = tile_m
        self.prefill_threshold = prefill_threshold
        self.prefill_impl = prefill_impl
        self.prefill_tile_m = prefill_tile_m
        self.capacity_factor = capacity_factor
        self.moe_impl = moe_impl

    @classmethod
    def init(cls, num_experts: int, hidden: int, ffn: int, top_k: int, tile_m: int = 16,
             *, generator=None, device=None, cfg: Optional[ModelConfig] = None,
             dtype=torch.bfloat16) -> "MoEBlock":
        """Random weights. ``cfg`` (optional) adds its router rule, its share
        of the experts and its shared expert: a sigmoid router is a bf16
        ``DenseLinear`` with a zero bias, as checkpoints leave the gate."""
        device = resolve_device(device)
        held, first = (cfg.held, cfg.first_expert) if cfg else (num_experts, 0)

        def experts(n, k):
            w = torch.randn((held, n, k), generator=generator, device=device,
                            dtype=torch.float32) * (k ** -0.5)
            return MoEINT4.from_dense(w)

        kw = {}
        if cfg is not None and cfg.router == "sigmoid":
            w = torch.randn((num_experts, hidden), generator=generator, device=device,
                            dtype=torch.float32) * (hidden ** -0.5)
            router = DenseLinear(w.to(dtype))
            kw = dict(router_bias=torch.zeros((num_experts,), dtype=torch.float32,
                                              device=device),
                      routed_scale=cfg.routed_scale, n_group=cfg.n_group,
                      topk_group=cfg.topk_group)
        else:
            router = QuantizedLinear.init(hidden, num_experts, generator=generator, device=device)
        if cfg is not None and cfg.shared_ffn:
            kw["shared"] = DenseMLP.init(hidden, cfg.shared_ffn, span_name="moe.shared",
                                         generator=generator, device=device)
        return cls(router, experts(ffn, hidden), experts(ffn, hidden), experts(hidden, ffn),
                   num_experts=num_experts, top_k=top_k, tile_m=tile_m, first_expert=first,
                   **kw)

    def route(self, logits: torch.Tensor) -> RoutingResult:
        """The routing over all ``num_experts`` from router logits [T, E]."""
        if self.router_bias is None:
            return topk_route(logits, self.top_k, self.num_experts)
        return sigmoid_route(logits, self.router_bias, self.top_k, self.num_experts,
                             self.routed_scale, self.n_group, self.topk_group)

    @property
    def held(self) -> int:
        """The routed experts this block's stacks hold."""
        return self.w_gate.packed.shape[0]

    def _first_held(self) -> int:
        """The global id of the first expert the stacks hold."""
        return self.first_expert

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H]
        return self._with_shared(self._routed(x), x)

    def _with_shared(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The routed experts' sum ``out`` plus the shared expert's output."""
        if self.shared is None:
            return out
        shared = self.shared(x)
        with span("moe.combine"):
            return out + shared

    def _routed(self, x: torch.Tensor) -> torch.Tensor:
        """The routed experts' part [B, T, H] (the held experts' alone)."""
        b, t, h = x.shape
        with span("moe.route"):
            xf = x.reshape(b * t, h)
            routing = self.route(self.router(xf))
        # per_group scales cannot fold past an integer dot: under u4_turbo
        # such experts take the dropless grouped path at every size (JAX's
        # transient_ok rule)
        transient_ok = self.w_gate.granularity in ("per_row", "per_tensor")
        capacity_i8 = self.moe_impl == "xla_turbo" or (self.moe_impl == "u4_turbo"
                                                        and transient_ok)
        if b * t <= self.prefill_threshold:
            out = self._grouped_forward(xf, routing, self.tile_m)
        elif capacity_i8:
            out = self._capacity_i8_forward(xf, routing, transient=self.moe_impl == "u4_turbo")
        elif self.prefill_impl == "einsum":
            out = self._prefill_forward(xf, routing)
        else:
            out = self._grouped_forward(xf, routing, self.prefill_tile_m)
        with span("moe.combine"):
            return out.reshape(b, t, h)

    def _grouped_forward(self, xf, routing, tile_m: int) -> torch.Tensor:
        """Dropless path: tile-packed dispatch -> grouped kernel -> combine,
        over the experts held here (their pairs alone, when the stacks hold a
        share)."""
        with span("moe.route"):
            if self.held != self.num_experts:
                routing = local_routing(routing.expert_indices, routing.expert_weights,
                                        self._first_held(), self.held)
            plan = make_dispatch_plan(routing, routing.tokens_per_expert.shape[0], tile_m=tile_m)
            xs = dispatch(xf, routing, plan)                   # [T_pad, H]
        g = self.w_gate(xs, plan.tile_group_ids, tile_m=tile_m)
        u = self.w_up(xs, plan.tile_group_ids, tile_m=tile_m)
        with span("moe.swiglu"):
            hsw = (F.silu(g.float()) * u.float()).to(xs.dtype)
        d = self.w_down(hsw, plan.tile_group_ids, tile_m=tile_m)
        with span("moe.combine"):
            return combine(d, routing, plan)

    def _capacity_plan(self, xf, routing):
        """Capacity ``cf x mean load``, rounded up to ``tile_m``, by the JAX
        package's own float expression, and its plan."""
        tk = xf.shape[0] * self.top_k
        cf = self.capacity_factor
        cap = int(-(-cf * tk // self.num_experts // self.tile_m)) * self.tile_m
        plan = make_capacity_plan(routing, self.num_experts, capacity=cap, tile_m=self.tile_m)
        if self.held == self.num_experts:
            return cap, plan
        # the held experts' segment of the whole block's plan: a pair is kept
        # or dropped as in the whole block
        t_pad = self.held * cap
        rows = plan.rows - self._first_held() * cap
        rows = torch.where((rows >= 0) & (rows < t_pad), rows, torch.full_like(rows, t_pad))
        return cap, DispatchPlan(rows, plan.tile_group_ids[:t_pad // self.tile_m], t_pad,
                                 self.tile_m, drops=True)

    def _capacity_i8_forward(self, xf, routing, *, transient: bool) -> torch.Tensor:
        """Capacity layout + integer GEMMs per expert: on transient i8 weights
        unpacked from the packed bytes (u4_turbo), or on the resident i8
        copies (xla_turbo)."""
        cap, plan = self._capacity_plan(xf, routing)
        xs = dispatch(xf, routing, plan)                       # [E*C, H]
        xe = xs.reshape(-1, cap, xs.shape[1])
        if transient:
            def mm(a, lin):
                return int4_grouped_transient(a, lin.weight)
        else:
            def mm(a, lin):
                return int8_grouped_capacity(a, lin.w8)
        g = mm(xe, self.w_gate)
        u = mm(xe, self.w_up)
        hsw = (F.silu(g.float()) * u.float()).to(xs.dtype)
        d = mm(hsw, self.w_down)
        return combine(d.reshape(xs.shape), routing, plan)

    def _prefill_forward(self, xf, routing) -> torch.Tensor:
        """Capacity layout + dequantize-once einsums (prefill_impl="einsum")."""
        cap, plan = self._capacity_plan(xf, routing)
        xs = dispatch(xf, routing, plan)
        xe = xs.reshape(-1, cap, xs.shape[1])
        dt = xs.dtype
        g = torch.einsum("ech,enh->ecn", xe, dequantize(self.w_gate.weight, dtype=dt))
        u = torch.einsum("ech,enh->ecn", xe, dequantize(self.w_up.weight, dtype=dt))
        hsw = (F.silu(g.float()) * u.float()).to(dt)
        d = torch.einsum("ecn,ehn->ech", hsw, dequantize(self.w_down.weight, dtype=dt))
        return combine(d.reshape(xs.shape), routing, plan)


class DenseMLP(nn.Module):
    """A dense SwiGLU, ``down(silu(gate(x)) * up(x))``, on the INT4 linears:
    a leading dense layer's feed-forward (span ``mlp.dense``) or a MoE
    block's shared expert (``moe.shared``)."""

    def __init__(self, w_gate: QuantizedLinear, w_up: QuantizedLinear, w_down: QuantizedLinear,
                 *, span_name: str = "mlp.dense"):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
        self.span_name = span_name

    @classmethod
    def init(cls, hidden: int, ffn: int, *, span_name: str = "mlp.dense", generator=None,
             device=None) -> "DenseMLP":
        kw = dict(generator=generator, device=resolve_device(device))
        return cls(QuantizedLinear.init(hidden, ffn, **kw), QuantizedLinear.init(hidden, ffn, **kw),
                   QuantizedLinear.init(ffn, hidden, **kw), span_name=span_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span(self.span_name):
            g, u = self.w_gate(x), self.w_up(x)
            h = (F.silu(g.float()) * u.float()).to(x.dtype)
            return self.w_down(h)


class TransformerBlock(nn.Module):
    """Attention, then the feed-forward sublayer ``moe`` (a :class:`MoEBlock`,
    or a :class:`DenseMLP` in a leading dense layer). Pre-norm (Mixtral):
    ``h = x + attn(norm_a(x)); y = h + moe(norm_f(h))``; ``post_norm``
    (EXAONE 4.0): ``h = x + norm_a(attn(x)); y = h + norm_f(moe(h))``."""

    def __init__(self, attn_norm: torch.Tensor, attn: Attention, moe_norm: torch.Tensor,
                 moe: Union[MoEBlock, DenseMLP], *, rms_eps: float, post_norm: bool = False):
        super().__init__()
        self.register_buffer("attn_norm", attn_norm)
        self.attn = attn
        self.register_buffer("moe_norm", moe_norm)
        self.moe = moe
        self.rms_eps = rms_eps
        self.post_norm = post_norm

    def forward(self, x, cache, positions):
        if self.post_norm:
            h, cache = self.attn(x, cache, positions)
            with span("norm"):
                h = rms_norm(h, self.attn_norm, self.rms_eps)
            with span("residual"):
                x = x + h
            h = self.moe(x)
            with span("norm"):
                h = rms_norm(h, self.moe_norm, self.rms_eps)
            with span("residual"):
                return x + h, cache
        with span("norm"):
            h = rms_norm(x, self.attn_norm, self.rms_eps)
        h, cache = self.attn(h, cache, positions)
        with span("residual"):
            x = x + h
        with span("norm"):
            h = rms_norm(x, self.moe_norm, self.rms_eps)
        h = self.moe(h)
        with span("residual"):
            x = x + h
        return x, cache


class QuantizedTransformer(nn.Module):
    """INT4 weight-only Mixtral-style decoder. ``awq_alphas``: set by
    ``models.convert.convert_checkpoint`` with ``awq_tokens``, each AWQ
    site's chosen alpha (None: the identity); None otherwise."""

    def __init__(self, embed: torch.Tensor, blocks: Sequence[TransformerBlock],
                 final_norm: torch.Tensor, lm_head: Union[QuantizedLinear, DenseLinear], *,
                 rms_eps: float):
        super().__init__()
        self.register_buffer("embed", embed)         # [V, H]
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head
        self.rms_eps = rms_eps
        self.awq_alphas = None

    @classmethod
    def init(cls, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
             device=None, dtype=torch.bfloat16) -> "QuantizedTransformer":
        """Random weights drawn from ``generator``, built on ``device`` (None:
        the CUDA card; ``device="cpu"`` builds for the plain versions)."""
        device = resolve_device(device)
        cfg = port_config(cfg)
        hidden = cfg.hidden
        kw = dict(generator=generator, device=device)

        def ffn(layer):
            if layer < cfg.dense_layers:
                return DenseMLP.init(hidden, cfg.dense_ffn, **kw)
            return MoEBlock.init(cfg.moe.num_experts, hidden, cfg.moe.ffn_dim, cfg.moe.top_k,
                                 cfg=cfg, dtype=dtype, **kw)

        blocks = [
            TransformerBlock(
                torch.ones((hidden,), dtype=dtype, device=device),
                (MLAttention.init(cfg, hidden, dtype=dtype, **kw) if cfg.kv_lora_rank
                 else Attention.init(cfg, hidden, layer=layer, dtype=dtype, **kw)),
                torch.ones((hidden,), dtype=dtype, device=device),
                ffn(layer),
                rms_eps=cfg.rms_eps, post_norm=cfg.block == "exaone4",
            )
            for layer in range(cfg.num_layers)
        ]
        embed = (torch.randn((cfg.vocab_size, hidden), generator=generator, device=device,
                             dtype=torch.float32) * 0.02).to(dtype)
        return cls(embed, blocks, torch.ones((hidden,), dtype=dtype, device=device),
                   QuantizedLinear.init(hidden, cfg.vocab_size, **kw), rms_eps=cfg.rms_eps)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def nbytes(self) -> int:
        """Bytes of every tensor the model holds, counted at each place that
        holds it, as the JAX package counts its model's leaves."""
        return sum(t.numel() * t.element_size()
                   for _, t in self.named_buffers(remove_duplicate=False))

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int,
                   max_tokens: Optional[int] = None) -> Tuple[KVCache, ...]:
        """One contiguous cache per layer, of ``max_seq`` positions; a window
        layer's is a ring of its window plus ``max_tokens``, the most
        positions one forward appends (None: ``max_seq``); a latent layer's
        (:class:`MLAttention`) a :class:`LatentKVCache`."""
        return tuple(
            LatentKVCache.init(batch, max_seq, blk.attn.kv_lora_rank, blk.attn.qk_rope_dim,
                               device=self.device)
            if isinstance(blk.attn, MLAttention) else
            QuantizedKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim,
                                  device=self.device, window=blk.attn.window,
                                  max_tokens=max_tokens)
            for blk in self.blocks
        )

    def init_paged_cache(self, cfg: ModelConfig, batch: int, *, num_pages: int, page_size: int,
                         max_pages_per_slot: int) -> Tuple[PagedKVCache, ...]:
        """Paged KV caches, one page pool per layer (``layers.paged_kv``).
        Page ids are pool-local, so the serving engine runs one allocator
        and applies the same assignment to every layer. A window layer's
        pages hold every position and its window is a mask. A model with
        latent layers raises: the pool holds no latent cache yet."""
        if any(isinstance(blk.attn, MLAttention) for blk in self.blocks):
            raise ValueError("the paged cache does not hold multi-head latent attention's "
                             "latent cache yet: serve an MLA model on contiguous caches")
        return tuple(
            PagedKVCache.init(batch, cfg.num_kv_heads, cfg.head_dim, num_pages=num_pages,
                              page_size=page_size, max_pages_per_slot=max_pages_per_slot,
                              device=self.device, window=blk.attn.window)
            for blk in self.blocks
        )

    def forward(self, tokens: torch.Tensor, caches, positions: torch.Tensor):
        """tokens [B, T] int; positions [T] or [B, T]. Returns (logits [B, T, V],
        caches)."""
        with entry():
            if positions.dim() == 1:
                positions = positions[None, :].expand(tokens.shape)
            with span("embed"):
                x = F.embedding(tokens, self.embed)
            new_caches = []
            for blk, cache in zip(self.blocks, caches):
                x, cache = blk(x, cache, positions)
                new_caches.append(cache)
            with span("norm"):
                x = rms_norm(x, self.final_norm, self.rms_eps)
            return self.lm_head(x), tuple(new_caches)


def _converted_copy(model: QuantizedTransformer) -> QuantizedTransformer:
    """A copy of the module tree that shares every weight tensor with
    ``model``: the converters switch modes on it and leave ``model`` as it
    was."""
    memo = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    return copy.deepcopy(model, memo)


def _moe_blocks(model: QuantizedTransformer):
    return [blk.moe for blk in model.blocks if isinstance(blk.moe, MoEBlock)]


def _mlps(model: QuantizedTransformer):
    """The dense SwiGLUs: leading dense layers' and shared experts'."""
    for blk in model.blocks:
        mlp = blk.moe.shared if isinstance(blk.moe, MoEBlock) else blk.moe
        if mlp is not None:
            yield mlp


def _linears(model: QuantizedTransformer):
    for blk in model.blocks:
        yield from (getattr(blk.attn, name) for name in blk.attn.LINEARS)
        if isinstance(blk.moe, MoEBlock):
            yield blk.moe.router
    for mlp in _mlps(model):
        yield from (mlp.w_gate, mlp.w_up, mlp.w_down)
    yield model.lm_head


def _experts(model: QuantizedTransformer):
    for moe in _moe_blocks(model):
        yield from (moe.w_gate, moe.w_up, moe.w_down)


def as_u4_turbo(model: QuantizedTransformer) -> QuantizedTransformer:
    """The model in packed-residency, regime-dispatched w4a8 mode.

    Returns a converted copy that shares the packed weights with ``model``
    (which is left as it was); no weight copy is made. Linears run the w4a8
    kernel below 256 rows and the transient i8 unpack + integer GEMM from
    there on; experts run the w4a8 grouped kernel (K10) at ``tile_m = 32``
    up to the prefill threshold, and the capacity layout on transient i8
    weights above it.
    """
    model = _converted_copy(model)
    for lin in _linears(model):
        if isinstance(lin, QuantizedLinear):
            lin.as_u4_turbo()
    for ex in _experts(model):
        ex.activation = "int8"
    for moe in _moe_blocks(model):
        moe.tile_m = 32
        moe.moe_impl = "u4_turbo"
    return model


def as_turbo(model: QuantizedTransformer) -> QuantizedTransformer:
    """The model in w4a8 mode: every linear on the w4a8 kernel (K5, or K4 at
    deep K) and every expert on the w4a8 grouped kernel (K10) at
    ``tile_m = 32`` (``prefill_tile_m`` above the prefill threshold).
    Returns a converted copy that shares the weights with ``model``."""
    model = _converted_copy(model)
    for lin in _linears(model):
        if isinstance(lin, QuantizedLinear):
            lin.activation = "int8"
    for ex in _experts(model):
        ex.activation = "int8"
    for moe in _moe_blocks(model):
        moe.tile_m = 32
    return model


def as_xla_turbo(model: QuantizedTransformer) -> QuantizedTransformer:
    """The model in i8-resident mode: every linear gains an i8 copy of its
    weights (2x the packed bytes) and runs ``int8_linear``; every MoE block
    keeps the dropless w4a16 grouped kernel up to the prefill threshold and
    runs the capacity layout on resident i8 expert copies above it.
    Returns a converted copy that shares the packed weights with ``model``;
    an i8 copy the model already holds (``model_from_jax``) is kept."""
    model = _converted_copy(model)
    for lin in _linears(model):
        lin.as_xla_turbo()
    for ex in _experts(model):
        if ex.w8_q8 is None:
            w8 = to_int8_resident(ex.weight)
            ex.w8_q8, ex.w8_scales = w8.q8, w8.scales
    for moe in _moe_blocks(model):
        moe.moe_impl = "xla_turbo"
    return model


def _requantized(qt, group_size: int):
    """``qt`` requantized per group through its dequantized values, or None
    where JAX's ``as_per_group`` leaves it (already per_group, or groups
    that would straddle the planar halves)."""
    if qt.granularity == "per_group" or (qt.in_dim // 2) % group_size:
        return None
    return quantize(dequantize(qt, dtype=torch.float32), granularity="per_group",
                    group_size=group_size,
                    layout="planar_groups" if group_size % 128 == 0 else "planar")


def as_per_group(model: QuantizedTransformer, group_size: int = 128) -> QuantizedTransformer:
    """The model with every INT4 weight requantized per group of
    ``group_size`` columns, the JAX package's production granularity.

    Returns a converted copy (``model`` is left as it was). Requantization
    goes through the dequantized values, as in JAX; the routers stay per_row;
    tensors already per_group, and those whose K/2 the group size does not
    divide, are kept. With ``group_size % 128 == 0`` the weights pack
    planar_groups and run K7/K13, or K8/K14 under :func:`as_turbo` (the
    serving benchmark's ``pg_turbo`` mode is ``as_turbo(as_per_group(m))``).
    """
    model = _converted_copy(model)

    def linear(lin):
        qt = _requantized(lin.weight, group_size) if isinstance(lin, QuantizedLinear) else None
        return lin if qt is None else QuantizedLinear(
            qt, lin.bias, out_features=lin.out_features, activation=lin.activation, w8=lin.w8)

    def experts(ex):
        qt = _requantized(ex.weight, group_size)
        return ex if qt is None else MoEINT4(qt, activation=ex.activation, w8=ex.w8)

    for blk in model.blocks:
        for name in blk.attn.LINEARS:
            setattr(blk.attn, name, linear(getattr(blk.attn, name)))
    for moe in _moe_blocks(model):
        for name in ("w_gate", "w_up", "w_down"):
            setattr(moe, name, experts(getattr(moe, name)))
    for mlp in _mlps(model):
        for name in ("w_gate", "w_up", "w_down"):
            setattr(mlp, name, linear(getattr(mlp, name)))
    model.lm_head = linear(model.lm_head)
    return model
