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

Each layer's work runs inside a layer span (``utils.profiling.span``:
``embed``, ``norm``, ``residual``, ``attention.rope``,
``attention.kv_append``, ``attention.kernel``, ``moe.route``,
``moe.swiglu``, ``moe.combine``; ``linear`` and ``experts`` in the layers),
and :meth:`QuantizedTransformer.forward` is a top-level entry of them.
"""
from __future__ import annotations

import copy
import itertools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..layers.kv_cache import QuantizedKVCache
from ..layers.linear import DenseLinear, QuantizedLinear
from ..layers.paged_kv import PagedKVCache
from ..layers.moe import (
    MoEINT4,
    combine,
    dispatch,
    make_capacity_plan,
    make_dispatch_plan,
    topk_route,
)
from ..ops.decode_attention import int4_decode_attention, int4_prefill_attention
from ..ops.int8_xla import int4_grouped_transient, int8_grouped_capacity, to_int8_resident
from ..quant.core import dequantize, quantize
from ..utils.profiling import entry, span
from .config import ModelConfig

KVCache = Union[QuantizedKVCache, PagedKVCache]

__all__ = [
    "QuantizedTransformer", "TransformerBlock", "MoEBlock", "Attention",
    "rms_norm", "rotary_embedding", "as_turbo", "as_u4_turbo", "as_xla_turbo",
    "as_per_group",
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
        kw = dict(generator=generator, device=resolve_device(device))
        return cls(
            QuantizedLinear.init(hidden, nh * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(hidden, nkv * hd, **kw),
            QuantizedLinear.init(nh * hd, hidden, **kw),
            num_heads=nh, num_kv_heads=nkv, head_dim=hd, rope_theta=cfg.rope_theta,
        )

    def forward(self, x: torch.Tensor, cache: KVCache,
                positions: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """x [B, T, H]; positions [B, T] (per-slot offsets). ``cache`` is
        contiguous or paged; the fused path dispatches on its type (K3 or
        K3'), the golden path reads its logical dequantized view."""
        b, t, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        with span("attention.rope"):
            q = q.reshape(b, t, nh, hd).transpose(1, 2)
            k = k.reshape(b, t, nkv, hd).transpose(1, 2)
            v = v.reshape(b, t, nkv, hd).transpose(1, 2)
            q = rotary_embedding(q, positions, self.rope_theta)
            k = rotary_embedding(k, positions, self.rope_theta)

        # Cache index == sequence position: row b writes at positions[b, 0].
        with span("attention.kv_append"):
            cache = cache.append(k, v, start=positions[:, 0])

        if self.use_fused_attention:
            with span("attention.kernel"):
                if t == 1:
                    out = int4_decode_attention(q[:, :, 0, :], cache)      # [B, nh, D]
                else:
                    out = int4_prefill_attention(q, cache, positions[:, 0]).transpose(1, 2)
                out = out.reshape(b, t, nh * hd)
            return self.wo(out), cache

        # Golden path: dequantize the whole (logical) cache, dense masked attention.
        kd, vd = cache.dequantize(dtype=q.dtype)                  # [B, nkv, S, D]
        rep = nh // nkv
        kd = kd.repeat_interleave(rep, dim=1)
        vd = vd.repeat_interleave(rep, dim=1)
        scores = torch.einsum("bhtd,bhsd->bhts", q, kd) / math.sqrt(hd)
        cols = torch.arange(cache.max_seq, device=x.device)
        causal = cols[None, None, :] <= positions[:, :, None]    # [B, T, S]
        scores = torch.where(causal[:, None], scores.float(), torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhts,bhsd->bhtd", probs, vd)
        return self.wo(out.transpose(1, 2).reshape(b, t, nh * hd)), cache


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
    """

    def __init__(self, router: Union[QuantizedLinear, DenseLinear], w_gate: MoEINT4,
                 w_up: MoEINT4, w_down: MoEINT4, *, num_experts: int, top_k: int,
                 tile_m: int = 16, prefill_threshold: int = 512, prefill_impl: str = "grouped",
                 prefill_tile_m: int = 128, capacity_factor: float = 2.0,
                 moe_impl: str = "kernel"):
        super().__init__()
        if prefill_impl not in ("grouped", "einsum"):
            raise ValueError(f"prefill_impl={prefill_impl!r} is not 'grouped' or 'einsum'")
        if moe_impl not in ("kernel", "u4_turbo", "xla_turbo"):
            raise ValueError(f"moe_impl={moe_impl!r} is not 'kernel', 'u4_turbo' or 'xla_turbo'")
        self.router, self.w_gate, self.w_up, self.w_down = router, w_gate, w_up, w_down
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
             *, generator=None, device=None) -> "MoEBlock":
        device = resolve_device(device)

        def experts(n, k):
            w = torch.randn((num_experts, n, k), generator=generator, device=device,
                            dtype=torch.float32) * (k ** -0.5)
            return MoEINT4.from_dense(w)

        router = QuantizedLinear.init(hidden, num_experts, generator=generator, device=device)
        return cls(router, experts(ffn, hidden), experts(ffn, hidden), experts(hidden, ffn),
                   num_experts=num_experts, top_k=top_k, tile_m=tile_m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H]
        b, t, h = x.shape
        with span("moe.route"):
            xf = x.reshape(b * t, h)
            routing = topk_route(self.router(xf), self.top_k, self.num_experts)
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
        over the routing's experts."""
        with span("moe.route"):
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
        return cap, plan

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

    @property
    def nbytes(self) -> int:
        """Bytes of every tensor the model holds, counted at each place that
        holds it, as the JAX package counts its model's leaves."""
        return sum(t.numel() * t.element_size()
                   for _, t in self.named_buffers(remove_duplicate=False))

    def init_cache(self, cfg: ModelConfig, batch: int, max_seq: int) -> Tuple[QuantizedKVCache, ...]:
        return tuple(
            QuantizedKVCache.init(batch, cfg.num_kv_heads, max_seq, cfg.head_dim, device=self.device)
            for _ in self.blocks
        )

    def init_paged_cache(self, cfg: ModelConfig, batch: int, *, num_pages: int, page_size: int,
                         max_pages_per_slot: int) -> Tuple[PagedKVCache, ...]:
        """Paged KV caches, one page pool per layer (``layers.paged_kv``).
        Page ids are pool-local, so the serving engine runs one allocator
        and applies the same assignment to every layer."""
        return tuple(
            PagedKVCache.init(batch, cfg.num_kv_heads, cfg.head_dim, num_pages=num_pages,
                              page_size=page_size, max_pages_per_slot=max_pages_per_slot,
                              device=self.device)
            for _ in self.blocks
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


def _linears(model: QuantizedTransformer):
    for blk in model.blocks:
        yield from (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo, blk.moe.router)
    yield model.lm_head


def _experts(model: QuantizedTransformer):
    for blk in model.blocks:
        yield from (blk.moe.w_gate, blk.moe.w_up, blk.moe.w_down)


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
    for blk in model.blocks:
        blk.moe.tile_m = 32
        blk.moe.moe_impl = "u4_turbo"
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
    for blk in model.blocks:
        blk.moe.tile_m = 32
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
    for blk in model.blocks:
        blk.moe.moe_impl = "xla_turbo"
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
        for name in ("wq", "wk", "wv", "wo"):
            setattr(blk.attn, name, linear(getattr(blk.attn, name)))
        for name in ("w_gate", "w_up", "w_down"):
            setattr(blk.moe, name, experts(getattr(blk.moe, name)))
    model.lm_head = linear(model.lm_head)
    return model
