"""Plain reference of the DeepSeek-V3 decoder: the full forward pass over a
batch of token sequences, in float32 with TF32 off, with no cache, no
kernels and nothing of either package.

The published config (huggingface.co/deepseek-ai/DeepSeek-V3, config.json,
``deepseek_v3``) and DeepSeek's ``inference/model.py`` fix the block:

    c_q          = RMSNorm(x W_DQ)                              (q_lora_rank)
    [q_nope, q_pe] = c_q W_UQ                                   (per head)
    [c_KV, k_pe] = x W_DKV;  c_KV = RMSNorm(c_KV)               (kv_lora_rank; one k_pe)
    q_pe, k_pe   = RoPE(q_pe), RoPE(k_pe)                       (YaRN, channel pairs)
    [k_nope, v]  = c_KV W_UKV                                   (per head)
    a = softmax((q_nope k_nope^T + q_pe k_pe^T) * scale + mask) v W_O
    h = x + a(RMSNorm(x));  y = h + FFN(RMSNorm(h))

``scale = (qk_nope + qk_rope)^-0.5 * mscale^2`` with YaRN's ``mscale =
0.1 mscale_all_dim ln(factor) + 1``; RoPE's frequencies are YaRN's
(``precompute_freqs_cis``), its cos and sin times ``mscale(factor,
mscale) / mscale(factor, mscale_all_dim)``. The FFN is a SwiGLU on the
leading dense layers, and on the MoE layers the routed experts' weighted
sum plus the shared expert. The router (``noaux_tc``): sigmoid scores plus
a per-expert selection bias; the experts fall into ``n_group`` groups in
id order, a group scores the sum of its two best biased scores, and the
top-k are chosen inside the ``topk_group`` best groups; the weights are the
unbiased scores renormalized over the k and scaled by ``routed_scale``. A
final RMSNorm and the lm_head give the logits. ``absorbed=True`` computes
the same attention in the absorbed form DeepSeek's code runs by default
(q_nope taken into latent space by W_UK, the output back by W_UV).

Departures, each what the served model does:

* The weights are the INT4 grid's values, per output row or per group of
  ``group_size`` input columns: ``q = clamp(round(w / s + z), 0, 15)``,
  ``s = (max - min) / 15``, ``z = clamp(round(-min / s), 0, 15)``, the weight
  ``(q - z) * s``. ``W_UKV``'s two halves are quantized as the absorbed
  form applies them: ``W_UK^T`` [H, kv_lora, qk_nope] over qk_nope (one
  group a row), ``W_UV`` [H, v, kv_lora] per group along kv_lora. The
  router and the embedding are read as the bf16 values they are served in.
* Each position's c_KV, rounded to the activations' type
  (``Geometry.activations``: bf16 as served, or float32), passes the same
  affine INT4 rule over kv_lora, as the latent cache holds it; its k_pe is
  rounded to bf16, as the cache holds it.
* The layer holds a share of the routed experts, [first_expert,
  first_expert + held_experts): the router routes over all of them, and the
  absent experts' part is left out, as on one card of an expert-parallel
  deployment.
* ``routes`` (optional, [layers, B, T, k]): the experts another forward
  chose; the reference then follows them, weighted by its own scores, and
  records by how much each choice's biased score lies below its own k-th
  best (``route_gaps``) and by how much each choice's group scores below
  its own ``topk_group``-th best group (``group_gaps``, 0 inside).
* RoPE rotates channel pairs (2i, 2i + 1), as the published code does.
* The multi-token prediction layer is not held.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from .k_exaone import affine_int4, int4_weight, no_tf32, rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class Geometry:
    hidden: int
    heads: int
    q_lora: int
    kv_lora: int
    qk_nope: int
    qk_rope: int
    v_dim: int
    vocab: int
    layers: int
    dense_layers: int
    dense_ffn: int
    moe_ffn: int
    shared_ffn: int
    num_experts: int                # the router's width
    first_expert: int
    held_experts: int
    top_k: int
    n_group: int
    topk_group: int
    routed_scale: float
    rope_theta: float
    rms_eps: float
    yarn_factor: float = 1.0
    yarn_original: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 1.0
    granularity: str = "per_row"
    group_size: int = 128
    uv_granularity: str = "per_group"     # W_UV's, along kv_lora
    activations: torch.dtype = torch.bfloat16

    def mscale(self, m: float) -> float:
        f = self.yarn_factor
        return 0.1 * m * math.log(f) + 1.0 if f > 1 else 1.0

    @property
    def softmax_scale(self) -> float:
        return (self.qk_nope + self.qk_rope) ** -0.5 * self.mscale(self.yarn_mscale_all_dim) ** 2


def inv_freq(g: Geometry, device=None) -> torch.Tensor:
    """YaRN's rotary frequencies [qk_rope / 2] (f32)."""
    dim, base = g.qk_rope, g.rope_theta
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    if g.yarn_factor <= 1:
        return freqs

    def correction_dim(rot):
        return dim * math.log(g.yarn_original / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(g.yarn_beta_fast)), 0)
    high = min(math.ceil(correction_dim(g.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return freqs / g.yarn_factor * ramp + freqs * (1 - ramp)


def rope(g: Geometry, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, T, ..., R] at positions [B, T] or [T]: channel pairs rotated."""
    pos = positions if positions.dim() == 2 else positions[None].expand(x.shape[0], -1)
    ang = pos.float()[..., None] * inv_freq(g, x.device)
    ang = ang.reshape(*ang.shape[:2], *([1] * (x.dim() - 3)), ang.shape[-1])
    factor = g.mscale(g.yarn_mscale) / g.mscale(g.yarn_mscale_all_dim)
    cos, sin = ang.cos() * factor, ang.sin() * factor
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def kv_b_weight(g: Geometry, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W_UK [H, qk_nope, kv_lora], W_UV [H, v, kv_lora]) of a dense W_UKV
    [H (qk_nope + v), kv_lora] on the INT4 grid, in the absorbed layout."""
    w = w.float().reshape(g.heads, g.qk_nope + g.v_dim, g.kv_lora)
    uk = int4_weight(w[:, :g.qk_nope].transpose(1, 2), "per_row", 0).transpose(1, 2)
    uv = int4_weight(w[:, g.qk_nope:], g.uv_granularity, g.group_size)
    return uk, uv


def latent_cache(g: Geometry, c_kv: torch.Tensor, k_pe: torch.Tensor):
    """c_KV and k_pe as the latent cache holds them: c_KV rounded to the
    activations' type and through the INT4 rule, k_pe rounded to bf16."""
    return (affine_int4(c_kv.to(g.activations).float()),
            k_pe.to(torch.bfloat16).float())


def attend(g: Geometry, q_nope, q_pe, c, k_pe, uk, uv, mask, absorbed: bool):
    """Attention of q_nope [B, T, H, dn] and q_pe [B, T, H, dr] over the
    latent keys c [B, S, L] and k_pe [B, S, dr], ``mask`` [B or 1, T, S]
    (True: seen); [B, T, H * v]."""
    b, t = q_nope.shape[:2]
    pe = torch.einsum("bthr,bsr->bhts", q_pe, k_pe)
    if absorbed:
        q_lat = torch.einsum("bthn,hnl->bthl", q_nope, uk)
        scores = torch.einsum("bthl,bsl->bhts", q_lat, c) + pe
    else:
        k_nope = torch.einsum("bsl,hnl->bhsn", c, uk)
        scores = torch.einsum("bthn,bhsn->bhts", q_nope, k_nope) + pe
    scores = (scores * g.softmax_scale).masked_fill(~mask[:, None], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    if absorbed:
        out = torch.einsum("hvl,bhtl->bthv", uv, torch.einsum("bhts,bsl->bhtl", p, c))
    else:
        out = torch.einsum("bhts,bhsv->bthv", p, torch.einsum("bsl,hvl->bhsv", c, uv))
    return out.reshape(b, t, g.heads * g.v_dim)


def _attention(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
               absorbed: bool) -> torch.Tensor:
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    cq = rms_norm(x @ w["wq_a"].t(), w["q_norm"], g.rms_eps)
    q = (cq @ w["wq_b"].t()).reshape(b, t, g.heads, g.qk_nope + g.qk_rope)
    kv = x @ w["wkv_a"].t()
    c = rms_norm(kv[..., :g.kv_lora], w["kv_norm"], g.rms_eps)
    q_pe, k_pe = rope(g, q[..., g.qk_nope:], pos), rope(g, kv[..., g.kv_lora:], pos)
    c, k_pe = latent_cache(g, c, k_pe)
    uk, uv = (w["w_uk"], w["w_uv"]) if "w_uk" in w else kv_b_weight(g, w["kv_b"])
    mask = (pos[None, :] <= pos[:, None])[None]                          # [1, T, S]
    out = attend(g, q[..., :g.qk_nope], q_pe, c, k_pe, uk, uv, mask, absorbed)
    return out @ w["wo"].t()


def route(g: Geometry, logits: torch.Tensor, bias: torch.Tensor,
          chosen: Optional[torch.Tensor] = None):
    """(the k experts of each row, their weights, each row's route gap, each
    chosen pair's group gap [rows, k]): the top-k of sigmoid + bias inside
    the best groups, or ``chosen`` where given; the weights the unbiased
    scores renormalized and scaled; the route gap the margin of the lowest
    chosen biased score below the k-th best of the groups kept (0 for its
    own top-k); the group gap the ``topk_group``-th best group score less
    the score of the chosen expert's group (0 inside)."""
    scores = torch.sigmoid(logits)
    biased = scores + bias.float()
    groups = biased.reshape(-1, g.n_group, g.num_experts // g.n_group)
    group_score = torch.topk(groups, min(2, groups.shape[-1]), dim=-1).values.sum(dim=-1)
    best = torch.topk(group_score, g.topk_group, dim=-1)
    kept = torch.zeros_like(group_score, dtype=torch.bool).scatter_(1, best.indices, True)
    masked = groups.masked_fill(~kept[..., None], float("-inf")).reshape(biased.shape)
    top = torch.topk(masked, g.top_k, dim=-1)
    idx = top.indices if chosen is None else chosen.long()
    gap = (top.values[:, -1] - biased.gather(1, idx).min(dim=-1).values).clamp(min=0)
    group_of = idx // (g.num_experts // g.n_group)
    group_gap = (best.values[:, -1:] - group_score.gather(1, group_of)).clamp(min=0)
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(dim=-1, keepdim=True) * g.routed_scale, gap, group_gap


def _moe(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
         chosen: Optional[torch.Tensor]):
    flat = x.reshape(-1, g.hidden)
    idx, wts, gap, group_gap = route(g, flat @ w["router"].t(), w["router_bias"],
                                     None if chosen is None else chosen.reshape(-1, g.top_k))
    out = swiglu(flat, w["shared_gate"], w["shared_up"], w["shared_down"])
    for e in range(g.held_experts):
        rows, slot = (idx == g.first_expert + e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(flat[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
            out = out.index_add(0, rows, y * wts[rows, slot][:, None])
    return out.reshape(x.shape), gap, group_gap


# Weights applied as they are given: the bf16 router and embedding, the
# router bias and the norms, W_UK and W_UV (grid values already); W_UKV is
# quantized by kv_b_weight.
_PLAIN = ("embed", "router", "router_bias", "q_norm", "kv_norm", "attn_norm", "ffn_norm",
          "final_norm", "kv_b", "w_uk", "w_uv")


def quantized(g: Geometry, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the reference applies them: the INT4 grid's values of
    every projection and expert, the rest (``_PLAIN``) in float32."""
    return {n: t.float() if n.rsplit(".", 1)[-1] in _PLAIN
            else int4_weight(t, g.granularity, g.group_size) for n, t in weights.items()}


@torch.no_grad()
def forward(g: Geometry, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
            routes: Optional[torch.Tensor] = None, absorbed: bool = False
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Logits [B, T, V] of ``tokens`` [B, T] at positions 0..T-1, each MoE
    layer's route gaps [B * T] and group gaps [B * T, k], in order.

    ``weights`` (dense, before quantization): ``embed`` [V, H],
    ``final_norm`` [H], ``lm_head`` [V, H], and per layer ``l`` under
    ``"{l}.<name>"``: ``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``,
    ``kv_b`` [H (qk_nope + v), kv_lora] (or its two halves on the INT4 grid
    already, ``w_uk`` [H, qk_nope, kv_lora] and ``w_uv`` [H, v, kv_lora]),
    ``wo``, ``attn_norm``, ``ffn_norm``;
    a dense layer ``dense_gate``, ``dense_up``, ``dense_down``; a MoE layer
    ``router`` [E, H], ``router_bias`` [E], ``w_gate``, ``w_up`` [E_held, F,
    H], ``w_down`` [E_held, H, F], ``shared_gate``, ``shared_up``,
    ``shared_down``. ``routes`` [layers, B, T, k]: see the module docstring
    (entries of the dense layers are not read)."""
    w = quantized(g, weights)
    gaps, group_gaps = [], []
    with no_tf32():
        x = w["embed"][tokens.long()]
        for layer in range(g.layers):
            lw = {n.split(".", 1)[1]: t for n, t in w.items() if n.startswith(f"{layer}.")}
            h = x + _attention(g, lw, rms_norm(x, lw["attn_norm"], g.rms_eps), absorbed)
            f_in = rms_norm(h, lw["ffn_norm"], g.rms_eps)
            if layer < g.dense_layers:
                f = swiglu(f_in, lw["dense_gate"], lw["dense_up"], lw["dense_down"])
            else:
                f, gap, group_gap = _moe(g, lw, f_in, None if routes is None else routes[layer])
                gaps.append(gap)
                group_gaps.append(group_gap)
            x = h + f
        return rms_norm(x, w["final_norm"], g.rms_eps) @ w["lm_head"].t(), gaps, group_gaps
