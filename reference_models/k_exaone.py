"""Plain reference of the K-EXAONE-236B-A23B decoder: the full forward pass
over a batch of token sequences, in float32 with TF32 off, with no cache,
no kernels and nothing of either package.

The published config (huggingface.co/LGAI-EXAONE/K-EXAONE-236B-A23B,
``exaone_moe``) fixes the widths, the "LLLG" pattern of sliding-window (128
positions) and full attention layers, the dense first layer, and the MoE
layers' sigmoid router (top-k of the scores, weights renormalized over the
k and scaled by ``routed_scale``) with one shared expert. The block follows
the EXAONE 4.0 family's (Hugging Face ``Exaone4Attention`` and
``Exaone4DecoderLayer``), which the catalog does not confirm for
``exaone_moe``:

    q, k = RMSNorm_hd(x Wq), RMSNorm_hd(x Wk)      (over head_dim)
    q, k = RoPE(q), RoPE(k)                        (window layers only; NoPE on full layers)
    a    = softmax(q k^T / sqrt(d) + mask) v Wo    (window: q - W < p <= q)
    h    = x + RMSNorm(a)
    y    = h + RMSNorm(FFN(h))

with FFN a SwiGLU ``down(silu(gate(x)) * up(x))`` on the dense layers, and
on the MoE layers the routed experts' weighted sum plus the shared expert.
The router's selection adds a per-expert correction bias to the sigmoid
scores (DeepSeek-V3's ``noaux_tc``; ``n_group`` = ``topk_group`` = 1), and
the weights use the unbiased scores. A final RMSNorm and the lm_head give
the logits.

Departures, each what the served model does:

* The weights are the INT4 grid's values, per output row or per group of
  ``group_size`` input columns: ``q = clamp(round(w / s + z), 0, 15)``,
  ``s = (max - min) / 15``, ``z = clamp(round(-min / s), 0, 15)``, the
  weight ``(q - z) * s``. The router and the embedding are read as the
  bf16 values they are served in.
* Each key and value vector of a (head, position), rounded to the
  activations' type (``Geometry.activations``: bf16 as served, or float32),
  passes the same affine INT4 rule over head_dim, as the INT4 KV cache
  holds it.
* The layer holds a share of the routed experts, [first_expert,
  first_expert + held_experts): the router routes over all of them, and the
  absent experts' part is left out, as on one card of an expert-parallel
  deployment.
* ``routes`` (optional, [layers, B, T, k]): the experts another forward
  chose; the reference then follows them, weighted by its own scores, and
  records by how much each choice's biased score lies below its own k-th
  best (``route_gaps``). With random weights near-tied selections flip on
  rounding, and a flipped token's state departs by whole units.
* The multi-token prediction layer is not held.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_MAXQ = 15.0


@dataclasses.dataclass(frozen=True)
class Geometry:
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    windows: Sequence[int]          # each layer's window; 0: full attention
    dense_layers: int
    dense_ffn: int
    moe_ffn: int
    shared_ffn: int
    num_experts: int                # the router's width
    first_expert: int
    held_experts: int
    top_k: int
    routed_scale: float
    rope_theta: float
    rms_eps: float
    granularity: str = "per_row"
    group_size: int = 128
    activations: torch.dtype = torch.bfloat16   # what the KV cache is handed

    @property
    def layers(self) -> int:
        return len(self.windows)


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32, not TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def affine_int4(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] quantized to INT4 over its last dim and dequantized, f32."""
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    maxq = torch.full_like(hi, _MAXQ)
    scale = (hi - lo) / maxq
    scale = torch.where(hi == lo, hi.abs().clamp(min=1.0) / maxq, scale).clamp(min=1e-8)
    zp = torch.round(-lo / scale).clamp(0.0, _MAXQ)
    q = torch.round(x / scale + zp).clamp(0.0, _MAXQ)
    return (q - zp) * scale


def int4_weight(w: torch.Tensor, granularity: str, group_size: int) -> torch.Tensor:
    """The INT4 grid value of a dense weight [..., N, K], float32."""
    w = w.float()
    if granularity == "per_row":
        return affine_int4(w)
    if granularity == "per_group":
        k = w.shape[-1]
        return affine_int4(w.reshape(*w.shape[:-1], k // group_size, group_size)).reshape(w.shape)
    raise ValueError(f"granularity {granularity!r}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, T, D], positions [T]: rotate_half RoPE."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = positions.double()[:, None] * inv[None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg.t()) * (x @ wu.t())) @ wd.t()


def _attention(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
               window: int) -> torch.Tensor:
    b, t, _ = x.shape
    pos = torch.arange(t, device=x.device)
    q = (x @ w["wq"].t()).reshape(b, t, g.heads, g.head_dim).transpose(1, 2)
    k = (x @ w["wk"].t()).reshape(b, t, g.kv_heads, g.head_dim).transpose(1, 2)
    v = (x @ w["wv"].t()).reshape(b, t, g.kv_heads, g.head_dim).transpose(1, 2)
    q, k = rms_norm(q, w["q_norm"], g.rms_eps), rms_norm(k, w["k_norm"], g.rms_eps)
    if window:
        q, k = rope(q, pos, g.rope_theta), rope(k, pos, g.rope_theta)
    k = affine_int4(k.to(g.activations).float())
    v = affine_int4(v.to(g.activations).float())
    rep = g.heads // g.kv_heads
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    mask = pos[None, :] <= pos[:, None]                                 # [T, S]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(g.head_dim)
    out = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1) @ v
    return out.transpose(1, 2).reshape(b, t, g.heads * g.head_dim) @ w["wo"].t()


def route(g: Geometry, logits: torch.Tensor, bias: torch.Tensor,
          chosen: Optional[torch.Tensor] = None):
    """(the k experts of each row, their weights, each row's route gap):
    the top-k of sigmoid + bias, or ``chosen`` where given; the weights the
    unbiased scores renormalized and scaled; the gap the margin of the
    lowest chosen biased score below the k-th best (0 for its own top-k)."""
    scores = torch.sigmoid(logits)
    biased = scores + bias.float()
    top = torch.topk(biased, g.top_k, dim=-1)
    idx = top.indices if chosen is None else chosen.long()
    gap = (top.values[:, -1] - biased.gather(1, idx).min(dim=-1).values).clamp(min=0)
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(dim=-1, keepdim=True) * g.routed_scale, gap


def _moe(g: Geometry, w: Dict[str, torch.Tensor], x: torch.Tensor,
         chosen: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1, g.hidden)
    idx, wts, gap = route(g, flat @ w["router"].t(), w["router_bias"],
                          None if chosen is None else chosen.reshape(-1, g.top_k))
    out = swiglu(flat, w["shared_gate"], w["shared_up"], w["shared_down"])
    for e in range(g.held_experts):
        rows, slot = (idx == g.first_expert + e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(flat[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
            out = out.index_add(0, rows, y * wts[rows, slot][:, None])
    return out.reshape(x.shape), gap


# Weights applied as they are given: the bf16 router and embedding, the
# router bias and the norms.
_PLAIN = ("embed", "router", "router_bias", "q_norm", "k_norm", "attn_norm", "ffn_norm",
          "final_norm")


def quantized(g: Geometry, weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the reference applies them: the INT4 grid's values of
    every projection and expert, the rest (``_PLAIN``) in float32."""
    return {n: t.float() if n.rsplit(".", 1)[-1] in _PLAIN
            else int4_weight(t, g.granularity, g.group_size) for n, t in weights.items()}


@torch.no_grad()
def forward(g: Geometry, weights: Dict[str, torch.Tensor], tokens: torch.Tensor,
            routes: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Logits [B, T, V] of ``tokens`` [B, T] at positions 0..T-1, and each
    MoE layer's route gaps [B * T] in order.

    ``weights`` (dense, before quantization): ``embed`` [V, H],
    ``final_norm`` [H], ``lm_head`` [V, H], and per layer ``l`` under
    ``"{l}.<name>"``: ``wq``, ``wk``, ``wv``, ``wo``, ``q_norm``, ``k_norm``
    [D], ``attn_norm``, ``ffn_norm`` [H] (the post-sublayer norms); a dense
    layer ``dense_gate``, ``dense_up``, ``dense_down``; a MoE layer
    ``router`` [E, H], ``router_bias`` [E], ``w_gate``, ``w_up`` [E_held,
    F, H], ``w_down`` [E_held, H, F], ``shared_gate``, ``shared_up``,
    ``shared_down``. ``routes`` [layers, B, T, k]: see the module docstring
    (entries of the dense layers are not read)."""
    w = quantized(g, weights)
    gaps = []
    with no_tf32():
        x = w["embed"][tokens.long()]
        for layer in range(g.layers):
            lw = {n.split(".", 1)[1]: t for n, t in w.items() if n.startswith(f"{layer}.")}
            a = _attention(g, lw, x, g.windows[layer])
            h = x + rms_norm(a, lw["attn_norm"], g.rms_eps)
            if layer < g.dense_layers:
                f = swiglu(h, lw["dense_gate"], lw["dense_up"], lw["dense_down"])
            else:
                f, gap = _moe(g, lw, h, None if routes is None else routes[layer])
                gaps.append(gap)
            x = h + rms_norm(f, lw["ffn_norm"], g.rms_eps)
        return rms_norm(x, w["final_norm"], g.rms_eps) @ w["lm_head"].t(), gaps
