"""Plain reference of the Mixtral decoder as the benchmark's configurations
serve it: float32, TF32 off, one layer at a time.

It follows the published Mixtral forward (Hugging Face
``MixtralForCausalLM``): RMSNorm, grouped-query attention with RoPE in the
half-split (``rotate_half``) convention, a softmax router whose top-k
weights are renormalized, SwiGLU experts, a final RMSNorm and the lm_head.
It imports nothing of the program. From the run's seed it draws the dense
weights again (``portbench.inputs``, the draws the program's weights were
quantized from) and works everything else out itself:

* its own INT4 quantizer of the weights, per output row or per group of
  ``group_size`` input columns, ``q = clamp(round(w / s + z), 0, 15)``
  with ``s = (max - min) / 15`` and ``z = clamp(round(-min / s), 0, 15)``,
  and the dequantized weight ``(q - z) * s`` in float32;
* its own INT4 arithmetic of the KV cache: each key and value vector of a
  (head, position), as the bf16 activation the cache is handed, quantized
  by the same affine rule over head_dim and dequantized before the dot
  products (the seeded cached positions of the decode mixes are handed in
  float32, and quantized from it);
* its own routing, RoPE, attention and expert arithmetic.

Departures from the published forward, each what the deployment serves:
the weights are the INT4 grid's values (not the bf16 checkpoint's); keys
and values pass through the INT4 cache format; the RMSNorm weights are 1
and the weights random (the configuration's ``assumed``); the embedding is
read in bf16, the type it is served in. The reference computes in float32
where the program computes in bf16: that gap, and nothing else, is what
the cell's limits allow.

With random weights a router's top-k is often near-tied, and a bf16 or an
f32 rounding flips it; the flipped token then takes another expert and its
state departs by whole units, so two correct forwards part on about half
of all tokens (PERF.md). A job therefore carries the program's own expert
choices (``Job.routes``): the reference follows them and checks them by
themselves, as the margin by which each lies below its own top-k.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import inputs
from ..inputs import ModelSpec

_MAXQ = 15.0


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
    if granularity == "per_row":
        return affine_int4(w)
    if granularity == "per_group":
        k = w.shape[-1]
        g = affine_int4(w.reshape(*w.shape[:-1], k // group_size, group_size))
        return g.reshape(w.shape)
    raise ValueError(f"granularity {granularity!r}")


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, T, D], positions [T]: rotate_half RoPE."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = positions.double()[:, None] * inv[None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Job:
    """One batch of sequences through the model: ``tokens`` [B, T] at
    positions ``start .. start + T - 1``, after ``start`` cached positions
    whose keys and values ``prefix(layer)`` gives (float32 [B, H_kv, start,
    D]; None when ``start`` is 0). ``logits`` [B, T, V] is filled in.

    ``routes`` [layers, B, T, k]: the experts the program chose for each
    token. Given them, the reference routes each token to those experts
    (weighted by its own renormalized probabilities) and records, for each
    token and layer, the margin by which the lowest chosen expert's router
    logit lies below the reference's own k-th best (0 where the choice is
    the reference's): the routing stage checked by itself, while the rest
    of the forward follows the program's choices. ``route_gaps`` holds them
    all, one tensor a layer."""

    def __init__(self, tokens: torch.Tensor, start: int = 0,
                 prefix: Optional[Callable[[int], tuple]] = None,
                 routes: Optional[torch.Tensor] = None):
        self.tokens, self.start, self.prefix, self.routes = tokens, start, prefix, routes
        self.logits: Optional[torch.Tensor] = None
        self.route_gaps: List[torch.Tensor] = []


class Mixtral:
    def __init__(self, spec: ModelSpec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)

    def _weight(self, layer: int, name: str) -> torch.Tensor:
        s = self.spec
        w = inputs.layer_weight(s, self.seed, layer, name, self.device)
        if name == "router":   # the router is INT4 per row in every configuration
            return int4_weight(w, "per_row", 0)
        return int4_weight(w, s.granularity, s.group_size)

    def _attention(self, layer: int, h: torch.Tensor, job: Job, wq, wk, wv, wo) -> torch.Tensor:
        s = self.spec
        b, t, _ = h.shape
        pos = torch.arange(job.start, job.start + t, device=h.device)
        q = (h @ wq.t()).reshape(b, t, s.heads, s.head_dim).transpose(1, 2)
        k = (h @ wk.t()).reshape(b, t, s.kv_heads, s.head_dim).transpose(1, 2)
        v = (h @ wv.t()).reshape(b, t, s.kv_heads, s.head_dim).transpose(1, 2)
        q, k = rope(q, pos, s.rope_theta), rope(k, pos, s.rope_theta)
        # the cache holds INT4 codes of the bf16 keys and values the model
        # serves (its activations' type)
        k, v = affine_int4(k.bfloat16().float()), affine_int4(v.bfloat16().float())
        if job.start:
            pk, pv = job.prefix(layer)
            k = torch.cat([affine_int4(pk), k], dim=2)
            v = torch.cat([affine_int4(pv), v], dim=2)
            del pk, pv
        rep = s.heads // s.kv_heads
        out = torch.empty_like(q)
        span = torch.arange(job.start + t, device=h.device)
        mask = span[None, :] <= pos[:, None]                         # [T, S]
        for g in range(s.kv_heads):                                  # a KV head at a time
            qg = q[:, g * rep:(g + 1) * rep]                         # [B, rep, T, D]
            sc = (qg @ k[:, g:g + 1].transpose(-1, -2)) / math.sqrt(s.head_dim)
            sc = sc.masked_fill(~mask, float("-inf"))
            out[:, g * rep:(g + 1) * rep] = torch.softmax(sc, dim=-1) @ v[:, g:g + 1]
        return out.transpose(1, 2).reshape(b, t, s.heads * s.head_dim) @ wo.t()

    def _moe(self, h: torch.Tensor, wr, experts: Sequence[torch.Tensor], job: Job,
             layer: int) -> torch.Tensor:
        s = self.spec
        x = h.reshape(-1, s.hidden)
        logits = x @ wr.t()
        probs = torch.softmax(logits, dim=-1)
        top_w, top_i = torch.topk(probs, s.top_k, dim=-1)
        if job.routes is not None:
            kth = torch.topk(logits, s.top_k, dim=-1).values[:, -1]
            top_i = job.routes[layer].reshape(-1, s.top_k).to(x.device).long()
            chosen = logits.gather(1, top_i)
            job.route_gaps.append((kth - chosen.min(dim=-1).values).clamp(min=0).cpu())
            top_w = probs.gather(1, top_i)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        wg, wu, wd = experts
        for e in range(s.experts):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            y = (F.silu(xe @ wg[e].t()) * (xe @ wu[e].t())) @ wd[e].t()
            out.index_add_(0, rows, y * top_w[rows, slot][:, None])
        return out.reshape(h.shape)

    @torch.no_grad()
    def run(self, jobs: List[Job]) -> List[Job]:
        """Every job's logits, layer by layer: each layer's weights are drawn
        and quantized once, then applied to every job."""
        s = self.spec
        with no_tf32():
            emb = inputs.embedding(s, self.seed, self.device)
            xs = [emb[j.tokens.to(self.device).long()].float() for j in jobs]
            del emb
            for layer in range(s.layers):
                wq, wk, wv, wo = (self._weight(layer, n) for n in ("wq", "wk", "wv", "wo"))
                for i, j in enumerate(jobs):
                    xs[i] = xs[i] + self._attention(layer, rms_norm(xs[i], s.rms_eps), j,
                                                    wq, wk, wv, wo)
                del wq, wk, wv, wo
                wr = self._weight(layer, "router")
                experts = [self._weight(layer, n) for n in ("w_gate", "w_up", "w_down")]
                for i, j in enumerate(jobs):
                    xs[i] = xs[i] + self._moe(rms_norm(xs[i], s.rms_eps), wr, experts, j, layer)
                del wr, experts
            head = int4_weight(inputs.lm_head(s, self.seed, self.device), s.granularity,
                               s.group_size)
            for i, j in enumerate(jobs):
                j.logits = rms_norm(xs[i], s.rms_eps) @ head.t()
        return jobs


Reference = Mixtral
