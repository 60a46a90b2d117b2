"""Plain reference of the DeepSeek-V3 decoder as the benchmark's latent
configurations serve it: float32, TF32 off, one layer at a time, a copy of
``reference_models/deepseek_v3.py``'s forward with ``mixtral.py``'s
interface (jobs teacher forced on the program's tokens and experts, from
the decode mixes' seeded prompt cache).

The forward (the DeepSeek-V3 block; ``reference_models/deepseek_v3.py``
gives its sources and what is assumed), pre-norm: ``h = x +
MLA(RMSNorm(x))``, ``y = h + FFN(RMSNorm(h))``. MLA: ``c_q =
RMSNorm(x W_DQ)``, ``[q_nope, q_pe] = c_q W_UQ``, ``[c_KV, k_pe] = x W_DKV``,
``c_KV = RMSNorm(c_KV)``, YaRN RoPE over channel pairs on q_pe and k_pe,
scores ``(q_nope . k_nope + q_pe . k_pe) * 192^-0.5 mscale^2`` with
``k_nope, v = W_UKV c_KV``. It computes them in the absorbed form, as
DeepSeek's ``inference/model.py`` does by default (``q_nope W_UK`` against
c_KV, the output ``(p c_KV) W_UV``): ``tests/test_deepseek_v3_bench_driver``
holds it to the published form in float32. The FFN a dense SwiGLU on the
leading dense layers, else the held experts' part of the routed sum plus
the shared expert. The router: sigmoid scores plus a per-expert selection
bias, the top-k inside the ``topk_group`` best of ``n_group`` groups (a
group scoring the sum of its two best biased scores), weights the unbiased
scores of the k renormalized and scaled. A final RMSNorm and the lm_head.

It imports nothing of the program. From the run's seed it draws the dense
weights again (``portbench.mla``, the draws the program quantized) and
applies ``mixtral.py``'s INT4 grid to each projection, expert, shared
expert, dense layer and the lm_head, per group of ``group_size`` input
columns; ``W_UKV`` as the program absorbs it (W_UK^T over qk_nope, one
group a row; W_UV per group along kv_lora); the router and the embedding
are read in bf16 and the bias in float32, as they are served. The new
positions' c_KV, rounded to bf16, and the seeded prompt positions' (in
float32, as the cache is handed them) pass ``mixtral.py``'s INT4 rule over
kv_lora; every k_pe is rounded to bf16, as the latent cache holds it. The
experts outside the held share are left out, as in the program. A token's
experts are the program's (``Job.routes``), checked as the margin of their
biased scores below the reference's own k-th best inside its best groups
(``route_gaps``) and as the margin of their groups' scores below its own
``topk_group``-th best group (``group_gaps``, 0 inside); each job keeps the
gap of every served token (``Job.gaps``), not its logits.

The routers' selection biases are the reference's own: given none, it sets
each MoE layer's bias from its router's output over every job before the
layer routes (``mla.balanced_bias``), routes by it, and keeps the biases
(``DeepSeekV3.router_biases``) for the program to be built with. Without
``Job.routes`` it routes by its own selection and keeps the choices
(``Job.chosen``); without ``Job.served`` it keeps its own first choices
(``Job.firsts``).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from .. import inputs, mla
from ..mla import MLASpec
from .mixtral import affine_int4, int4_weight, no_tf32

# heads a block of the attention computes at once (bounds the scores' memory)
_HEAD_BLOCK = 32


class Job:
    """One batch of sequences: ``tokens`` [B, T] at positions ``start ..
    start + T - 1`` after ``start`` cached positions whose c_KV and k_pe
    ``prefix(layer)`` gives (float32 [B, start, kv_lora] and [B, start,
    qk_rope]); ``served`` [B, T] the tokens the program served there,
    ``routes`` [MoE layers, B, T, k] the experts it chose (each None: the
    reference's own). Filled in: ``gaps`` [B, T], the reference's best logit
    minus its logit of the served token, ``route_gaps`` and ``group_gaps``,
    one tensor a MoE layer; without ``served`` its own first choices
    ``firsts`` [B, T], without ``routes`` its own choices ``chosen``."""

    def __init__(self, tokens: torch.Tensor, start: int, served: Optional[torch.Tensor],
                 routes: Optional[torch.Tensor], prefix: Callable[[int], tuple]):
        self.tokens, self.start, self.served = tokens, start, served
        self.routes, self.prefix = routes, prefix
        self.gaps: Optional[torch.Tensor] = None
        self.firsts: Optional[torch.Tensor] = None
        self.route_gaps: List[torch.Tensor] = []
        self.group_gaps: List[torch.Tensor] = []
        self.chosen: List[torch.Tensor] = []


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with weight 1 (every norm of the benchmark's models), float32."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg.t()) * (x @ wu.t())) @ wd.t()


def inv_freq(s: MLASpec, device) -> torch.Tensor:
    """YaRN's rotary frequencies [qk_rope / 2] (DeepSeek-V3's
    ``precompute_freqs_cis``)."""
    dim, base = s.qk_rope, s.rope_theta
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))

    def corr(rot):
        return dim * math.log(s.yarn_original / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(s.yarn_beta_fast)), 0), min(math.ceil(corr(s.yarn_beta_slow)),
                                                                  dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return freqs / s.yarn_factor * ramp + freqs * (1 - ramp)


def rope(s: MLASpec, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [B, T, ..., R] at positions pos [T]: channel pairs (2i, 2i + 1)
    rotated, cos and sin times mscale(factor, mscale) / mscale(factor,
    mscale_all_dim)."""
    ang = pos.float()[:, None] * inv_freq(s, x.device)                 # [T, R/2]
    ang = ang.reshape(1, ang.shape[0], *([1] * (x.dim() - 3)), ang.shape[-1])
    f = s.mscale(s.yarn_mscale) / s.mscale(s.yarn_mscale_all_dim)
    cos, sin = ang.cos() * f, ang.sin() * f
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def absorbed_weights(s: MLASpec, kv_b: torch.Tensor):
    """(W_UK [H, qk_nope, kv_lora], W_UV [H, v, kv_lora]) of the dense
    W_UKV on the INT4 grid, as the program absorbs it."""
    w = kv_b.float().reshape(s.heads, s.qk_nope + s.v_dim, s.kv_lora)
    uk = int4_weight(w[:, :s.qk_nope].transpose(1, 2), "per_row", 0).transpose(1, 2)
    return uk, int4_weight(w[:, s.qk_nope:], s.granularity, s.group_size)


def attention(s: MLASpec, q_nope, q_pe, c, k_pe, uk, uv, mask, absorbed: bool = True):
    """Attention of q_nope [B, T, H, dn] and q_pe [B, T, H, dr] over the
    latent c [B, S, L] and k_pe [B, S, dr], ``mask`` [T, S] (True: seen),
    a block of heads at a time; [B, T, H * v]. ``absorbed``: the absorbed
    form; else the published one (k_nope and v formed per head)."""
    b, t, nh, _ = q_nope.shape
    out = torch.empty((b, t, nh, s.v_dim), dtype=torch.float32, device=q_nope.device)
    for h0 in range(0, nh, _HEAD_BLOCK):
        hs = slice(h0, h0 + _HEAD_BLOCK)
        pe = torch.einsum("bthr,bsr->bhts", q_pe[:, :, hs], k_pe)
        if absorbed:
            q_lat = torch.einsum("bthn,hnl->bthl", q_nope[:, :, hs], uk[hs])
            sc = torch.einsum("bthl,bsl->bhts", q_lat, c) + pe
        else:
            k_nope = torch.einsum("bsl,hnl->bhsn", c, uk[hs])
            sc = torch.einsum("bthn,bhsn->bhts", q_nope[:, :, hs], k_nope) + pe
        p = torch.softmax((sc * s.softmax_scale).masked_fill(~mask, float("-inf")), dim=-1)
        del sc, pe
        if absorbed:
            out[:, :, hs] = torch.einsum("hvl,bhtl->bthv", uv[hs],
                                         torch.einsum("bhts,bsl->bhtl", p, c))
        else:
            v = torch.einsum("bsl,hvl->bhsv", c, uv[hs])
            out[:, :, hs] = torch.einsum("bhts,bhsv->bthv", p, v)
    return out.reshape(b, t, nh * s.v_dim)


class DeepSeekV3:
    def __init__(self, spec: MLASpec, seed: int, device,
                 router_biases: Optional[List[torch.Tensor]] = None, absorbed: bool = True):
        """``router_biases``: each MoE layer's selection bias [E], in order;
        None: balanced here on the first run's jobs. ``absorbed``: the
        attention's form."""
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.router_biases = None if router_biases is None else list(router_biases)
        self.balance = router_biases is None
        self.absorbed = absorbed

    def _weight(self, layer: int, name: str):
        s = self.spec
        w = mla.layer_weight(s, self.seed, layer, name, self.device)
        if name == "router":    # served in bf16
            return w.bfloat16().float()
        if name == "kv_b":
            return absorbed_weights(s, w)
        return int4_weight(w, s.granularity, s.group_size)

    def _attention(self, layer: int, h: torch.Tensor, job: Job, w: dict) -> torch.Tensor:
        s = self.spec
        b, t, _ = h.shape
        pos = torch.arange(job.start, job.start + t, device=h.device)
        q = (rms_norm(h @ w["wq_a"].t(), s.rms_eps) @ w["wq_b"].t()).reshape(
            b, t, s.heads, s.qk_nope + s.qk_rope)
        kv = h @ w["wkv_a"].t()
        c = affine_int4(rms_norm(kv[..., :s.kv_lora], s.rms_eps).bfloat16().float())
        k_pe = rope(s, kv[..., s.kv_lora:], pos).bfloat16().float()
        pc, ppe = job.prefix(layer)
        c = torch.cat([affine_int4(pc), c], dim=1)
        k_pe = torch.cat([ppe.bfloat16().float(), k_pe], dim=1)
        del pc, ppe
        kpos = torch.arange(job.start + t, device=h.device)
        mask = kpos[None, :] <= pos[:, None]                             # [T, S]
        uk, uv = w["kv_b"]
        out = attention(s, q[..., :s.qk_nope], rope(s, q[..., s.qk_nope:], pos), c, k_pe, uk, uv,
                        mask, self.absorbed)
        return out @ w["wo"].t()

    def _moe(self, x: torch.Tensor, w: dict, job: Job, i: int) -> torch.Tensor:
        s = self.spec
        flat = x.reshape(-1, s.hidden)
        scores = torch.sigmoid(flat @ w["router"].t())
        biased = scores + w["router_bias"]
        per = s.router_experts // s.n_group
        groups = biased.reshape(-1, s.n_group, per)
        group_score = torch.topk(groups, 2, dim=-1).values.sum(dim=-1)
        best = torch.topk(group_score, s.topk_group, dim=-1)
        top = mla.group_limited_topk(biased, s.top_k, s.n_group, s.topk_group)
        if job.routes is None:
            idx = top.indices
            job.chosen.append(idx.reshape(*x.shape[:2], s.top_k).cpu())
        else:
            idx = job.routes[i].reshape(-1, s.top_k).to(x.device).long()
            job.route_gaps.append((top.values[:, -1] - biased.gather(1, idx).min(dim=-1).values)
                                  .clamp(min=0).cpu())
            job.group_gaps.append((best.values[:, -1:] - group_score.gather(1, idx // per))
                                  .clamp(min=0).cpu())
        wts = scores.gather(1, idx)
        wts = wts / wts.sum(dim=-1, keepdim=True) * s.routed_scale
        out = swiglu(flat, w["shared_gate"], w["shared_up"], w["shared_down"])
        for e in range(s.experts):
            rows, slot = (idx == s.first_expert + e).nonzero(as_tuple=True)
            if rows.numel():
                y = swiglu(flat[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
                out.index_add_(0, rows, y * wts[rows, slot][:, None])
        return out.reshape(x.shape)

    def _bias(self, i: int, xs: List[torch.Tensor], router: torch.Tensor) -> torch.Tensor:
        """MoE layer i's selection bias; balanced over every job's rows when
        the reference sets the biases itself."""
        if self.balance and len(self.router_biases) == i:
            logits = torch.cat([x.reshape(-1, self.spec.hidden) @ router.t() for x in xs])
            self.router_biases.append(mla.balanced_bias(logits, self.spec))
        return self.router_biases[i].float().to(self.device)

    @torch.no_grad()
    def run(self, jobs: List[Job]) -> List[Job]:
        """Every job's gaps (or first choices), layer by layer: each layer's
        weights are drawn and quantized once, then applied to every job."""
        s = self.spec
        if self.balance and self.router_biases:
            raise RuntimeError("the biases were balanced on an earlier run's jobs; hand them in")
        self.router_biases = [] if self.router_biases is None else self.router_biases
        attn = ("wq_a", "wq_b", "wkv_a", "kv_b", "wo")
        with no_tf32():
            emb = inputs.embedding(s, self.seed, self.device)
            xs = [emb[j.tokens.to(self.device).long()].float() for j in jobs]
            del emb
            for layer in range(s.layers):
                w = {n: self._weight(layer, n) for n in attn}
                hs = [x + self._attention(layer, rms_norm(x, s.rms_eps), j, w)
                      for x, j in zip(xs, jobs)]
                w = {n: self._weight(layer, n) for n in s.shapes(layer) if n not in attn}
                fs = [rms_norm(h, s.rms_eps) for h in hs]
                if layer >= s.dense_layers:
                    w["router_bias"] = self._bias(layer - s.dense_layers, fs, w["router"])
                for i, (h, f, j) in enumerate(zip(hs, fs, jobs)):
                    if layer < s.dense_layers:
                        f = swiglu(f, w["dense_gate"], w["dense_up"], w["dense_down"])
                    else:
                        f = self._moe(f, w, j, layer - s.dense_layers)
                    xs[i] = h + f
                del w, hs, fs
            head = int4_weight(inputs.lm_head(s, self.seed, self.device), s.granularity,
                               s.group_size)
            for x, j in zip(xs, jobs):
                logits = rms_norm(x, s.rms_eps) @ head.t()
                if j.served is None:
                    j.firsts = logits.argmax(dim=-1).cpu()
                else:
                    best = logits.max(dim=-1).values
                    got = logits.gather(-1, j.served.to(logits.device).long()[..., None])[..., 0]
                    j.gaps = (best - got).cpu()
                if j.routes is None:
                    j.chosen = torch.stack(j.chosen)
                del logits
        return jobs


Reference = DeepSeekV3
