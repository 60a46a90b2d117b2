"""Plain reference of the K-EXAONE decoder as the benchmark's hybrid
configurations serve it: float32, TF32 off, one layer at a time, a copy of
``reference_models/k_exaone.py``'s forward with ``mixtral.py``'s
interface (jobs teacher forced on the program's tokens and experts, from
the decode mixes' seeded prompt cache).

The forward (the EXAONE 4.0 block; ``reference_models/k_exaone.py`` gives
its sources and what is assumed): per layer q, k = RMSNorm over head_dim of
the projections, RoPE (half-split) on the window layers only, attention
masked to ``q - window < p <= q`` on a window layer, ``h = x +
RMSNorm(attention)``, ``y = h + RMSNorm(FFN(h))``; the FFN a dense SwiGLU
on the leading dense layers, else the held experts' part of the routed sum
plus the shared expert. The router: sigmoid scores, the top-k of the
scores plus a per-expert correction bias, weights the unbiased scores of
the k renormalized and scaled. A final RMSNorm and the lm_head.

It imports nothing of the program. From the run's seed it draws the dense
weights again (``portbench.hybrid``, the draws the program quantized) and
applies ``mixtral.py``'s INT4 grid to each projection, expert, shared
expert, dense layer and the lm_head; the router and the embedding are read
in bf16 and the bias in float32, as they are served. Keys and values of
the new positions, rounded to bf16, and the seeded prompt positions' (in
float32, as the cache is handed them) pass ``mixtral.py``'s INT4 KV rule.
The experts outside the held share are left out, as in the program. A
token's experts are the program's (``Job.routes``), checked by themselves
as the margin of their biased scores below the reference's own k-th best;
each job keeps the gap of every served token (``Job.gaps``), not its
logits, so that 153600-wide logits of every job need not be held.

The routers' correction biases are the reference's own: given none, it
sets each MoE layer's bias from its router's output over every job before
the layer routes (``hybrid.balanced_bias``, DeepSeek-V3's update, as
training leaves the bias), routes by it, and keeps the biases
(``KExaone.router_biases``) for the program to be built with. Without
``Job.routes`` it routes by its own biased top-k and keeps the choices
(``Job.chosen``); without ``Job.served`` it keeps its own first choices
(``Job.firsts``).

``dtype`` bfloat16 runs the same forward with the activations in bf16, as
a bf16 deployment serves it: every weight and every sublayer's output
rounded to bf16, the norms, RoPE, attention's softmax and the routed sum
in float32 over bf16 inputs, the logits bf16. It stands in the program's
place as a witness of what bf16 alone costs, judged by the float32 run.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from .. import hybrid, inputs
from ..hybrid import HybridSpec
from .mixtral import affine_int4, int4_weight, no_tf32, rope


class Job:
    """One batch of sequences: ``tokens`` [B, T] at positions ``start ..
    start + T - 1`` after ``start`` cached positions whose keys and values
    ``prefix(layer)`` gives (float32 [B, H_kv, start, D]); ``served`` [B, T]
    the tokens the program served there, ``routes`` [MoE layers, B, T, k]
    the experts it chose (each None: the reference's own). Filled in:
    ``gaps`` [B, T], the reference's best logit minus its logit of the
    served token, and ``route_gaps``, one tensor a MoE layer; without
    ``served`` its own first choices ``firsts`` [B, T], without ``routes``
    its own choices ``chosen`` [MoE layers, B, T, k]."""

    def __init__(self, tokens: torch.Tensor, start: int, served: Optional[torch.Tensor],
                 routes: Optional[torch.Tensor], prefix: Callable[[int], tuple]):
        self.tokens, self.start, self.served = tokens, start, served
        self.routes, self.prefix = routes, prefix
        self.gaps: Optional[torch.Tensor] = None
        self.firsts: Optional[torch.Tensor] = None
        self.route_gaps: List[torch.Tensor] = []
        self.chosen: List[torch.Tensor] = []


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with weight 1 (every norm of the benchmark's models), in
    float32, returned in x's type."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg.t()) * (x @ wu.t())) @ wd.t()


class KExaone:
    def __init__(self, spec: HybridSpec, seed: int, device,
                 router_biases: Optional[List[torch.Tensor]] = None, dtype=torch.float32):
        """``router_biases``: each MoE layer's correction bias [E], in order;
        None: balanced here on the first run's jobs. ``dtype``: the
        activations' type, float32 or bfloat16."""
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.router_biases = None if router_biases is None else list(router_biases)
        self.balance = router_biases is None
        self.act = dtype

    def _weight(self, layer: int, name: str) -> torch.Tensor:
        s = self.spec
        w = hybrid.layer_weight(s, self.seed, layer, name, self.device)
        if name == "router":    # served in bf16
            return w.bfloat16().to(self.act)
        return int4_weight(w, s.granularity, s.group_size).to(self.act)

    def _attention(self, layer: int, h: torch.Tensor, job: Job, w: dict) -> torch.Tensor:
        s = self.spec
        b, t, _ = h.shape
        window = s.windows[layer]
        pos = torch.arange(job.start, job.start + t, device=h.device)
        q = (h @ w["wq"].t()).reshape(b, t, s.heads, s.head_dim).transpose(1, 2)
        k = (h @ w["wk"].t()).reshape(b, t, s.kv_heads, s.head_dim).transpose(1, 2)
        v = (h @ w["wv"].t()).reshape(b, t, s.kv_heads, s.head_dim).transpose(1, 2)
        q, k = rms_norm(q, s.rms_eps), rms_norm(k, s.rms_eps)
        if window:
            q = rope(q.float(), pos, s.rope_theta).to(self.act)
            k = rope(k.float(), pos, s.rope_theta).to(self.act)
        q = q.float()
        k, v = affine_int4(k.bfloat16().float()), affine_int4(v.bfloat16().float())
        pk, pv = job.prefix(layer)
        first = max(0, job.start - window) if window else 0   # older keys lie outside every window
        k = torch.cat([affine_int4(pk[:, :, first:]), k], dim=2)
        v = torch.cat([affine_int4(pv[:, :, first:]), v], dim=2)
        del pk, pv
        kpos = torch.arange(first, job.start + t, device=h.device)
        mask = kpos[None, :] <= pos[:, None]                             # [T, S]
        if window:
            mask &= kpos[None, :] > pos[:, None] - window
        rep = s.heads // s.kv_heads
        out = torch.empty_like(q)
        for g in range(s.kv_heads):                                      # a KV head at a time
            sc = (q[:, g * rep:(g + 1) * rep] @ k[:, g:g + 1].transpose(-1, -2))
            sc = (sc / math.sqrt(s.head_dim)).masked_fill(~mask, float("-inf"))
            out[:, g * rep:(g + 1) * rep] = torch.softmax(sc, dim=-1) @ v[:, g:g + 1]
        out = out.transpose(1, 2).reshape(b, t, s.heads * s.head_dim).to(self.act)
        return out @ w["wo"].t()

    def _moe(self, h: torch.Tensor, w: dict, job: Job, i: int) -> torch.Tensor:
        s = self.spec
        x = h.reshape(-1, s.hidden)
        scores = torch.sigmoid((x @ w["router"].t()).float())
        biased = scores + w["router_bias"]
        top = torch.topk(biased, s.top_k, dim=-1)
        if job.routes is None:
            idx = top.indices
            job.chosen.append(idx.reshape(*h.shape[:2], s.top_k).cpu())
        else:
            idx = job.routes[i].reshape(-1, s.top_k).to(x.device).long()
            job.route_gaps.append((top.values[:, -1] - biased.gather(1, idx).min(dim=-1).values)
                                  .clamp(min=0).cpu())
        wts = scores.gather(1, idx)
        wts = wts / wts.sum(dim=-1, keepdim=True) * s.routed_scale
        out = swiglu(x, w["shared_gate"], w["shared_up"], w["shared_down"]).float()
        for e in range(s.experts):
            rows, slot = (idx == s.first_expert + e).nonzero(as_tuple=True)
            if rows.numel():
                y = swiglu(x[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
                out.index_add_(0, rows, y.float() * wts[rows, slot][:, None])
        return out.reshape(h.shape).to(self.act)

    def _bias(self, i: int, hs: List[torch.Tensor], router: torch.Tensor) -> torch.Tensor:
        """MoE layer i's correction bias; balanced over every job's rows when
        the reference sets the biases itself."""
        if self.balance and len(self.router_biases) == i:
            logits = torch.cat([h.reshape(-1, self.spec.hidden) @ router.t() for h in hs])
            self.router_biases.append(hybrid.balanced_bias(logits, self.spec.top_k))
        return self.router_biases[i].float().to(self.device)

    @torch.no_grad()
    def run(self, jobs: List[Job]) -> List[Job]:
        """Every job's gaps (or first choices), layer by layer: each layer's
        weights are drawn and quantized once, then applied to every job."""
        s = self.spec
        if self.balance and self.router_biases:
            raise RuntimeError("the biases were balanced on an earlier run's jobs; hand them in")
        self.router_biases = [] if self.router_biases is None else self.router_biases
        with no_tf32():
            emb = inputs.embedding(s, self.seed, self.device)
            xs = [emb[j.tokens.to(self.device).long()].to(self.act) for j in jobs]
            del emb
            for layer in range(s.layers):
                w = {n: self._weight(layer, n) for n in s.shapes(layer) if n in
                     ("wq", "wk", "wv", "wo")}
                hs = [x + rms_norm(self._attention(layer, x, j, w), s.rms_eps)
                      for x, j in zip(xs, jobs)]
                w = {n: self._weight(layer, n) for n in s.shapes(layer) if n not in w}
                if layer >= s.dense_layers:
                    w["router_bias"] = self._bias(layer - s.dense_layers, hs, w["router"])
                for i, (h, j) in enumerate(zip(hs, jobs)):
                    if layer < s.dense_layers:
                        f = swiglu(h, w["dense_gate"], w["dense_up"], w["dense_down"])
                    else:
                        f = self._moe(h, w, j, layer - s.dense_layers)
                    xs[i] = h + rms_norm(f, s.rms_eps)
                del w, hs
            head = int4_weight(inputs.lm_head(s, self.seed, self.device), s.granularity,
                               s.group_size).to(self.act)
            for x, j in zip(xs, jobs):
                logits = rms_norm(x, s.rms_eps) @ head.t()
                if j.served is None:
                    j.firsts = logits.argmax(dim=-1).cpu()
                else:
                    logits = logits.float()
                    best = logits.max(dim=-1).values
                    got = logits.gather(-1, j.served.to(logits.device).long()[..., None])[..., 0]
                    j.gaps = (best - got).cpu()
                if j.routes is None:
                    j.chosen = torch.stack(j.chosen)
                del logits
        return jobs


Reference = KExaone
