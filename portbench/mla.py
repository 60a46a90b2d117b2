"""The sizes, seeded inputs and work of decoders with multi-head latent
attention (DeepSeek-V3's), as their configuration file gives them (Hugging
Face key names), handed alike to the program (``drivers/decode_mla.py``) and
to the plain reference (``reference/deepseek_v3.py``).

Weights are drawn as ``inputs`` draws them: every tensor from a generator of
its own, keyed by the run's seed, its layer and its name, each projection
N(0, 1/in_dim). The blocks are pre-norm, so each router and expert sees a
unit-RMS input and needs no depth factor. Each router's selection bias is
no draw: the plain reference balances it (:func:`balanced_bias`, counting
loads under the group-limited selection) and the program is built with it.
The expert stacks hold the experts [``first_expert``, ``first_expert +
n_routed_experts``) of the router's ``published.n_routed_experts``. Each
sequence's latent cache is seeded for the prompt's positions with c_KV and
k_pe N(0, std^2) (:func:`prefix_latent`).

The work functions count what the inputs need, each byte read once, as
``roofline`` does: MLA's projections and the dense layers, shared experts,
routers and lm_head (``int4_matmul``), the held experts the routing hit
(``grouped_matmul``), the absorption of W_UK and W_UV (``mla_absorb``), the
latent attention kernel (``mla_kernel``: its operations over 989 TFLOP/s
bound it), the whole ``attention.mla`` span (``mla_span``) and the step.
:func:`span_ms_per_step` reads a span's device time under another span's
name, for the kernel's metric. Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

from . import inputs, roofline, spans
from .roofline import ACT_BYTES, Work


@dataclasses.dataclass(frozen=True)
class MLASpec:
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
    router_experts: int          # the router's width: every expert of the layer
    first_expert: int            # the experts held here
    experts: int
    top_k: int
    n_group: int
    topk_group: int
    routed_scale: float
    rope_theta: float
    rms_eps: float
    yarn_factor: float
    yarn_original: int
    yarn_beta_fast: float
    yarn_beta_slow: float
    yarn_mscale: float
    yarn_mscale_all_dim: float
    granularity: str = "per_group"
    group_size: int = 128

    @classmethod
    def from_config(cls, cfg: dict) -> "MLASpec":
        q = cfg.get("quantization", {})
        y = cfg["rope_scaling"]
        if cfg["scoring_func"] != "sigmoid" or y["type"] != "yarn":
            raise ValueError("the latent mixes take sigmoid routers and YaRN RoPE")
        return cls(
            hidden=int(cfg["hidden_size"]), heads=int(cfg["num_attention_heads"]),
            q_lora=int(cfg["q_lora_rank"]), kv_lora=int(cfg["kv_lora_rank"]),
            qk_nope=int(cfg["qk_nope_head_dim"]), qk_rope=int(cfg["qk_rope_head_dim"]),
            v_dim=int(cfg["v_head_dim"]), vocab=int(cfg["vocab_size"]),
            layers=int(cfg["num_hidden_layers"]), dense_layers=int(cfg["first_k_dense_replace"]),
            dense_ffn=int(cfg["intermediate_size"]), moe_ffn=int(cfg["moe_intermediate_size"]),
            shared_ffn=int(cfg["moe_intermediate_size"]) * int(cfg["n_shared_experts"]),
            router_experts=int(cfg.get("published", {}).get("n_routed_experts",
                                                            cfg["n_routed_experts"])),
            first_expert=int(cfg.get("first_expert", 0)), experts=int(cfg["n_routed_experts"]),
            top_k=int(cfg["num_experts_per_tok"]), n_group=int(cfg["n_group"]),
            topk_group=int(cfg["topk_group"]),
            routed_scale=float(cfg["routed_scaling_factor"]) if cfg["norm_topk_prob"] else 1.0,
            rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
            yarn_factor=float(y["factor"]),
            yarn_original=int(y["original_max_position_embeddings"]),
            yarn_beta_fast=float(y["beta_fast"]), yarn_beta_slow=float(y["beta_slow"]),
            yarn_mscale=float(y["mscale"]), yarn_mscale_all_dim=float(y["mscale_all_dim"]),
            granularity=q.get("granularity", "per_row"), group_size=int(q.get("group_size", 128)),
        )

    def moe_layers(self) -> range:
        return range(self.dense_layers, self.layers)

    def mscale(self, m: float) -> float:
        """YaRN's attention factor at this scaling."""
        f = self.yarn_factor
        return 0.1 * m * math.log(f) + 1.0 if f > 1 else 1.0

    @property
    def softmax_scale(self) -> float:
        return (self.qk_nope + self.qk_rope) ** -0.5 * self.mscale(self.yarn_mscale_all_dim) ** 2

    @property
    def latent_bytes(self) -> int:
        """Bytes the latent cache holds for one position of one layer: the
        INT4 codes of c_KV, its f32 scale and zero point, k_pe in bf16."""
        return self.kv_lora // 2 + 8 + ACT_BYTES * self.qk_rope

    def shapes(self, layer: int) -> dict:
        """The layer's dense weights, [out, in] (experts [E, out, in]);
        ``kv_b`` is W_UKV [H (qk_nope + v), kv_lora], head-major."""
        h, nh = self.hidden, self.heads
        out = {"wq_a": (self.q_lora, h), "wq_b": (nh * (self.qk_nope + self.qk_rope), self.q_lora),
               "wkv_a": (self.kv_lora + self.qk_rope, h),
               "kv_b": (nh * (self.qk_nope + self.v_dim), self.kv_lora),
               "wo": (h, nh * self.v_dim)}
        if layer < self.dense_layers:
            f = self.dense_ffn
            return {**out, "dense_gate": (f, h), "dense_up": (f, h), "dense_down": (h, f)}
        e, f, s = self.experts, self.moe_ffn, self.shared_ffn
        return {**out, "router": (self.router_experts, h), "w_gate": (e, f, h),
                "w_up": (e, f, h), "w_down": (e, h, f), "shared_gate": (s, h),
                "shared_up": (s, h), "shared_down": (h, s)}


def layer_weight(spec: MLASpec, seed: int, layer: int, name: str, device) -> torch.Tensor:
    """One dense float32 weight of one layer: N(0, 1/in_dim)."""
    shape = spec.shapes(layer)[name]
    g = inputs.generator(seed, "layer", layer, name, device=device)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(shape[-1] ** -0.5)


def prefix_latent(spec: MLASpec, seed: int, layer: int, rows: range, context: int, std: float,
                  device):
    """The cached latent of one layer, rows ``rows`` of the batch, for the
    prompt's ``context`` positions: c_KV float32 [len(rows), context,
    kv_lora] and k_pe [len(rows), context, qk_rope], N(0, std^2), as the
    cache is handed them (after the RMSNorm and RoPE). Each block of
    ``inputs.KV_BLOCK`` rows has generators of its own; ``rows`` starts at a
    block's first row."""
    if rows.start % inputs.KV_BLOCK:
        raise ValueError(f"rows {rows} do not start at a block of {inputs.KV_BLOCK}")
    out = []
    for which, width in (("c_kv", spec.kv_lora), ("k_pe", spec.qk_rope)):
        parts = []
        for r0 in range(rows.start, rows.stop, inputs.KV_BLOCK):
            n = min(inputs.KV_BLOCK, rows.stop - r0)
            g = inputs.generator(seed, "latent", layer, which, r0 // inputs.KV_BLOCK,
                                 device=device)
            parts.append(torch.randn((n, context, width), generator=g, device=device,
                                     dtype=torch.float32).mul_(std))
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return out[0], out[1]


def group_limited_topk(biased: torch.Tensor, top_k: int, n_group: int,
                       topk_group: int) -> torch.return_types.topk:
    """The top-k of biased scores [T, E] inside the ``topk_group`` best of
    ``n_group`` groups (a group scores the sum of its two best)."""
    groups = biased.reshape(biased.shape[0], n_group, -1)
    best = torch.topk(torch.topk(groups, 2, dim=-1).values.sum(dim=-1), topk_group, dim=-1)
    kept = torch.zeros(groups.shape[:2], dtype=torch.bool, device=biased.device)
    kept.scatter_(1, best.indices, True)
    masked = groups.masked_fill(~kept[..., None], float("-inf")).reshape(biased.shape)
    return torch.topk(masked, top_k, dim=-1)


def balanced_bias(logits: torch.Tensor, spec: MLASpec, steps: int = 64, first: float = 0.2,
                  last: float = 2e-4) -> torch.Tensor:
    """The selection bias [E] that balances the experts' loads over router
    logits [T, E] under the group-limited biased sigmoid top-k, as training
    leaves it: ``hybrid.balanced_bias``'s sign steps (DeepSeek-V3's update)
    with each step's loads counted under the group-limited selection. The
    same operations on the device every time: no host sync."""
    scores = torch.sigmoid(logits.float())
    e = scores.shape[1]
    target = scores.shape[0] * spec.top_k / e
    bias = torch.zeros(e, dtype=torch.float32, device=scores.device)
    ones = torch.ones(scores.shape[0] * spec.top_k, dtype=torch.float32, device=scores.device)
    decay = (last / first) ** (1 / (steps - 1))
    for i in range(steps):
        idx = group_limited_topk(scores + bias, spec.top_k, spec.n_group,
                                 spec.topk_group).indices.reshape(-1)
        load = torch.zeros(e, dtype=torch.float32, device=scores.device).scatter_add_(0, idx, ones)
        bias += first * decay ** i * torch.sign(target - load)
    return bias


def model_bytes(spec: MLASpec) -> int:
    """Bytes of the served weights: the INT4 projections (W_UK^T per row,
    W_UV per group), held experts, shared experts, dense layers and lm_head
    with their scales, the bf16 routers, norms and embedding, and the
    float32 router biases."""
    g, gs = spec.granularity, spec.group_size
    w = roofline.weight_bytes
    total = 0
    for layer in range(spec.layers):
        for name, shape in spec.shapes(layer).items():
            if name == "router":
                total += shape[0] * shape[1] * ACT_BYTES + 4 * shape[0]
            elif name == "kv_b":
                total += absorb_weight_bytes(spec)
            elif len(shape) == 3:
                total += shape[0] * w(shape[1], shape[2], g, gs)
            else:
                total += w(shape[0], shape[1], g, gs)
        total += (2 * spec.hidden + spec.q_lora + spec.kv_lora) * ACT_BYTES   # the norms
    return (total + spec.vocab * spec.hidden * ACT_BYTES
            + spec.hidden * ACT_BYTES + w(spec.vocab, spec.hidden, g, gs))


def absorb_weight_bytes(spec: MLASpec) -> int:
    """W_UK^T [H, kv_lora, qk_nope] per row and W_UV [H, v, kv_lora] per
    group of 128 (``MLAttention.absorbed``), packed with their scales."""
    w = roofline.weight_bytes
    return spec.heads * (w(spec.kv_lora, spec.qk_nope, "per_row", 128)
                         + w(spec.v_dim, spec.kv_lora, "per_group", 128))


def kv_bytes_per_sequence(spec: MLASpec, positions: int) -> int:
    return spec.layers * positions * spec.latent_bytes


def kernel_work(spec: MLASpec, lengths: Sequence[int]) -> Work:
    """One call of the latent attention kernel, one query a row over
    ``lengths`` positions: q_lat . c_KV and q_pe . k_pe, then p . c_KV, for
    every head at 2 operations a multiply-add; each cached position's codes,
    planes and k_pe read once, q_lat and q_pe in and the output out once."""
    pos = sum(lengths)
    b, nh = len(lengths), spec.heads
    return Work(flops=2.0 * nh * (2 * spec.kv_lora + spec.qk_rope) * pos,
                bytes=pos * spec.latent_bytes
                + ACT_BYTES * b * nh * (2 * spec.kv_lora + spec.qk_rope))


def absorb_work(spec: MLASpec, b: int) -> Work:
    """W_UK^T into latent space and W_UV out of it for ``b`` rows: every
    head's weights read once, each head's rows in and out once."""
    nh, lr, dn, dv = spec.heads, spec.kv_lora, spec.qk_nope, spec.v_dim
    return Work(flops=2.0 * b * nh * lr * (dn + dv),
                bytes=absorb_weight_bytes(spec) + ACT_BYTES * b * nh * (dn + 2 * lr + dv))


def step_work(spec: MLASpec, b: int, position: int, tpe: List[List[int]]) -> Dict[str, Work]:
    """One decode step of ``b`` sequences at ``position``, by family:
    ``int4_matmul`` (MLA's q_a, q_b, kv_a and o, routers in bf16, shared
    experts, dense layers, lm_head), ``grouped_matmul`` (gate, up and down of
    the held experts the routing hit, ``tpe[i]`` for the i-th MoE layer),
    ``mla_absorb``, ``mla_kernel`` (every sequence up to ``position + 1``),
    ``mla_span`` (a layer's ``attention.mla`` span: its projections, the
    absorption, the kernel and the new position written to the latent
    cache), the subsets ``shared_expert`` and ``dense_mlp``, and ``step``:
    their sum with the new latent written and the embedding rows read."""
    g, gs, h = spec.granularity, spec.group_size, spec.hidden
    nh = spec.heads
    fam = {k: Work() for k in ("int4_matmul", "grouped_matmul", "mla_absorb", "mla_kernel",
                               "mla_span", "shared_expert", "dense_mlp")}

    def swiglu(f):
        return [roofline.linear(b, f, h, g, gs), roofline.linear(b, f, h, g, gs),
                roofline.linear(b, h, f, g, gs)]

    write = Work(bytes=b * spec.latent_bytes)
    for layer in range(spec.layers):
        for n, k in ((spec.q_lora, h), (nh * (spec.qk_nope + spec.qk_rope), spec.q_lora),
                     (spec.kv_lora + spec.qk_rope, h), (h, nh * spec.v_dim)):
            w = roofline.linear(b, n, k, g, gs)
            fam["int4_matmul"] += w
            fam["mla_span"] += w
        for key, w in (("mla_absorb", absorb_work(spec, b)),
                       ("mla_kernel", kernel_work(spec, [position + 1] * b))):
            fam[key] += w
            fam["mla_span"] += w
        fam["mla_span"] += write
        if layer < spec.dense_layers:
            parts, key = swiglu(spec.dense_ffn), "dense_mlp"
        else:
            e = spec.router_experts
            fam["int4_matmul"] += Work(flops=2.0 * b * e * h,
                                       bytes=e * h * ACT_BYTES + 4 * e + ACT_BYTES * b * (h + e))
            t = tpe[layer - spec.dense_layers]
            for n, k in ((spec.moe_ffn, h), (spec.moe_ffn, h), (h, spec.moe_ffn)):
                fam["grouped_matmul"] += roofline.grouped(t, n, k, g, gs)
            parts, key = swiglu(spec.shared_ffn), "shared_expert"
        for w in parts:
            fam[key] += w
            fam["int4_matmul"] += w
    fam["int4_matmul"] += roofline.linear(b, spec.vocab, h, g, gs)
    step = Work()
    for k in ("int4_matmul", "grouped_matmul", "mla_absorb", "mla_kernel"):
        step += fam[k]
    step += Work(bytes=spec.layers * b * spec.latent_bytes + b * h * ACT_BYTES)
    return {**fam, "step": step}


def span_ms_per_step(obs, name: str, under: str) -> Optional[float]:
    """Device ms a step of every graph node that a span ``name`` lying inside
    a span ``under`` enqueued, its children's included, over the traced
    replays; None without a matching map or traced steps."""
    found = spans.labelled(obs.trace)
    if found is None or obs.steps_traced <= 0:
        return None
    span_map, reps = found
    below, inside = set(), set()        # spans under `under`; those counted
    for i, (n, parent) in enumerate(span_map.spans):
        if n == under or parent in below:
            below.add(i)
        if (n == name and parent in below) or parent in inside:
            inside.add(i)
    total = 0.0
    for ops in reps:
        for start, end, index in span_map.runs:
            if index in inside:
                total += sum(o.dur for o in ops[start:end]) / 1e3
    return total / obs.steps_traced
