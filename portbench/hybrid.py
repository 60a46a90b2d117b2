"""The sizes and seeded inputs of decoders whose layers hold caches of two
sizes (window layers beside full ones), with leading dense layers, a
sigmoid router and a shared expert, as K-EXAONE's configuration file gives
them (Hugging Face key names), handed alike to the program
(``drivers/decode_hybrid.py``) and to the plain reference
(``reference/k_exaone.py``).

Weights are drawn as ``inputs`` draws them: every tensor from a generator
of its own, keyed by the run's seed, its layer and its name, each
projection N(0, 1/in_dim). Layer l's router is drawn 1/sqrt(2l + 1) of
that: with every norm weight 1, each sublayer adds a unit-RMS output to
the residual, whose RMS at layer l's MoE input is then about sqrt(2l + 1),
and the router's logits keep a trained router's unit scale instead of
saturating the sigmoid (the configuration's ``assumed``). Each router's
correction bias is no draw: the plain reference balances it
(:func:`balanced_bias`) and the program is built with it. The expert
stacks hold the experts [``first_expert``, ``first_expert + num_experts``)
of the router's ``published.num_experts``. Nothing here imports the
program.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import inputs, roofline


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    windows: Tuple[int, ...]     # each layer's window; 0: full attention
    dense_layers: int
    dense_ffn: int
    moe_ffn: int
    shared_ffn: int
    router_experts: int          # the router's width: every expert of the layer
    first_expert: int            # the experts held here
    experts: int
    top_k: int
    routed_scale: float
    rope_theta: float
    rms_eps: float
    granularity: str = "per_group"
    group_size: int = 128

    @classmethod
    def from_config(cls, cfg: dict) -> "HybridSpec":
        q = cfg.get("quantization", {})
        if cfg["scoring_func"] != "sigmoid" or cfg["n_group"] != 1 or cfg["topk_group"] != 1:
            raise ValueError("the hybrid mixes take sigmoid routers over one group")
        dense = [t == "dense" for t in cfg["mlp_layer_types"]]
        return cls(
            hidden=int(cfg["hidden_size"]), heads=int(cfg["num_attention_heads"]),
            kv_heads=int(cfg["num_key_value_heads"]), head_dim=int(cfg["head_dim"]),
            vocab=int(cfg["vocab_size"]), windows=tuple(int(w) for w in cfg["sliding_windows"]),
            dense_layers=dense.index(False), dense_ffn=int(cfg["intermediate_size"]),
            moe_ffn=int(cfg["moe_intermediate_size"]),
            shared_ffn=int(cfg["moe_intermediate_size"]) * int(cfg["num_shared_experts"]),
            router_experts=int(cfg.get("published", {}).get("num_experts", cfg["num_experts"])),
            first_expert=int(cfg.get("first_expert", 0)), experts=int(cfg["num_experts"]),
            top_k=int(cfg["num_experts_per_tok"]),
            routed_scale=float(cfg["routed_scaling_factor"]) if cfg["norm_topk_prob"] else 1.0,
            rope_theta=float(cfg["rope_parameters"]["rope_theta"]),
            rms_eps=float(cfg["rms_norm_eps"]),
            granularity=q.get("granularity", "per_row"), group_size=int(q.get("group_size", 128)),
        )

    @property
    def layers(self) -> int:
        return len(self.windows)

    def moe_layers(self) -> range:
        return range(self.dense_layers, self.layers)

    def shapes(self, layer: int) -> dict:
        """The layer's dense weights, [out, in] (experts [E, out, in])."""
        h, qd, kvd = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        out = {"wq": (qd, h), "wk": (kvd, h), "wv": (kvd, h), "wo": (h, qd)}
        if layer < self.dense_layers:
            f = self.dense_ffn
            return {**out, "dense_gate": (f, h), "dense_up": (f, h), "dense_down": (h, f)}
        e, f, s = self.experts, self.moe_ffn, self.shared_ffn
        return {**out, "router": (self.router_experts, h), "w_gate": (e, f, h),
                "w_up": (e, f, h), "w_down": (e, h, f), "shared_gate": (s, h),
                "shared_up": (s, h), "shared_down": (h, s)}


def layer_weight(spec: HybridSpec, seed: int, layer: int, name: str, device) -> torch.Tensor:
    """One dense float32 weight of one layer: N(0, 1/in_dim), the router
    N(0, 1/(in_dim (2 layer + 1)))."""
    shape = spec.shapes(layer)[name]
    g = inputs.generator(seed, "layer", layer, name, device=device)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_((shape[-1] * (2 * layer + 1 if name == "router" else 1)) ** -0.5)


def balanced_bias(logits: torch.Tensor, top_k: int, steps: int = 64, first: float = 0.2,
                  last: float = 2e-4) -> torch.Tensor:
    """The correction bias [E] that balances the experts' loads over router
    logits [T, E] under the biased sigmoid top-k, as training leaves it:
    DeepSeek-V3's update, each step raising the bias of every expert below
    the mean load and lowering it above, by ``steps`` sign steps shrinking
    from ``first`` to ``last``, from 0. The same operations on the device
    every time: no host sync."""
    scores = torch.sigmoid(logits.float())
    e = scores.shape[1]
    target = scores.shape[0] * top_k / e
    bias = torch.zeros(e, dtype=torch.float32, device=scores.device)
    ones = torch.ones(scores.shape[0] * top_k, dtype=torch.float32, device=scores.device)
    decay = (last / first) ** (1 / (steps - 1))
    for i in range(steps):
        idx = torch.topk(scores + bias, top_k, dim=-1).indices.reshape(-1)
        load = torch.zeros(e, dtype=torch.float32, device=scores.device).scatter_add_(0, idx, ones)
        bias += first * decay ** i * torch.sign(target - load)
    return bias


def ring_slots(window: int, max_tokens: int) -> int:
    """The slots of a window layer's ring: the window plus the most
    positions one forward appends, rounded up to even (the port's rule)."""
    n = window + max_tokens
    return n + n % 2


def kv_bytes_per_sequence(spec: HybridSpec, positions: int, max_tokens: int) -> int:
    """The INT4 KV cache of one sequence over every layer: ``positions``
    slots on a full layer, its ring on a window layer; K and V codes and
    their four float32 planes per KV head."""
    per_slot = spec.kv_heads * (spec.head_dim + 4 * 4)
    return sum(per_slot * (ring_slots(w, max_tokens) if w else positions) for w in spec.windows)


def model_bytes(spec: HybridSpec) -> int:
    """Bytes of the served weights: the INT4 projections, held experts,
    shared experts, dense layers and lm_head with their scales, the bf16
    routers, norms and embedding, and the float32 router biases."""
    g, gs = spec.granularity, spec.group_size
    w = roofline.weight_bytes
    total = 0
    for layer in range(spec.layers):
        shapes = spec.shapes(layer)
        for name, shape in shapes.items():
            if name == "router":
                total += shape[0] * shape[1] * roofline.ACT_BYTES + 4 * shape[0]
            elif len(shape) == 3:
                total += shape[0] * w(shape[1], shape[2], g, gs)
            else:
                total += w(shape[0], shape[1], g, gs)
        total += (2 * spec.hidden + 2 * spec.head_dim) * roofline.ACT_BYTES   # the norms
    return (total + spec.vocab * spec.hidden * roofline.ACT_BYTES
            + spec.hidden * roofline.ACT_BYTES + w(spec.vocab, spec.hidden, g, gs))
