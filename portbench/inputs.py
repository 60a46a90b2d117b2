"""The inputs a run makes from its seed, handed alike to the program and to
the plain reference: the model's sizes, its dense weights, the cached K/V
of the decode mixes and the traffic's token ids.

Every tensor has a generator of its own, seeded from the run's seed and
the tensor's key, so that the reference draws any one layer again without
drawing the layers before it. The draws run on the device given, in one
call per tensor; the same seed, key and device give the same numbers.
Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import zlib

import torch

_MASK = (1 << 64) - 1


def mix(*parts) -> int:
    """A 63-bit generator seed from whole numbers and strings (splitmix64
    over each part in turn)."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        v = zlib.crc32(p.encode()) if isinstance(p, str) else int(p)
        z = (z ^ (v & _MASK)) & _MASK
        z = (z + 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z & ((1 << 63) - 1)


def generator(seed: int, *key, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *key))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The sizes of a Mixtral-style decoder, read from a configuration file
    (Hugging Face key names), and how its weights are quantized."""

    hidden: int
    ffn: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int
    top_k: int
    vocab: int
    rope_theta: float
    rms_eps: float
    granularity: str = "per_row"
    group_size: int = 128

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelSpec":
        q = cfg.get("quantization", {})
        heads = int(cfg["num_attention_heads"])
        return cls(
            hidden=int(cfg["hidden_size"]), ffn=int(cfg["intermediate_size"]),
            layers=int(cfg["num_hidden_layers"]), heads=heads,
            kv_heads=int(cfg["num_key_value_heads"]),
            head_dim=int(cfg.get("head_dim") or cfg["hidden_size"] // heads),
            experts=int(cfg["num_local_experts"]), top_k=int(cfg["num_experts_per_tok"]),
            vocab=int(cfg["vocab_size"]), rope_theta=float(cfg["rope_theta"]),
            rms_eps=float(cfg["rms_norm_eps"]),
            granularity=q.get("granularity", "per_row"), group_size=int(q.get("group_size", 128)),
        )

    def shapes(self) -> dict:
        """Each layer's dense weights, [out, in] (experts [E, out, in])."""
        h, f, e = self.hidden, self.ffn, self.experts
        qd, kvd = self.heads * self.head_dim, self.kv_heads * self.head_dim
        return {"wq": (qd, h), "wk": (kvd, h), "wv": (kvd, h), "wo": (h, qd),
                "router": (e, h), "w_gate": (e, f, h), "w_up": (e, f, h), "w_down": (e, h, f)}


def layer_weight(spec: ModelSpec, seed: int, layer: int, name: str, device) -> torch.Tensor:
    """One dense float32 weight of one layer: N(0, 1/in_dim)."""
    shape = spec.shapes()[name]
    g = generator(seed, "layer", layer, name, device=device)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(shape[-1] ** -0.5)


def embedding(spec: ModelSpec, seed: int, device) -> torch.Tensor:
    """The bf16 embedding [V, H]: N(0, 0.02^2), the type it is served in."""
    g = generator(seed, "embed", device=device)
    w = torch.randn((spec.vocab, spec.hidden), generator=g, device=device, dtype=torch.float32)
    return w.mul_(0.02).to(torch.bfloat16)


def lm_head(spec: ModelSpec, seed: int, device) -> torch.Tensor:
    g = generator(seed, "lm_head", device=device)
    w = torch.randn((spec.vocab, spec.hidden), generator=g, device=device, dtype=torch.float32)
    return w.mul_(spec.hidden ** -0.5)


# Rows of the cached keys and values drawn by one generator: the program
# writes its cache and the reference reads it a block at a time.
KV_BLOCK = 64


def prefix_kv(spec: ModelSpec, seed: int, layer: int, rows: range, context: int, std: float,
              device):
    """The cached keys and values of one layer, rows ``rows`` of the batch,
    for the decode mixes: float32 [len(rows), H_kv, context, D] each,
    N(0, std^2), as the cache holds them (after RoPE). Each block of
    ``KV_BLOCK`` rows has generators of its own, so any block is drawn
    alone; ``rows`` starts at a block's first row."""
    if rows.start % KV_BLOCK:
        raise ValueError(f"rows {rows} do not start at a block of {KV_BLOCK}")
    out = []
    for which in ("k", "v"):
        parts = []
        for r0 in range(rows.start, rows.stop, KV_BLOCK):
            n = min(KV_BLOCK, rows.stop - r0)
            g = generator(seed, "kv", layer, which, r0 // KV_BLOCK, device=device)
            parts.append(torch.randn((n, spec.kv_heads, context, spec.head_dim), generator=g,
                                     device=device, dtype=torch.float32).mul_(std))
        out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
    return out[0], out[1]
