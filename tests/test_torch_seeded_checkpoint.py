"""``models.SeededCheckpoint`` on the CPU: its seed reaches every weight.

Each weight's generator was once seeded with ``seed * 2**32 + crc32(key)``,
and the CPU generator keeps only the low 32 bits of a seed, so every seed
gave the same CPU checkpoint. Seed and key are now hashed within 32 bits."""
import torch

from fused4bit_tpu_torch.models import SeededCheckpoint, flagship_model_config

KEYS = ("embed.weight", "layers.0.attn.q_proj.weight", "layers.1.moe.experts.3.w2.weight")


def test_seeds_differ_and_a_seed_repeats():
    cfg = flagship_model_config("tiny")
    a, b, again = (SeededCheckpoint(cfg, device="cpu", seed=s) for s in (0, 1, 0))
    for key in KEYS:
        assert not torch.equal(a[key], b[key]), key
        assert torch.equal(a[key], again[key]), key
    # keys draw from generators of their own; norms stay ones
    assert not torch.equal(a[KEYS[1]][:8, :8], a["layers.0.attn.k_proj.weight"][:8, :8])
    assert torch.equal(a["layers.0.attn_norm.weight"], torch.ones(cfg.num_heads * cfg.head_dim))
