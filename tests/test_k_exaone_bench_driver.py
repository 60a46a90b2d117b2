"""The benchmark's ``decode_hybrid`` driver and its plain reference on the
CPU, at a tiny K-EXAONE-shaped configuration: 8 layers ("LLLG" twice,
windows of 8), hidden 128 against a q width of 4 x 64, a dense first
layer, 4 of 16 experts held, top-4 under a sigmoid router.

The driver runs its whole path eagerly here (no CUDA graph): the
reference's bias pass, the rings of window + one step with the slots a
replay overwrites put back before the next, the held share, and the
comparison. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import types

import pytest
import torch

from fused4bit_tpu_torch.layers.kv_cache import QuantizedKVCache
from fused4bit_tpu_torch.models import K_EXAONE_236B, MODEL_CONFIGS, MoEConfig
from portbench import harness, hybrid
from portbench.drivers import decode_hybrid
from portbench.inputs import ModelSpec

ROOT = pathlib.Path(__file__).resolve().parents[1] / "portbench"
LAYERS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    cfg = json.loads((ROOT / "configs" / "k-exaone-236b-ep4-pg128.json").read_text())
    cfg.update(hidden_size=128, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
               vocab_size=256, intermediate_size=256, moe_intermediate_size=128, num_experts=4,
               num_local_experts=4, num_experts_per_tok=4, num_hidden_layers=LAYERS,
               sliding_windows=[8, 8, 8, 0] * 2, mlp_layer_types=["dense"] + ["sparse"] * 7,
               layer_types=cfg["layer_types"][:LAYERS], published={"num_experts": 16},
               registry="k-exaone-bench-tiny", first_expert=4)
    MODEL_CONFIGS["k-exaone-bench-tiny"] = dataclasses.replace(
        K_EXAONE_236B, name="k-exaone-bench-tiny", moe=MoEConfig("k-exaone-bench-tiny", 16, 128,
                                                                  128, 4),
        num_layers=LAYERS, num_heads=4, num_kv_heads=2, head_dim=64, vocab_size=256,
        hidden_size=128, windows=(8, 8, 8, 0) * 2, dense_ffn=256, shared_ffn=128)
    mix = json.loads((ROOT / "traffic" / "offline_isl2k_hybrid.json").read_text())
    mix.update(context=32, output_tokens=8, steps=4)
    spec = hybrid.HybridSpec.from_config(cfg)
    per_seq = hybrid.kv_bytes_per_sequence(spec, 40, 1)
    mix["batch_fill"] = {"card_bytes": hybrid.model_bytes(spec) + 16.5 * per_seq,
                         "utilization": 1.0, "reserve_bytes": 0, "multiple": 1}
    return types.SimpleNamespace(name="tiny", config=cfg, traffic=mix, limits={})


def test_replays_agree_and_the_reference_in_float32_judges_itself_zero():
    """Replays of the same positions give the same tokens (the ring slots a
    replay overwrote are put back), the program's gaps are small, and the
    plain reference standing in the program's place in float32 reads 0: its
    bias pass and its judging pass are one forward."""
    cell = tiny_cell()
    ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=3000000123,
                          seconds=0.5, trace=False, device=torch.device("cpu"),
                          t_start=time.perf_counter(),
                          controls={"f32_plain": decode_hybrid.PlainWitness(torch.float32)})
    out = decode_hybrid.run(ctx)
    b, steps = 16, 4
    assert out.attempted >= 2 * b * steps and out.checks["replays_differing"] == 0
    assert out.checks["mean_logit_gap"] < 0.05 and out.checks["mean_route_gap"] < 0.01
    assert all(v == 0 for k, v in out.controls["f32_plain"].items() if k != "gaps")
    assert len(out.route_gaps_by_layer["program"]) == LAYERS - 1


def test_the_balanced_bias_evens_the_loads():
    logits = torch.randn(512, 16, generator=torch.Generator().manual_seed(0)) * 2
    logits[:, :4] += 1.5                     # four favoured experts
    bias = hybrid.balanced_bias(logits, 4)
    idx = torch.topk(torch.sigmoid(logits) + bias, 4).indices.reshape(-1)
    load = torch.bincount(idx, minlength=16)
    before = torch.bincount(torch.topk(logits, 4).indices.reshape(-1), minlength=16)
    assert int(before.max() - before.min()) > 100
    assert int(load.max() - load.min()) <= 4, load


def test_ring_restore_puts_back_the_slots_a_replay_overwrites():
    """A ring of 8 + 2 slots after 32 positions; 5 steps from position 32
    overwrite 6 slots (a pair each side), which wrap the ring's end."""
    cache = QuantizedKVCache.init(3, 2, 64, 16, device="cpu", window=8, max_tokens=1)
    gen = torch.Generator().manual_seed(1)
    kv = [torch.randn(3, 2, 33, 16, generator=gen) for _ in range(2)]
    cache.append(kv[0][:, :, :32], kv[1][:, :, :32], start=torch.zeros(3, dtype=torch.int32))
    kept = [getattr(cache, f).clone() for f in cache._FIELDS[:6]]
    restore = decode_hybrid.RingRestore((cache,), 33, 5)
    for p in range(33, 38):
        cache.append(*(torch.randn(3, 2, 1, 16, generator=gen) for _ in range(2)),
                     start=torch.full((3,), p, dtype=torch.int32))
    assert any(not torch.equal(getattr(cache, f), k) for f, k in zip(cache._FIELDS, kept))
    restore()
    assert all(torch.equal(getattr(cache, f), k) for f, k in zip(cache._FIELDS, kept))
