"""The benchmark's ``decode_mla`` driver, its plain reference and its work
functions on the CPU, at a tiny DeepSeek-V3-shaped configuration: 5 layers
(2 dense, 3 MoE), hidden 256, 4 latent-attention heads over a latent of 256
and a RoPE key of 16 with YaRN, 4 of 16 experts held (one group of 4),
top-4 inside the 2 best of 4 groups under a sigmoid router.

The driver runs its whole path eagerly here (no CUDA graph): the
reference's bias pass, the latent caches seeded from the seed, the held
share, the controls and the comparison. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import types

import pytest
import torch

from fused4bit_tpu_torch.models import DEEPSEEK_V3_671B, MODEL_CONFIGS, MoEConfig, YaRN
from fused4bit_tpu_torch.utils.profiling import SpanMap
from portbench import calibrate_mla, harness, mla, registry, spans
from portbench.drivers import decode_mla
from portbench.inputs import ModelSpec
from portbench.reference import deepseek_v3 as bench_ref
from portbench.trace import DeviceOp, Trace

ROOT = pathlib.Path(__file__).resolve().parents[1] / "portbench"
CELL = "deepseek-v3-ep8-pg128.offline_isl2k_mla"
B, STEPS = 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    cfg = json.loads((ROOT / "configs" / "deepseek-v3-ep8-pg128.json").read_text())
    cfg.update(hidden_size=256, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=256,
               kv_lora_rank=256, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=64,
               vocab_size=256, intermediate_size=256, moe_intermediate_size=256,
               n_routed_experts=4, num_local_experts=4, num_experts_per_tok=4, n_group=4,
               topk_group=2, num_hidden_layers=5, first_k_dense_replace=2,
               published={"n_routed_experts": 16}, registry="deepseek-v3-bench-tiny",
               first_expert=4, rope_scaling={**cfg["rope_scaling"], "factor": 4,
                                             "original_max_position_embeddings": 16})
    MODEL_CONFIGS["deepseek-v3-bench-tiny"] = dataclasses.replace(
        DEEPSEEK_V3_671B, name="deepseek-v3-bench-tiny",
        moe=MoEConfig("deepseek-v3-bench-tiny", 16, 256, 256, 4), num_layers=5, num_heads=4,
        num_kv_heads=4, head_dim=48, vocab_size=256, hidden_size=256, dense_layers=2,
        dense_ffn=256, shared_ffn=256, n_group=4, topk_group=2, q_lora_rank=256,
        kv_lora_rank=256, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=64,
        yarn=YaRN(4.0, 16, 32.0, 1.0, 1.0, 1.0))
    mix = json.loads((ROOT / "traffic" / "offline_isl2k_mla.json").read_text())
    mix.update(context=32, output_tokens=8, steps=STEPS)
    spec = mla.MLASpec.from_config(cfg)
    mix["batch_fill"] = {"card_bytes": mla.model_bytes(spec)
                         + (B + 0.5) * mla.kv_bytes_per_sequence(spec, 40),
                         "utilization": 1.0, "reserve_bytes": 0, "multiple": 1}
    return types.SimpleNamespace(name="tiny", config=cfg, traffic=mix, limits={})


def test_two_replays_agree_whatever_the_window_and_the_controls_part_from_the_program():
    """A window of 0 s still runs two replays and compares them; the
    program's gaps are small; the w4a8 control parts from the reference by
    more, the witness without mscale^2 by far more, and the witness that
    ignores the groups chooses experts outside the reference's best
    groups."""
    cell = tiny_cell()
    controls = {n: calibrate_mla.stepwise(f) for n, f in calibrate_mla.CONVERTERS.items()}
    ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=3000000123,
                          seconds=0.0, trace=False, device=torch.device("cpu"),
                          t_start=time.perf_counter(), controls=controls)
    out = decode_mla.run(ctx)
    assert out.attempted == 2 * B * STEPS and out.checks["replays_differing"] == 0
    c = out.checks
    assert c["mean_logit_gap"] < 0.02 and c["mean_route_gap"] < 0.01
    assert c["mean_group_gap"] < 0.005 and len(out.route_gaps_by_layer["program"]) == 3
    assert out.controls["w4a8"]["mean_logit_gap"] > c["mean_logit_gap"]
    assert out.controls["no_mscale"]["mean_logit_gap"] > 10 * c["mean_logit_gap"]
    assert out.controls["no_groups"]["mean_group_gap"] > 10 * c["mean_group_gap"]


def test_the_reference_judges_its_own_choices_zero():
    """The plain reference's own first choices and experts, judged by the
    same reference, read 0 on every compared number."""
    cell = tiny_cell()
    spec = mla.MLASpec.from_config(cell.config)
    seed, ctxlen = 11, 32
    tokens = torch.randint(1, spec.vocab, (8, 3), generator=torch.Generator().manual_seed(0))
    biases = [torch.randn(16, generator=torch.Generator().manual_seed(i)) * 0.1 for i in range(3)]

    def prefix(layer):
        return mla.prefix_latent(spec, seed, layer, range(0, 8), ctxlen, 1.0, "cpu")

    own = bench_ref.DeepSeekV3(spec, seed, "cpu", biases).run(
        [bench_ref.Job(tokens, ctxlen, None, None, prefix)])[0]
    judged = bench_ref.DeepSeekV3(spec, seed, "cpu", biases).run(
        [bench_ref.Job(tokens, ctxlen, own.firsts, own.chosen, prefix)])[0]
    assert float(judged.gaps.abs().max()) == 0.0
    assert all(float(g.max()) == 0.0 for g in judged.route_gaps + judged.group_gaps)


@pytest.mark.parametrize("seed", [1, 2])
def test_the_benchmark_references_two_forms_agree_in_float32(seed):
    """The absorbed attention the benchmark's reference runs equals the
    published form (k_nope and v per head) in float32, to its rounding."""
    cell = tiny_cell()
    spec = mla.MLASpec.from_config(cell.config)
    g = torch.Generator().manual_seed(seed)
    b, t, s = 3, 4, 40
    q_nope = torch.randn((b, t, spec.heads, spec.qk_nope), generator=g)
    q_pe = torch.randn((b, t, spec.heads, spec.qk_rope), generator=g)
    c = torch.randn((b, s, spec.kv_lora), generator=g)
    k_pe = torch.randn((b, s, spec.qk_rope), generator=g)
    uk, uv = bench_ref.absorbed_weights(spec, torch.randn(
        (spec.heads * (spec.qk_nope + spec.v_dim), spec.kv_lora), generator=g) * 0.06)
    pos = torch.arange(s - t, s)
    mask = torch.arange(s)[None, :] <= pos[:, None]
    with bench_ref.no_tf32():
        a = bench_ref.attention(spec, q_nope, q_pe, c, k_pe, uk, uv, mask, absorbed=True)
        p = bench_ref.attention(spec, q_nope, q_pe, c, k_pe, uk, uv, mask, absorbed=False)
    assert float((a - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_the_group_aware_bias_evens_the_loads():
    cell = tiny_cell()
    spec = mla.MLASpec.from_config(cell.config)
    logits = torch.randn(512, 16, generator=torch.Generator().manual_seed(0)) * 2
    logits[:, :4] += 1.5                     # one favoured group
    bias = mla.balanced_bias(logits, spec)
    idx = mla.group_limited_topk(torch.sigmoid(logits) + bias, 4, 4, 2).indices.reshape(-1)
    load = torch.bincount(idx, minlength=16)
    before = torch.bincount(mla.group_limited_topk(torch.sigmoid(logits), 4, 4, 2)
                            .indices.reshape(-1), minlength=16)
    assert int(before.max() - before.min()) > 200
    assert int(load.max() - load.min()) <= 16, load


def test_the_cell_at_published_widths_holds_256_sequences_and_its_work():
    """The cell's batch rule gives 256 sequences of 52.0 MB of latent cache
    beside 57.1 GB of weights; the kernel's work at 2048 positions is bound
    by its operations (about 710 a byte)."""
    cell = registry.cell(CELL)
    spec = mla.MLASpec.from_config(cell.config)
    assert (spec.heads, spec.kv_lora, spec.qk_rope, spec.layers, spec.router_experts,
            spec.experts, spec.n_group, spec.topk_group) == (128, 512, 64, 61, 256, 32, 8, 4)
    assert decode_mla.batch(spec, cell.traffic) == 256
    assert mla.kv_bytes_per_sequence(spec, 2176) == 61 * 2176 * 392
    assert 57.0e9 < mla.model_bytes(spec) < 57.2e9
    w = mla.kernel_work(spec, [2049] * 256)
    assert w.flops / w.bytes > 500 and w.bound_s() == w.flops / 989e12
    assert set(cell.limits) == {"mean_logit_gap", "worst_seq_logit_gap", "mean_route_gap",
                                "early_route_gap", "mean_group_gap", "replays_differing"}
    assert {"attention.mla.kernel_roofline.decode", "attention.mla.span_roofline.decode",
            "step_mfu.decode"} <= set(cell.per_layer)


def test_the_kernel_metric_reads_attention_kernel_spans_inside_attention_mla(monkeypatch):
    """A replay of 6 nodes: an ``attention.kernel`` span inside
    ``attention.mla`` (2 nodes) is counted, one outside it is not."""
    m = SpanMap(capture_id=1)
    m.spans = [("attention.mla", -1), ("attention.kernel", 0), ("linear", 0),
               ("attention.kernel", -1)]
    m.runs = [(0, 1, 2), (1, 3, 1), (3, 4, 0), (4, 6, 3)]
    ops = [DeviceOp(f"k{i}", "kernel", 10.0 * i, 1000.0 * (i + 1)) for i in range(6)]
    tr = Trace(ops, [(0.0, 1.0, "cudaGraphLaunch")], (0.0, 100.0))
    monkeypatch.setattr(spans, "program_maps", lambda: [m])
    obs = harness.Observations(driver="decode", trace=tr, steps_traced=1)
    assert mla.span_ms_per_step(obs, "attention.kernel", "attention.mla") == pytest.approx(5.0)
    readers = registry.metric_readers()
    obs.work = {"mla_kernel": mla.Work(flops=989e12 * 1e-3), "mla_span": mla.Work(flops=989e9)}
    assert readers["attention.mla.kernel_roofline.decode"].read(obs) == pytest.approx(20.0)
    # attention.mla with its children: nodes 0-3, 10 ms
    assert readers["attention.mla.span_roofline.decode"].read(obs) == pytest.approx(10.0)
