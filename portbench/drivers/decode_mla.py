"""Driver ``decode_mla``: the ``decode`` driver's offline batched generation,
replayed from one CUDA graph, for models with multi-head latent attention
over a latent cache (DeepSeek-V3's), leading dense layers, and MoE layers
with a sigmoid router limited to the best groups of experts, a shared
expert and a share of the experts (``mla.MLASpec``).

The port's model is the registry's entry (``configuration["registry"]`` in
``fused4bit_tpu_torch.models.MODEL_CONFIGS``), checked against the
configuration's published sizes and cut to the experts held here, built
through the port's own constructors from the seeded weights of ``mla``.
Each layer's cache is a latent cache from ``QuantizedTransformer.
init_cache`` of ``context + output_tokens`` positions. The batch is the
most sequences, in multiples of ``batch_fill.multiple``, whose latent caches
fit ``utilization`` of the card beside the weights and ``reserve_bytes``.

Set-up first runs the plain reference (``reference/deepseek_v3.py``) over
the first decode position of every sequence, which balances each router's
selection bias from its own forward as training leaves it
(``mla.balanced_bias``); the program is built with those biases, as with
the seeded weights. It then writes every layer's latent cache through its
own ``append``, a block of rows at a time, with the seeded c_KV and k_pe of
the ``context`` prompt positions (``mla.prefix_latent``), and captures and
replays ``bench.decode_loop`` as ``decode`` does, with hooks on the MoE
layers' routers. Every replay writes the same positions with the same
values, so nothing needs putting back. The window runs at least two
replays, however short, so that ``replays_differing`` always compares one.
``decode_tok_s`` and the traced run are ``decode``'s. The work a step needs
is counted by ``mla.step_work``; the readers of ``metrics/`` see a decode
run (``Observations.driver`` is ``decode``).

The standard error gets what the capture counted a step: K15's launches
(one a layer), the warpgroup body's share of the experts' launches, and
the share of the routed pairs that land on the held experts, from the
routes tapped in the replays.

Then the program is freed and the plain reference runs the replay's
positions of every sequence, teacher forced on the served tokens and the
program's experts, from the same seeded prompt cache. Compared:
``decode``'s four numbers (the route gap taken on the biased selection
scores inside the reference's best groups), ``early_route_gap``, the route
gap of the first ``EARLY_MOE_LAYERS`` MoE layers alone, and
``mean_group_gap``: by how much the group of each chosen expert scores
below the reference's ``topk_group``-th best group (0 inside). Controls
(``calibrate_mla``): a path of the program runs before it is freed, one
decode step at a time from caches seeded again, and is judged alike.
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
import sys
import time
from typing import List

import torch

from fused4bit_tpu_torch.layers.linear import DenseLinear, QuantizedLinear
from fused4bit_tpu_torch.layers.moe import MoEINT4
from fused4bit_tpu_torch.models import MODEL_CONFIGS, ModelConfig, QuantizedTransformer
from fused4bit_tpu_torch.models.transformer import DenseMLP, MLAttention, MoEBlock, TransformerBlock
from fused4bit_tpu_torch.ops import launch_counts

from portbench import card, correct, harness, inputs, mla, program, spans, trace
from portbench.drivers import decode, decode_hybrid
from portbench.mla import MLASpec
from portbench.roofline import Work

# MoE layers whose route gap ``early_route_gap`` averages: layers 3-6 of 61
EARLY_MOE_LAYERS = 4
# the fewest replays of the window: the first and one compared with it
MIN_REPLAYS = 2


def model_config(spec: MLASpec, cfg: dict) -> ModelConfig:
    """The registry's entry for the configuration, with the experts held
    here; raises where the registry's published sizes are not the file's."""
    base = MODEL_CONFIGS[cfg["registry"]]
    y = base.yarn
    have = (base.hidden, base.num_heads, base.q_lora_rank, base.kv_lora_rank, base.qk_nope_dim,
            base.qk_rope_dim, base.v_head_dim, base.vocab_size, base.num_layers,
            base.dense_layers, base.dense_ffn, base.moe.ffn_dim, base.shared_ffn,
            base.moe.num_experts, base.moe.top_k, base.n_group, base.topk_group,
            base.routed_scale, base.rope_theta, base.rms_eps, y.factor,
            y.original_max_position_embeddings, y.beta_fast, y.beta_slow, y.mscale,
            y.mscale_all_dim)
    want = (spec.hidden, spec.heads, spec.q_lora, spec.kv_lora, spec.qk_nope, spec.qk_rope,
            spec.v_dim, spec.vocab, spec.layers, spec.dense_layers, spec.dense_ffn, spec.moe_ffn,
            spec.shared_ffn, spec.router_experts, spec.top_k, spec.n_group, spec.topk_group,
            spec.routed_scale, spec.rope_theta, spec.rms_eps, spec.yarn_factor,
            spec.yarn_original, spec.yarn_beta_fast, spec.yarn_beta_slow, spec.yarn_mscale,
            spec.yarn_mscale_all_dim)
    if have != want:
        raise ValueError(f"the registry's {base.name} is {have}, the configuration {want}")
    return dataclasses.replace(base, first_expert=spec.first_expert, held_experts=spec.experts)


def build(spec: MLASpec, mcfg: ModelConfig, seed: int, device,
          biases: List[torch.Tensor]) -> QuantizedTransformer:
    """The model from the seeded weights, one tensor at a time: every
    projection, expert stack, shared expert, dense layer and the lm_head
    quantized in the configuration's granularity, W_UKV absorbed
    (``MLAttention.absorbed``); the routers bf16 ``DenseLinear``s with the
    float32 selection biases ``biases``, one a MoE layer in order; norms 1."""
    kw = {} if spec.granularity == "per_row" else dict(granularity=spec.granularity,
                                                       group_size=spec.group_size)

    def linear(w):
        return QuantizedLinear.from_dense(w, **kw)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    blocks = []
    for layer in range(spec.layers):
        def w(name):
            return mla.layer_weight(spec, seed, layer, name, device)

        def mlp(prefix, span_name):
            return DenseMLP(linear(w(f"{prefix}_gate")), linear(w(f"{prefix}_up")),
                            linear(w(f"{prefix}_down")), span_name=span_name)

        attn = MLAttention(linear(w("wq_a")), ones(spec.q_lora), linear(w("wq_b")),
                           linear(w("wkv_a")), ones(spec.kv_lora),
                           *MLAttention.absorbed(w("kv_b"), spec.heads, spec.qk_nope),
                           linear(w("wo")), num_heads=spec.heads, qk_nope_dim=spec.qk_nope,
                           qk_rope_dim=spec.qk_rope, v_head_dim=spec.v_dim,
                           rope_theta=mcfg.rope_theta, yarn=mcfg.yarn, rms_eps=mcfg.rms_eps)
        if layer < mcfg.dense_layers:
            ffn = mlp("dense", "mlp.dense")
        else:
            ffn = MoEBlock(DenseLinear(w("router").to(torch.bfloat16)),
                           *(MoEINT4.from_dense(w(n), **kw) for n in ("w_gate", "w_up", "w_down")),
                           num_experts=mcfg.moe.num_experts, top_k=mcfg.moe.top_k,
                           router_bias=biases[layer - mcfg.dense_layers].to(
                               device=device, dtype=torch.float32),
                           routed_scale=mcfg.routed_scale, first_expert=mcfg.first_expert,
                           shared=mlp("shared", "moe.shared"), n_group=mcfg.n_group,
                           topk_group=mcfg.topk_group)
        blocks.append(TransformerBlock(ones(spec.hidden), attn, ones(spec.hidden), ffn,
                                       rms_eps=mcfg.rms_eps))
    return QuantizedTransformer(inputs.embedding(spec, seed, device), blocks, ones(spec.hidden),
                                linear(inputs.lm_head(spec, seed, device)), rms_eps=mcfg.rms_eps)


def batch(spec: MLASpec, mix: dict) -> int:
    """``decode.batch``'s rule with the latent cache's bytes a position."""
    fill = mix["batch_fill"]
    per_seq = mla.kv_bytes_per_sequence(spec, mix["context"] + mix["output_tokens"])
    room = fill["utilization"] * fill["card_bytes"] - mla.model_bytes(spec) \
        - fill["reserve_bytes"]
    b = int(room // per_seq) // fill["multiple"] * fill["multiple"]
    if b < 1:
        raise ValueError(f"no sequence of the mix {mix['name']} fits beside the weights")
    return b


def seed_caches(spec: MLASpec, caches, seed: int, context: int, std: float, device) -> None:
    """Write the ``context`` prompt positions' seeded c_KV and k_pe into every
    layer's latent cache through its ``append``, a block of rows at a time."""
    for rows in decode.row_blocks(caches[0].lengths.shape[0]):
        zeros = torch.zeros((len(rows),), dtype=torch.int32, device=device)
        for layer, cache in enumerate(decode_hybrid.cache_rows(caches, rows)):
            c, pe = mla.prefix_latent(spec, seed, layer, rows, context, std, device)
            cache.append(c, pe, start=zeros)
            del c, pe


def reference_biases(mod, spec: MLASpec, seed: int, device, tok0: torch.Tensor, start: int,
                     prefix, blocks) -> List[torch.Tensor]:
    """Each MoE layer's selection bias, balanced by the plain reference's
    own forward of ``tok0`` at position ``start`` over every sequence."""
    ref = mod.Reference(spec, seed, device)
    ref.run([mod.Job(tok0[rows.start:rows.stop].cpu(), start=start, served=None, routes=None,
                     prefix=lambda layer, rows=rows: prefix(layer, rows)) for rows in blocks])
    return [b.cpu() for b in ref.router_biases]


def run(ctx: harness.Context) -> harness.Outcome:
    mix, dev, seed = ctx.cell.traffic, ctx.device, ctx.seed
    spec = MLASpec.from_config(ctx.cell.config)
    mcfg = model_config(spec, ctx.cell.config)
    b, ctxlen, steps = batch(spec, mix), mix["context"], mix["steps"]
    max_seq = ctxlen + mix["output_tokens"]
    blocks = decode.row_blocks(b)
    mod = importlib.import_module(f"portbench.reference.{ctx.cell.config['reference']}")

    def prefix(layer, rows):
        return mla.prefix_latent(spec, seed, layer, rows, ctxlen, mix["kv_std"], dev)

    g = inputs.generator(seed, "tok0", device=dev)
    tok0 = torch.randint(1, spec.vocab, (b, 1), generator=g, device=dev, dtype=torch.int32)
    pos0 = torch.full((b, 1), ctxlen, dtype=torch.int32, device=dev)
    biases = reference_biases(mod, spec, seed, dev, tok0, ctxlen, prefix, blocks)
    harness.free(dev)
    model = build(spec, mcfg, seed, dev, biases)
    caches = model.init_cache(mcfg, b, max_seq)
    seed_caches(spec, caches, seed, ctxlen, mix["kv_std"], dev)

    tap = decode_hybrid.Tap(model, decode._Kept())
    before = launch_counts()
    loop = (decode._Graph if dev.type == "cuda" else decode._Eager)(model, caches, tok0, pos0,
                                                                  steps, tap)

    with card.Sampler() as sampled:
        t0 = time.perf_counter()
        first = loop()
        # the warm loop and the capture ran the loop's Python on the card (a
        # replay runs none); on the CPU the first eager loop did
        counted = decode_hybrid._counted(before, launch_counts(),
                                         steps * (2 if dev.type == "cuda" else 1))
        replays, differing = 1, 0
        while replays < MIN_REPLAYS or time.perf_counter() < t0 + ctx.seconds:
            differing += int(not torch.equal(loop(), first))
            replays += 1
        window = time.perf_counter() - t0
    end_to_end = {"decode_tok_s": b * steps * replays / window, "setup_s": t0 - ctx.t_start}

    chosen = decode_hybrid.choices(model, spec, decode_hybrid.router_outputs(
        tap.sink, spec.moe_layers(), steps))
    held = decode_hybrid.held_counts(spec, chosen)                     # [MoE layers, steps, E]
    share = float(held.sum()) / chosen.numel()
    print(f"decode_mla: batch {b}; held experts get {100 * share:.2f} % of the routed pairs "
          f"({float(held.float().mean()):.1f} rows an expert a step); a step launched "
          f"{counted['mla_attention']:g} K15 calls, "
          f"{counted['grouped_int4_matmul_per_group_wg']:g} of "
          f"{counted['grouped_int4_matmul_per_group']:g} K13 calls on the warpgroup body",
          file=sys.stderr, flush=True)
    obs = harness.Observations(driver="decode")
    if ctx.trace:
        per_step = [mla.step_work(spec, b, ctxlen + s, held[:, s].tolist()) for s in range(steps)]
        obs.work = {k: Work(sum(w[k].flops for w in per_step) / steps,
                            sum(w[k].bytes for w in per_step) / steps) for k in per_step[0]}
        times = [loop.device_ms() for _ in range(3)]
        if times[0] is not None:
            obs.device_ms_per_step = statistics.median(times) / steps
        reps = mix["traced_replays"]
        obs.trace = trace.record(lambda: [loop() for _ in range(reps)])
        obs.steps_traced = reps * steps
        obs.own_kernels = trace.csrc_kernels(program.csrc())
        by_span = spans.ms_per_step(obs.trace, obs.steps_traced) or {}
        print("decode_mla: device ms a step by span (own nodes): " + ", ".join(
            f"{k or 'all'} {v:.3f}" for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])),
            file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tap.detach()
    chosen = chosen.transpose(1, 2).cpu()                              # [MoE layers, B, steps, k]

    served = first[:, :, 0].t()                                        # [B, steps]
    fed = torch.cat([tok0.cpu(), served[:, :-1]], dim=1).long()
    ctrl = {}
    for name, fn in ctx.controls.items():
        seed_caches(spec, caches, seed, ctxlen, mix["kv_std"], dev)
        ctrl[name] = fn(model, caches, fed.to(dev), ctxlen)
    del loop, caches, model, tap
    harness.free(dev)
    t_ref = time.perf_counter()

    ref = mod.Reference(spec, seed, dev, biases)
    runs = {"program": (served, chosen), **ctrl}
    jobs = [mod.Job(fed[rows.start:rows.stop], start=ctxlen, served=r[0][rows.start:rows.stop],
                    routes=r[1][:, rows.start:rows.stop],
                    prefix=lambda layer, rows=rows: prefix(layer, rows))
            for r in runs.values() for rows in blocks]
    done = ref.run(jobs)
    judged, by_layer = {}, {}
    for i, name in enumerate(runs):
        part = done[i * len(blocks):(i + 1) * len(blocks)]
        gaps = torch.cat([j.gaps for j in part])                       # [B, steps]
        per_layer = [torch.cat([j.route_gaps[m] for j in part])
                     for m in range(len(part[0].route_gaps))]
        group_gaps = torch.cat([g for j in part for g in j.group_gaps])
        early = float(torch.cat(per_layer[:EARLY_MOE_LAYERS]).mean())
        judged[name] = {**correct.compared(gaps, float(torch.cat(per_layer).mean())),
                        "early_route_gap": early, "mean_group_gap": float(group_gaps.mean()),
                        "gaps": gaps}
        by_layer[name] = [float(g.mean()) for g in per_layer]
    prog = judged.pop("program")
    gaps = prog.pop("gaps")
    out = harness.Outcome(end_to_end=end_to_end, obs=obs, attempted=b * steps * replays,
                          failed=0, checks={**prog, "replays_differing": differing},
                          memory_peak_bytes=peak, gaps=gaps, controls=judged,
                          card=sampled.result, reference_s=time.perf_counter() - t_ref)
    out.route_gaps_by_layer = by_layer       # for the calibration's record
    return out
