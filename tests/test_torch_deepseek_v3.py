"""DeepSeek-V3-shaped decoders in the port against the plain reference
``reference_models/deepseek_v3.py``, on the CPU at a tiny size.

The tiny config keeps every mechanism of DeepSeek-V3: multi-head latent
attention (4 heads; a q latent of 64, a cached latent of 256 beside a RoPE
key of 16; heads of 32 + 16 for q and k, 32 for v) with YaRN RoPE (x4 over
16 original positions, so that the ramp and the softmax's mscale^2 both
act), two dense layers, then three MoE layers of 16 experts in 4 groups,
top-4 inside the 2 best groups under a sigmoid router with a selection bias
and a routed scale, a shared expert, and a layer that holds experts 4-7 of
the 16 (one group), as one card of four would. W_UV is per group of 128
along the latent (K13's plain version), W_UK^T per row (K2's).

The reference computes in float32 on the port's INT4 grid values. With
float32 activations the port computes the same arithmetic in another form
(the absorbed one, through the latent cache), so the two agree to
float32's rounding; with bf16 activations, as served, each rounding can
flip an INT4 latent code, so that comparison only bounds the error.
Routing follows the port's own choices (the reference checks them as
margins), because with random weights a near-tied selection flips on
rounding.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from fused4bit_tpu_torch.layers import LatentKVCache
from fused4bit_tpu_torch.layers.moe import MoEINT4, sigmoid_route
from fused4bit_tpu_torch.models import (
    DEEPSEEK_V3_671B, DenseMLP, MLAttention, ModelConfig, MoEBlock, MoEConfig,
    QuantizedTransformer, YaRN, yarn_inv_freq,
)
from fused4bit_tpu_torch.quant.core import dequantize
from fused4bit_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from reference_models import deepseek_v3 as ref

# float32 activations: the same float32 arithmetic on the same INT4 weights
# and latent codes, the attention in the absorbed form on the port's side
# and the published one on the reference's; sums in other orders (logits of
# unit scale: 1e-5 at most over the seeds tried).
LOGIT_TOL = 2e-3
ROUTE_TOL = 1e-5
# bf16 activations: the relative RMS error of the logits. bf16 roundings flip
# INT4 latent codes (a step is 1/15 of a vector's range): 0.13-0.15 over
# four seeds, against 0.29-0.35 for the same bf16 model with YaRN's mscale^2
# left out of the softmax scale. The mean route gap: 0.003-0.006.
BF16_REL_TOL = 0.2
BF16_ROUTE_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw) -> ModelConfig:
    base = ModelConfig(
        name="deepseek-v3-tiny", moe=MoEConfig("deepseek-v3-tiny", 16, 96, 64, 4),
        num_layers=5, num_heads=4, num_kv_heads=4, head_dim=48, vocab_size=256,
        max_seq_len=64, rope_theta=10000.0, rms_eps=1e-6, hidden_size=96,
        dense_layers=2, dense_ffn=128, shared_ffn=64, router="sigmoid", routed_scale=2.5,
        n_group=4, topk_group=2, q_lora_rank=64, kv_lora_rank=256,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        yarn=YaRN(factor=4.0, original_max_position_embeddings=16, beta_fast=32.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
        first_expert=4, held_experts=4)
    return dataclasses.replace(base, **kw)


def build(cfg: ModelConfig, seed: int = 0, dtype=torch.float32) -> QuantizedTransformer:
    g = torch.Generator().manual_seed(seed)
    model = QuantizedTransformer.init(cfg, generator=g, device="cpu", dtype=dtype)
    for blk in model.blocks:
        if isinstance(blk.moe, MoEBlock):    # a bias large enough to move some selections
            blk.moe.router_bias = torch.randn(cfg.moe.num_experts, generator=g) * 0.1
    return model


def geometry(cfg: ModelConfig, dtype=torch.float32) -> ref.Geometry:
    y = cfg.yarn
    return ref.Geometry(
        hidden=cfg.hidden, heads=cfg.num_heads, q_lora=cfg.q_lora_rank,
        kv_lora=cfg.kv_lora_rank, qk_nope=cfg.qk_nope_dim, qk_rope=cfg.qk_rope_dim,
        v_dim=cfg.v_head_dim, vocab=cfg.vocab_size, layers=cfg.num_layers,
        dense_layers=cfg.dense_layers, dense_ffn=cfg.dense_ffn, moe_ffn=cfg.moe.ffn_dim,
        shared_ffn=cfg.shared_ffn, num_experts=cfg.moe.num_experts,
        first_expert=cfg.first_expert, held_experts=cfg.held, top_k=cfg.moe.top_k,
        n_group=cfg.n_group, topk_group=cfg.topk_group, routed_scale=cfg.routed_scale,
        rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps, yarn_factor=y.factor,
        yarn_original=y.original_max_position_embeddings, yarn_beta_fast=y.beta_fast,
        yarn_beta_slow=y.beta_slow, yarn_mscale=y.mscale, yarn_mscale_all_dim=y.mscale_all_dim,
        activations=dtype)


def weights(model: QuantizedTransformer) -> dict:
    """The port's weights for the reference: each INT4 weight's grid values
    (the reference's own quantizer gives them back unchanged), W_UK and W_UV
    as the grid values they are, the rest as served."""
    def dq(mod):
        return dequantize(mod.weight, dtype=torch.float32)

    out = {"embed": model.embed.float(), "final_norm": model.final_norm.float(),
           "lm_head": dq(model.lm_head)}
    for i, blk in enumerate(model.blocks):
        a = blk.attn
        out.update({f"{i}.wq_a": dq(a.wq_a), f"{i}.q_norm": a.q_norm.float(),
                    f"{i}.wq_b": dq(a.wq_b), f"{i}.wkv_a": dq(a.wkv_a),
                    f"{i}.kv_norm": a.kv_norm.float(), f"{i}.w_uk": dq(a.w_uk).transpose(1, 2),
                    f"{i}.w_uv": dq(a.w_uv), f"{i}.wo": dq(a.wo),
                    f"{i}.attn_norm": blk.attn_norm.float(), f"{i}.ffn_norm": blk.moe_norm.float()})
        f = blk.moe
        if isinstance(f, DenseMLP):
            out.update({f"{i}.dense_gate": dq(f.w_gate), f"{i}.dense_up": dq(f.w_up),
                        f"{i}.dense_down": dq(f.w_down)})
            continue
        s = f.shared
        out.update({f"{i}.router": f.router.weight.float(), f"{i}.router_bias": f.router_bias,
                    f"{i}.w_gate": dq(f.w_gate), f"{i}.w_up": dq(f.w_up),
                    f"{i}.w_down": dq(f.w_down), f"{i}.shared_gate": dq(s.w_gate),
                    f"{i}.shared_up": dq(s.w_up), f"{i}.shared_down": dq(s.w_down)})
    return out


class Routes:
    """The experts the port chose at every MoE layer, in call order, read
    from each router's output by the port's own rule."""

    def __init__(self, model: QuantizedTransformer):
        self.calls = {}
        for i, blk in enumerate(model.blocks):
            if isinstance(blk.moe, MoEBlock):
                blk.moe.router.register_forward_hook(self._hook(i, blk.moe))

    def _hook(self, layer, moe):
        def hook(mod, args, out):
            idx = moe.route(out).expert_indices
            self.calls.setdefault(layer, []).append(idx.reshape(args[0].shape[0], -1))
        return hook

    def tensor(self, layers: int, batch: int) -> torch.Tensor:
        out = [None] * layers
        for layer, parts in self.calls.items():
            k = parts[0].shape[-1]
            out[layer] = torch.cat([p.reshape(batch, -1, k) for p in parts], dim=1)
        fill = next(o for o in out if o is not None)
        return torch.stack([o if o is not None else torch.zeros_like(fill) for o in out])


def forward_steps(model, cfg, tokens, chunks):
    b, t = tokens.shape
    routes = Routes(model)
    caches = model.init_cache(cfg, b, cfg.max_seq_len)
    out, p = [], 0
    for n in chunks:
        logits, caches = model(tokens[:, p:p + n], caches, torch.arange(p, p + n))
        out.append(logits.float())
        p += n
    assert p == t
    return torch.cat(out, dim=1), routes.tensor(cfg.num_layers, b), caches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_then_decode_through_the_latent_cache_matches_reference(dtype):
    """A 10-token prefill, then 12 decode steps past YaRN's 16 original
    positions, against the reference's full forward."""
    cfg = tiny_cfg()
    model = build(cfg, dtype=dtype)
    tokens = torch.randint(1, cfg.vocab_size, (2, 22), generator=torch.Generator().manual_seed(1))
    logits, routes, caches = forward_steps(model, cfg, tokens, [10] + [1] * 12)
    assert all(isinstance(c, LatentKVCache) and int(c.lengths[0]) == 22 for c in caches)
    want, gaps, group_gaps = ref.forward(geometry(cfg, dtype), weights(model), tokens,
                                         routes=routes)
    gaps, group_gaps = torch.cat(gaps), torch.cat(group_gaps)
    if dtype == torch.bfloat16:
        rel = float((logits - want).norm() / want.norm())
        assert rel <= BF16_REL_TOL and float(gaps.mean()) <= BF16_ROUTE_TOL, (rel, gaps.mean())
        return
    assert float(gaps.max()) <= ROUTE_TOL and float(group_gaps.max()) <= ROUTE_TOL
    diff = float((logits - want).abs().max())
    assert diff <= LOGIT_TOL, f"max |logit - reference| = {diff}"


def test_chunked_prefill_matches_reference():
    cfg = tiny_cfg()
    model = build(cfg, seed=3)
    tokens = torch.randint(1, cfg.vocab_size, (3, 20), generator=torch.Generator().manual_seed(4))
    logits, routes, _ = forward_steps(model, cfg, tokens, [4, 8, 3, 5])
    want, gaps, _ = ref.forward(geometry(cfg), weights(model), tokens, routes=routes)
    assert float(torch.cat(gaps).max()) <= ROUTE_TOL
    assert float((logits - want).abs().max()) <= LOGIT_TOL


@pytest.mark.parametrize("seed", [5, 6])
def test_the_absorbed_and_published_forms_of_the_reference_agree(seed):
    """The reference's two forms of the attention, in float32 (only the
    order of the sums differs), on every layer's weights and the same
    input: the benchmark's reference runs the absorbed one. Layer by layer,
    since the next layer rounds c_KV to INT4, and a code at a rounding
    boundary may round apart between the forms and carry into later layers
    (outputs of about 3.5 agree to 2.3e-6 at seeds 5-10)."""
    cfg = tiny_cfg()
    g = geometry(cfg)
    w = ref.quantized(g, weights(build(cfg, seed=seed)))
    x = torch.randn((2, 18, cfg.hidden), generator=torch.Generator().manual_seed(seed))
    with ref.no_tf32():
        for layer in range(cfg.num_layers):
            lw = {n.split(".", 1)[1]: v for n, v in w.items() if n.startswith(f"{layer}.")}
            plain = ref._attention(g, lw, x, absorbed=False)
            absorbed = ref._attention(g, lw, x, absorbed=True)
            assert float((plain - absorbed).abs().max()) <= 1e-4, layer


def test_the_softmax_scale_holds_yarns_mscale_squared():
    """192^-0.5 (0.1 ln 40 + 1)^2 at DeepSeek-V3's widths, and the tiny
    model's attention differs without it."""
    cfg = DEEPSEEK_V3_671B
    mscale = 0.1 * math.log(40.0) + 1.0
    g = geometry(tiny_cfg())
    assert g.softmax_scale == pytest.approx(48 ** -0.5 * (0.1 * math.log(4.0) + 1.0) ** 2)
    attn = MLAttention.init(dataclasses.replace(tiny_cfg(), yarn=cfg.yarn), 96, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert attn.softmax_scale == pytest.approx(48 ** -0.5 * mscale ** 2)
    assert attn.rope_factor == 1.0


def test_yarn_frequencies_follow_the_closed_form():
    """DeepSeek-V3's RoPE: theta^(-2i/64), divided by 40 below the
    correction range of 32..1 rotations over 4096 positions, a linear ramp
    between."""
    dim, theta, y = 64, 10000.0, DEEPSEEK_V3_671B.yarn
    got = yarn_inv_freq(dim, theta, y)
    base = theta ** (-np.arange(0, dim, 2) / dim)

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    for i in range(dim // 2):
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want = base[i] / 40 * ramp + base[i] * (1 - ramp)
        assert float(got[i]) == pytest.approx(want, rel=1e-6)
    assert torch.equal(yarn_inv_freq(dim, theta, None),
                       1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))


def test_group_limited_routing_against_brute_force():
    """16 experts in 4 groups, top-4 inside the 2 best: every row's choice
    equals the best of all selections that stay inside 2 groups chosen by
    their top-2 sums; at one group the plain biased top-k."""
    g = torch.Generator().manual_seed(8)
    logits = torch.randn((12, 16), generator=g) * 2
    bias = torch.randn(16, generator=g) * 0.3
    r = sigmoid_route(logits, bias, 4, 16, scale=2.5, n_group=4, topk_group=2)
    s = torch.sigmoid(logits)
    b = s + bias
    for row in range(12):
        sums = [float(torch.topk(b[row, 4 * i:4 * i + 4], 2).values.sum()) for i in range(4)]
        groups = sorted(range(4), key=lambda i: -sums[i])[:2]
        pool = [e for e in range(16) if e // 4 in groups]
        best = max(itertools.combinations(pool, 4), key=lambda c: sum(float(b[row, e]) for e in c))
        assert sorted(r.expert_indices[row].tolist()) == sorted(best)
        w = s[row, r.expert_indices[row].long()]
        torch.testing.assert_close(r.expert_weights[row], w / w.sum() * 2.5)
    plain = sigmoid_route(logits, bias, 4, 16, n_group=1, topk_group=1)
    assert torch.equal(plain.expert_indices.long(), torch.topk(b, 4, dim=-1).indices)
    assert torch.equal(plain.expert_indices, sigmoid_route(logits, bias, 4, 16).expert_indices)


def test_the_latent_cache_appends_slices_resets_and_merges():
    g = torch.Generator().manual_seed(9)
    cache = LatentKVCache.init(3, 40, 32, 8, device="cpu")
    assert cache.max_seq == 64 and cache.nbytes == 3 * 64 * (16 + 8 + 16)
    c = torch.randn((3, 7, 32), generator=g)
    pe = torch.randn((3, 7, 8), generator=g).bfloat16()
    cache.append(c, pe, start=torch.tensor([0, 3, 10], dtype=torch.int32))
    assert cache.lengths.tolist() == [7, 10, 17]
    cd, ped = cache.dequantize()
    for row, start in enumerate((0, 3, 10)):
        # one INT4 step is 1/15 of the vector's range
        step = (c[row].amax(-1) - c[row].amin(-1)) / 15
        assert ((cd[row, start:start + 7] - c[row]).abs() <= step[:, None] / 2 + 1e-6).all()
        assert torch.equal(ped[row, start:start + 7], pe[row].float())
    part = cache.slice_slot(1)
    part.append(torch.ones((1, 1, 32)), torch.ones((1, 1, 8)))
    assert int(cache.lengths[1]) == 11 and torch.equal(cache.k_pe[1, 10], torch.ones(8).bfloat16())
    assert cache.merge_slot(part, 1) is cache
    other = LatentKVCache.init(1, 64, 32, 8, device="cpu")
    other.append(c[:1], pe[:1])
    cache.merge_slot(other, 2)
    assert int(cache.lengths[2]) == 7 and torch.equal(cache.c_packed[2], other.c_packed[0])
    cache.reset_slot(0)
    assert cache.lengths.tolist() == [0, 11, 7]


def test_four_groups_shares_and_the_shared_expert_add_up_to_the_uncut_layer():
    """Four blocks holding one group each (experts 0-3, 4-7, 8-11, 12-15):
    their routed parts, and the shared expert once, sum to the layer that
    holds all 16 (float32, so only the order of the sums differs)."""
    g = torch.Generator().manual_seed(7)
    whole = MoEBlock.init(16, 96, 64, 4, generator=g, device="cpu",
                          cfg=tiny_cfg(held_experts=0, first_expert=0))
    whole.router_bias = torch.randn(16, generator=g) * 0.1
    assert (whole.n_group, whole.topk_group) == (4, 2)
    x = torch.randn((3, 5, 96), generator=g)

    def share(r):
        cut = slice(4 * r, 4 * r + 4)
        stacks = [MoEINT4(dataclasses.replace(w.weight, packed=w.packed[cut],
                                              scales=w.scales[cut], zero_points=w.zero_points[cut]))
                  for w in (whole.w_gate, whole.w_up, whole.w_down)]
        return MoEBlock(whole.router, *stacks, num_experts=16, top_k=4,
                        router_bias=whole.router_bias, routed_scale=whole.routed_scale,
                        first_expert=4 * r, shared=whole.shared, n_group=4, topk_group=2)

    shares = [share(r) for r in range(4)]
    parts = sum(s._routed(x) for s in shares) + whole.shared(x)
    torch.testing.assert_close(parts, whole(x), atol=1e-5, rtol=1e-5)
    # the groups left out give nothing: a token's experts lie in 2 groups
    routing = whole.route(whole.router(x.reshape(-1, 96)))
    assert ((routing.expert_indices // 4)[:, :, None] == torch.arange(4)).any(1).sum(1).le(2).all()


def test_engine_serves_the_model():
    """The engine's greedy tokens (float32 activations), prefilled in chunks
    and decoded through the latent caches, are the reference's argmax,
    teacher forced on prompt + output, or its runner-up inside a float32
    near-tie; the paged pool refuses the model."""
    cfg = tiny_cfg()
    model = build(cfg, seed=5)
    eng = ServingEngine(model, cfg, num_slots=2, max_seq=48, prefill_bucket=8)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (13, 5, 9)]
    for uid, p in enumerate(prompts):
        eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=10))
    outs = eng.run()
    for uid, prompt in enumerate(prompts):
        seq = torch.tensor([prompt + outs[uid]])
        want, _, _ = ref.forward(geometry(cfg), weights(model), seq)
        for j, tok in enumerate(outs[uid]):
            top2 = torch.topk(want[0, len(prompt) - 1 + j], 2)
            gap = float(top2.values[0] - top2.values[1])
            # 1e-3: float32 orders of sums, or a router tie the two break apart
            assert tok == int(top2.indices[0]) or (tok == int(top2.indices[1]) and gap < 1e-3), (
                uid, j, tok, top2.indices.tolist(), gap)
    with pytest.raises(ValueError, match="latent"):
        ServingEngine(model, cfg, num_slots=2, max_seq=48, prefill_bucket=8, paged=True,
                      page_size=16)


def test_the_registry_holds_deepseek_v3_at_published_widths():
    c = DEEPSEEK_V3_671B
    assert (c.hidden, c.num_heads, c.num_layers, c.vocab_size) == (7168, 128, 61, 129280)
    assert (c.q_lora_rank, c.kv_lora_rank, c.qk_nope_dim, c.qk_rope_dim, c.v_head_dim) == (
        1536, 512, 128, 64, 128)
    assert (c.moe.num_experts, c.moe.ffn_dim, c.moe.top_k, c.shared_ffn, c.dense_ffn,
            c.dense_layers) == (256, 2048, 8, 2048, 18432, 3)
    assert (c.router, c.routed_scale, c.n_group, c.topk_group) == ("sigmoid", 2.5, 8, 4)
    assert (c.yarn.factor, c.yarn.original_max_position_embeddings, c.rope_theta) == (
        40.0, 4096, 10000.0)
    assert dataclasses.replace(c, held_experts=32).held == 32


def test_mla_launches_are_launch_counters():
    from fused4bit_tpu_torch import ops

    ops.mla_attention.launches = 5
    assert ops.launch_counts()["mla_attention"] == 5
    ops.reset_counts()
    assert ops.launch_counts()["mla_attention"] == 0


def test_a_latent_layer_runs_inside_its_spans():
    """Under the profiler one decode step of the tiny model opens
    ``attention.mla`` with its children ``attention.rope``,
    ``attention.kv_append``, ``attention.mla.absorb`` and
    ``attention.kernel`` (each layer's K15 call, the plain version here),
    and ``moe.route`` (the group selection)."""
    from fused4bit_tpu_torch.bench import decode_loop
    from fused4bit_tpu_torch.utils import profiling

    cfg = tiny_cfg()
    model = build(cfg, dtype=torch.bfloat16)
    caches = model.init_cache(cfg, 2, 16)
    tok0 = torch.tensor([[3], [5]], dtype=torch.int32)
    pos0 = torch.tensor([[2], [4]], dtype=torch.int32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_loop(model, caches, tok0, pos0, 1)
    ranges = [e for e in prof.events() if e.name.startswith(profiling.PREFIX)]
    names = [e.name[len(profiling.PREFIX):] for e in ranges]
    for name in ("attention.mla", "attention.rope", "attention.kv_append",
                 "attention.mla.absorb", "attention.kernel"):
        assert name in names, name
    assert names.count("attention.mla") == cfg.num_layers
    assert names.count("moe.route") >= cfg.num_layers - cfg.dense_layers
    mla = [e for e in ranges if e.name == profiling.PREFIX + "attention.mla"]
    kernels = [e for e in ranges if e.name == profiling.PREFIX + "attention.kernel"]
    assert all(any(m.time_range.start <= k.time_range.start and k.time_range.end <= m.time_range.end
                   for m in mla) for k in kernels)
