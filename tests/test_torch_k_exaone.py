"""K-EXAONE-shaped decoders in the port against the plain reference
``reference_models/k_exaone.py``, on the CPU at a tiny size.

The tiny config keeps every mechanism of K-EXAONE-236B-A23B: hidden 96
against a q width of 4 x 64, two "LLLG" periods with windows of 8, a dense
first layer, 16 experts top-4 under a sigmoid router with a selection bias
and a routed scale, a shared expert, the EXAONE 4.0 block, and a layer that
holds experts 4-7 of the 16, as one card of four would.

The reference computes in float32 on the port's INT4 grid values. With
float32 activations the port computes the same arithmetic, so the two agree
to float32's rounding; with bf16 activations, as served, each rounding can
flip an INT4 KV code and the post-norm blocks carry it on, so that
comparison only bounds the error. Routing follows the port's own choices
(the reference checks them as a margin), because with random weights a
near-tied selection flips on rounding.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from fused4bit_tpu_torch.layers.kv_cache import QuantizedKVCache
from fused4bit_tpu_torch.layers.moe import MoEINT4, sigmoid_route, topk_route
from fused4bit_tpu_torch.models import (
    K_EXAONE_236B, DenseMLP, ModelConfig, MoEBlock, MoEConfig, QuantizedTransformer,
    flagship_model_config,
)
from fused4bit_tpu_torch.ops.decode_attention import int4_attention_reference
from fused4bit_tpu_torch.quant.core import dequantize
from fused4bit_tpu_torch.serving.engine import GenerationRequest, ServingEngine
from reference_models import k_exaone as ref

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
WINDOW = 8
# float32 activations: both sides run the same float32 arithmetic on the
# same INT4 weights and KV codes and differ only in the order of sums (1e-6
# of logits of unit scale read 6e-6 at most).
LOGIT_TOL = {torch.float32: 2e-3}
ROUTE_TOL = {torch.float32: 1e-5}
# bf16 activations: the relative RMS error of the logits. bf16 roundings flip
# INT4 KV codes (a step is 1/15 of a vector's range) and the post-norms carry
# them on: 0.10-0.114 over three seeds, against 0.53-0.62 for a window of 10
# in place of 8 and 0.77-0.92 for no window. The mean route gap: 0.003-0.0085.
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
        name="k-exaone-tiny", moe=MoEConfig("k-exaone-tiny", 16, 96, 64, 4),
        num_layers=8, num_heads=4, num_kv_heads=2, head_dim=64, vocab_size=256,
        max_seq_len=64, rope_theta=1e6, rms_eps=1e-5, hidden_size=96,
        windows=(WINDOW, WINDOW, WINDOW, 0) * 2, dense_layers=1, dense_ffn=128, shared_ffn=64,
        router="sigmoid", routed_scale=2.5, block="exaone4", first_expert=4, held_experts=4)
    return dataclasses.replace(base, **kw)


def build(cfg: ModelConfig, seed: int = 0, dtype=torch.float32) -> QuantizedTransformer:
    g = torch.Generator().manual_seed(seed)
    model = QuantizedTransformer.init(cfg, generator=g, device="cpu", dtype=dtype)
    for blk in model.blocks:    # a bias large enough to move some selections
        if isinstance(blk.moe, MoEBlock):
            blk.moe.router_bias = torch.randn(cfg.moe.num_experts, generator=g) * 0.1
    return model


def geometry(cfg: ModelConfig, dtype=torch.float32) -> ref.Geometry:
    return ref.Geometry(
        hidden=cfg.hidden, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, vocab=cfg.vocab_size,
        windows=[cfg.window(i) for i in range(cfg.num_layers)],
        dense_layers=cfg.dense_layers, dense_ffn=cfg.dense_ffn, moe_ffn=cfg.moe.ffn_dim,
        shared_ffn=cfg.shared_ffn, num_experts=cfg.moe.num_experts,
        first_expert=cfg.first_expert, held_experts=cfg.held, top_k=cfg.moe.top_k,
        routed_scale=cfg.routed_scale, rope_theta=cfg.rope_theta, rms_eps=cfg.rms_eps,
        activations=dtype)


def weights(model: QuantizedTransformer) -> dict:
    """The port's weights for the reference: each INT4 weight's grid values
    (the reference's own quantizer gives them back unchanged), the rest as
    served."""
    def dq(mod):
        return dequantize(mod.weight, dtype=torch.float32)

    out = {"embed": model.embed.float(), "final_norm": model.final_norm.float(),
           "lm_head": dq(model.lm_head)}
    for i, blk in enumerate(model.blocks):
        a = blk.attn
        out.update({f"{i}.wq": dq(a.wq), f"{i}.wk": dq(a.wk), f"{i}.wv": dq(a.wv),
                    f"{i}.wo": dq(a.wo), f"{i}.q_norm": a.q_norm.float(),
                    f"{i}.k_norm": a.k_norm.float(), f"{i}.attn_norm": blk.attn_norm.float(),
                    f"{i}.ffn_norm": blk.moe_norm.float()})
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
        self.calls, self.handles = {}, []
        for i, blk in enumerate(model.blocks):
            if isinstance(blk.moe, MoEBlock):
                self.handles.append(blk.moe.router.register_forward_hook(self._hook(i, blk.moe)))

    def _hook(self, layer, moe):
        def hook(mod, args, out):
            idx = moe.route(out).expert_indices
            self.calls.setdefault(layer, []).append(idx.reshape(args[0].shape[0], -1))
        return hook

    def tensor(self, layers: int, batch: int) -> torch.Tensor:
        """[layers, B, T, k] from calls over [B * T_i] rows, in order."""
        out = [None] * layers
        for layer, parts in self.calls.items():
            k = parts[0].shape[-1]
            out[layer] = torch.cat([p.reshape(batch, -1, k) for p in parts], dim=1)
        fill = next(o for o in out if o is not None)
        return torch.stack([o if o is not None else torch.zeros_like(fill) for o in out])


def forward_steps(model, cfg, tokens, chunks):
    """Run ``tokens`` [B, T] through the port in forwards of ``chunks``
    positions each; returns the logits [B, T, V], the routes and the caches."""
    b, t = tokens.shape
    routes = Routes(model)
    caches = model.init_cache(cfg, b, cfg.max_seq_len, max_tokens=max(chunks))
    out, p = [], 0
    for n in chunks:
        logits, caches = model(tokens[:, p:p + n], caches, torch.arange(p, p + n))
        out.append(logits.float())
        p += n
    assert p == t
    return torch.cat(out, dim=1), routes.tensor(cfg.num_layers, b), caches


def assert_matches_reference(cfg, model, tokens, logits, routes, dtype=torch.float32):
    want, gaps = ref.forward(geometry(cfg, dtype), weights(model), tokens, routes=routes)
    gaps = torch.cat(gaps)
    if dtype == torch.bfloat16:
        rel = float((logits - want).norm() / want.norm())
        assert rel <= BF16_REL_TOL and float(gaps.mean()) <= BF16_ROUTE_TOL, (rel, gaps.mean())
        return
    assert float(gaps.max()) <= ROUTE_TOL[dtype]
    diff = float((logits - want).abs().max())
    assert diff <= LOGIT_TOL[dtype], f"max |logit - reference| = {diff}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_then_decode_past_the_ring_matches_reference(dtype):
    """A 12-token prefill, then 14 decode steps: the window layers' rings of
    8 + 12 slots wrap before the last step."""
    cfg = tiny_cfg()
    model = build(cfg, dtype=dtype)
    tokens = torch.randint(1, cfg.vocab_size, (2, 26), generator=torch.Generator().manual_seed(1))
    logits, routes, caches = forward_steps(model, cfg, tokens, [12] + [1] * 14)
    assert caches[0].ring and caches[0].max_seq == WINDOW + 12 < 26
    assert not caches[3].ring and caches[3].max_seq == cfg.max_seq_len
    assert_matches_reference(cfg, model, tokens, logits, routes, dtype)


def test_chunked_prefill_sees_the_keys_before_each_chunk():
    """Chunks of 4 over a window of 8: a chunk's first queries attend to the
    previous chunks' keys, read from the ring."""
    cfg = tiny_cfg()
    model = build(cfg, seed=3)
    tokens = torch.randint(1, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(4))
    logits, routes, _ = forward_steps(model, cfg, tokens, [4] * 5)
    assert_matches_reference(cfg, model, tokens, logits, routes)


def test_a_forward_longer_than_the_ring_allows_raises():
    cfg = tiny_cfg()
    model = build(cfg)
    caches = model.init_cache(cfg, 1, cfg.max_seq_len, max_tokens=4)
    with pytest.raises(ValueError, match="overruns the ring"):
        model(torch.ones((1, 6), dtype=torch.long), caches, torch.arange(6))


@pytest.mark.parametrize("paged", [False, True])
def test_engine_serves_the_model(paged):
    """The engine's greedy tokens (float32 activations) are the reference's
    argmax, teacher forced on prompt + output, or its runner-up inside a
    float32 near-tie. Paged: the pages hold every position and the window
    is a mask."""
    cfg = tiny_cfg()
    model = build(cfg, seed=5)
    kw = dict(paged=True, page_size=16) if paged else {}
    eng = ServingEngine(model, cfg, num_slots=2, max_seq=48, prefill_bucket=8, **kw)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (13, 5, 9)]
    for uid, p in enumerate(prompts):
        eng.submit(GenerationRequest(uid=uid, prompt=p, max_new_tokens=12))
    outs = eng.run()
    for uid, prompt in enumerate(prompts):
        seq = torch.tensor([prompt + outs[uid]])
        # the reference picks its own routes here: the engine's are spread
        # over chunk and decode calls of other batches
        want, _ = ref.forward(geometry(cfg), weights(model), seq)
        for j, tok in enumerate(outs[uid]):
            row = want[0, len(prompt) - 1 + j]
            top2 = torch.topk(row, 2)
            gap = float(top2.values[0] - top2.values[1])
            # 1e-3: float32 orders of sums, or a router tie the two break apart
            assert tok == int(top2.indices[0]) or (tok == int(top2.indices[1]) and gap < 1e-3), (
                f"request {uid} token {j}: {tok}, reference top2 {top2.indices.tolist()} "
                f"gap {gap}")


def test_four_shares_and_the_shared_expert_add_up_to_the_uncut_layer():
    """Four blocks holding experts 0-3, 4-7, 8-11 and 12-15 of one MoE layer:
    their routed parts, and the shared expert once, sum to the layer that
    holds all 16 (float32, so only the order of the sums differs)."""
    g = torch.Generator().manual_seed(7)
    whole = MoEBlock.init(16, 96, 64, 4, generator=g, device="cpu",
                          cfg=tiny_cfg(held_experts=0, first_expert=0))
    whole.router_bias = torch.randn(16, generator=g) * 0.1
    x = torch.randn((3, 5, 96), generator=g)

    def share(r):
        cut = slice(4 * r, 4 * r + 4)
        stacks = [MoEINT4(dataclasses.replace(w.weight, packed=w.packed[cut],
                                              scales=w.scales[cut], zero_points=w.zero_points[cut]))
                  for w in (whole.w_gate, whole.w_up, whole.w_down)]
        return MoEBlock(whole.router, *stacks, num_experts=16, top_k=4,
                        router_bias=whole.router_bias, routed_scale=whole.routed_scale,
                        first_expert=4 * r, shared=whole.shared)

    shares = [share(r) for r in range(4)]
    parts = sum(s._routed(x) for s in shares) + whole.shared(x)
    torch.testing.assert_close(parts, whole(x), atol=1e-5, rtol=1e-5)
    assert torch.equal(shares[1](x), shares[1]._routed(x) + whole.shared(x))


def test_sigmoid_router_follows_its_equations():
    g = torch.Generator().manual_seed(8)
    logits = torch.randn((6, 16), generator=g) * 2
    bias = torch.randn(16, generator=g) * 0.3
    r = sigmoid_route(logits, bias, 4, 16, scale=2.5)
    s = torch.sigmoid(logits)
    want = torch.topk(s + bias, 4, dim=-1).indices
    assert torch.equal(r.expert_indices.long(), want)
    w = s.gather(1, want)
    torch.testing.assert_close(r.expert_weights, w / w.sum(-1, keepdim=True) * 2.5)
    assert torch.equal(r.tokens_per_expert.long(), torch.bincount(want.flatten(), minlength=16))


def test_the_bias_moves_the_selection_and_not_the_weights():
    g = torch.Generator().manual_seed(9)
    logits = torch.randn((5, 16), generator=g)
    plain = sigmoid_route(logits, torch.zeros(16), 4, 16)
    bias = torch.zeros(16)
    bias[11] = 10.0    # expert 11 enters every selection
    biased = sigmoid_route(logits, bias, 4, 16)
    assert (biased.expert_indices == 11).any(dim=-1).all()
    assert not torch.equal(plain.expert_indices, biased.expert_indices)
    s = torch.sigmoid(logits).gather(1, biased.expert_indices.long())
    torch.testing.assert_close(biased.expert_weights, s / s.sum(-1, keepdim=True))


def test_a_window_cache_holds_its_ring():
    cfg = tiny_cfg()
    model = build(cfg)
    caches = model.init_cache(cfg, 3, 64, max_tokens=5)
    ring = WINDOW + 5 + 1           # 13, rounded up to even
    per_position = 2 * cfg.num_kv_heads * (cfg.head_dim // 2 + 8)   # K and V codes, 4 planes
    for i, c in enumerate(caches):
        slots = ring if cfg.window(i) else 64
        assert c.max_seq == slots and c.nbytes == 3 * slots * per_position
    # an append longer than the ring keeps its last positions, each at p % ring
    c = QuantizedKVCache.init(1, 1, 64, 64, device="cpu", window=WINDOW, max_tokens=5)
    k = torch.arange(40, dtype=torch.float32)[None, None, :, None].expand(1, 1, 40, 64) * 0.01
    k = k + torch.linspace(-1, 1, 64)
    c.append(k, k, start=torch.zeros(1, dtype=torch.int32))
    pos, written = c.positions()
    assert int(c.lengths) == 40 and written.all()
    assert sorted(pos[0].tolist()) == list(range(40 - ring, 40))
    assert all(p % ring == s for s, p in enumerate(pos[0].tolist()))


def test_a_windowless_mixtral_model_gives_the_bits_it_gave_before_windows():
    """The tiny Mixtral model's logits (a 6-token prefill and 3 decode steps,
    contiguous and paged) equal, bit for bit, those saved from the tree that
    had no windows."""
    saved = np.load(FIXTURES / "mixtral_tiny_windowless_logits.npz")
    cfg = flagship_model_config("tiny")
    g = torch.Generator().manual_seed(22)
    model = QuantizedTransformer.init(cfg, generator=g, device="cpu")
    tokens = torch.randint(1, cfg.vocab_size, (2, 9), generator=g)
    assert np.array_equal(tokens.numpy(), saved["tokens"])
    for kind in ("contiguous", "paged"):
        if kind == "contiguous":
            caches = model.init_cache(cfg, 2, 32)
        else:
            caches = model.init_paged_cache(cfg, 2, num_pages=9, page_size=16,
                                            max_pages_per_slot=2)
            for c in caches:
                c.assign_pages(0, [1, 2])
                c.assign_pages(1, [3, 4])
        outs, caches = model(tokens[:, :6], caches, torch.arange(6))
        outs = [outs]
        for s in range(6, 9):
            logits, caches = model(tokens[:, s:s + 1], caches, torch.tensor([s]))
            outs.append(logits)
        got = torch.cat(outs, 1).view(torch.int16).numpy().view(np.uint16)
        assert np.array_equal(got, saved[kind]), kind


def test_the_registry_holds_k_exaone_at_published_widths():
    c = K_EXAONE_236B
    assert (c.hidden, c.num_heads * c.head_dim, c.num_kv_heads, c.num_layers) == (6144, 8192, 8, 48)
    assert [c.window(i) for i in range(4)] == [128, 128, 128, 0] and len(c.windows) == 48
    assert (c.moe.num_experts, c.moe.ffn_dim, c.moe.top_k, c.shared_ffn, c.dense_ffn) == (
        128, 2048, 8, 2048, 18432)
    assert (c.router, c.routed_scale, c.vocab_size, c.held) == ("sigmoid", 2.5, 153600, 128)
    assert dataclasses.replace(c, held_experts=32).held == 32


def test_plain_attention_masks_by_the_window_on_a_wrapped_ring():
    """The plain K3 over a wrapped ring equals softmax attention over the
    window's positions, computed from the same codes in logical order."""
    g = torch.Generator().manual_seed(10)
    ring = QuantizedKVCache.init(2, 2, 64, 64, device="cpu", window=WINDOW, max_tokens=3)
    full = QuantizedKVCache.init(2, 2, 64, 64, device="cpu")
    p = 0
    for n in (5, 3, 3, 3, 1, 1):      # 16 positions: the ring of 12 wraps
        k = torch.randn((2, 2, n, 64), generator=g)
        v = torch.randn((2, 2, n, 64), generator=g)
        start = torch.full((2,), p, dtype=torch.int32)
        ring.append(k, v, start=start)
        full.append(k, v, start=start)
        p += n
    q = torch.randn((2, 4, 3, 64), generator=g)
    starts = torch.full((2,), 13, dtype=torch.int32)
    got = int4_attention_reference(q, ring, starts)
    windowed = dataclasses.replace(full, window=WINDOW)
    want = int4_attention_reference(q, windowed, starts)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(want, int4_attention_reference(q, full, starts))


def test_softmax_routing_is_unchanged():
    """topk_route, shared by every Mixtral cell, gives the softmax top-k
    renormalized, with its counts and offsets."""
    logits = torch.randn((7, 8), generator=torch.Generator().manual_seed(11))
    r = topk_route(logits, 2, 8)
    w, i = torch.topk(torch.softmax(logits, -1), 2, dim=-1)
    assert torch.equal(r.expert_indices.long(), i) and torch.equal(r.expert_weights,
                                                                   w / w.sum(-1, keepdim=True))
    assert not r.foreign and r.expert_token_offsets[-1] == 14


def test_window_launches_are_launch_counters():
    """The windowed share of K3's and K3''s launches is read and cleared
    with every other kernel's counter."""
    from fused4bit_tpu_torch import ops

    ops.int4_attention.window_launches = 3
    ops.paged_int4_attention.window_launches = 2
    counts = ops.launch_counts()
    assert (counts["int4_attention_window"], counts["paged_int4_attention_window"]) == (3, 2)
    ops.reset_counts()
    counts = ops.launch_counts()
    assert counts["int4_attention_window"] == counts["paged_int4_attention_window"] == 0
