"""Port vs JAX package: MoE routing, dispatch and capacity plans, grouped
product (kernel K2's plain version on CPU) and the SwiGLU MoE block in each
of its execution modes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import combine as jax_combine
from fused4bit_tpu.layers.moe import dispatch as jax_dispatch
from fused4bit_tpu.layers.moe import expert_load_stats as jax_expert_load_stats
from fused4bit_tpu.layers.moe import make_capacity_plan as jax_make_capacity_plan
from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.models.transformer import MoEBlock as JaxMoEBlock
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul as jax_grouped
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.layers import (
    MoEINT4,
    QuantizedLinear,
    combine,
    dispatch,
    expert_load_stats,
    make_capacity_plan,
    make_dispatch_plan,
    topk_route,
)
from fused4bit_tpu_torch.models import MoEBlock
from fused4bit_tpu_torch.ops import grouped_int4_matmul, to_int8_resident
from fused4bit_tpu_torch.quant import QuantizedTensor, dequantize


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_qt(ref) -> QuantizedTensor:
    return QuantizedTensor(_t(ref.packed), _t(ref.scales), _t(ref.zero_points),
                           tuple(ref.shape), block_k=ref.shape[-1])


def _skewed_logits(rng, t, e):
    """Untied logits, skewed so some experts get several tokens and some none."""
    bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
    return (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)


@pytest.mark.parametrize("tile_m", [8, 16])
def test_routing_and_plan_integers_equal_jax(rng, tile_m):
    t, e, k = 11, 6, 2
    logits = _skewed_logits(rng, t, e)
    jr = jax_topk_route(jnp.asarray(logits), k, e)
    jp = jax_make_dispatch_plan(jr, e, tile_m=tile_m)
    r = topk_route(torch.from_numpy(logits), k, e)
    p = make_dispatch_plan(r, e, tile_m=tile_m)
    np.testing.assert_array_equal(r.expert_indices.numpy(), np.asarray(jr.expert_indices))
    np.testing.assert_allclose(r.expert_weights.numpy(), np.asarray(jr.expert_weights), rtol=1e-6)
    np.testing.assert_array_equal(r.tokens_per_expert.numpy(), np.asarray(jr.tokens_per_expert))
    np.testing.assert_array_equal(r.expert_token_offsets.numpy(),
                                  np.asarray(jr.expert_token_offsets))
    assert np.asarray(jr.tokens_per_expert).min() == 0  # some expert gets nothing
    np.testing.assert_array_equal(p.rows.numpy(), np.asarray(jp.rows))
    np.testing.assert_array_equal(p.tile_group_ids.numpy(), np.asarray(jp.tile_group_ids))
    assert (p.t_pad, p.tile_m) == (jp.t_pad, jp.tile_m)


def test_dispatch_combine_roundtrip(rng):
    t, e, k, h = 9, 4, 2, 16
    r = topk_route(torch.from_numpy(_skewed_logits(rng, t, e)), k, e)
    p = make_dispatch_plan(r, e, tile_m=8)
    x = torch.from_numpy(rng.standard_normal((t, h)).astype(np.float32))
    xs = dispatch(x, r, p)
    assert xs.shape == (p.t_pad, h)
    # every (token, k) pair lands once; all other rows are zero padding
    assert torch.count_nonzero(xs.abs().sum(dim=1)) == t * k
    torch.testing.assert_close(combine(xs, r, p), x)  # weights sum to 1


def test_grouped_matmul_matches_jax(rng):
    # N = 384 > 256 and several tokens per expert: the original CUDA
    # library's MoE kernel wrote only columns 0-255 and read one token.
    t, e, k, n, kdim, tile_m = 20, 4, 2, 384, 256, 8
    r = topk_route(torch.from_numpy(_skewed_logits(rng, t, e)), k, e)
    p = make_dispatch_plan(r, e, tile_m=tile_m)
    assert int(r.tokens_per_expert.max()) > tile_m  # a group spans several tiles
    x = torch.from_numpy(rng.standard_normal((t, kdim)).astype(np.float32))
    xs = dispatch(x, r, p)
    w = rng.standard_normal((e, n, kdim)).astype(np.float32) * kdim ** -0.5
    ref_qt = jax_quantize(jnp.asarray(w))
    y_ref = np.asarray(jax_grouped(jnp.asarray(xs.numpy()), jnp.asarray(p.tile_group_ids.numpy()),
                                   ref_qt, tile_m=tile_m))
    y = grouped_int4_matmul(xs, p.tile_group_ids, _port_qt(ref_qt), tile_m=tile_m)
    assert y.shape == (p.t_pad, n)
    assert np.max(np.abs(y.numpy() - y_ref)) <= 1e-3
    # against the dense golden, row by row, every column
    wd = dequantize(_port_qt(ref_qt))
    experts = p.tile_group_ids.long().repeat_interleave(tile_m)
    dense = torch.einsum("tk,tnk->tn", xs, wd[experts])
    torch.testing.assert_close(y, dense, atol=1e-4, rtol=1e-4)
    # padding rows come out exactly zero
    pad = xs.abs().sum(dim=1) == 0
    assert torch.all(y[pad] == 0)


def _port_moe_block(jblk) -> MoEBlock:
    router = QuantizedLinear(_port_qt(jblk.router.weight))
    experts = [MoEINT4(_port_qt(m.weight)) for m in (jblk.w_gate, jblk.w_up, jblk.w_down)]
    return MoEBlock(router, *experts, num_experts=jblk.num_experts, top_k=jblk.top_k,
                    tile_m=jblk.tile_m)


def test_moe_block_matches_jax_bf16(rng):
    e, h, ffn, k = 4, 128, 384, 2
    jblk = JaxMoEBlock.init(jax.random.PRNGKey(3), e, h, ffn, k)
    x = rng.standard_normal((2, 5, h)).astype(np.float32)
    y_ref = np.asarray(jblk(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    y = _port_moe_block(jblk)(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (2, 5, h)
    assert np.max(np.abs(y.float().numpy() - y_ref)) <= 2e-2 * np.max(np.abs(y_ref))


def test_moe_block_unported_modes_raise():
    lin = QuantizedLinear.from_dense(torch.randn(4, 32))
    ex = MoEINT4.from_dense(torch.randn(4, 8, 32))
    with pytest.raises(ValueError):
        MoEBlock(lin, ex, ex, ex, num_experts=4, top_k=2, moe_impl="pg_turbo")
    with pytest.raises(ValueError):
        MoEBlock(lin, ex, ex, ex, num_experts=4, top_k=2, prefill_impl="ksplit")
    with pytest.raises(ValueError):
        MoEINT4(ex.weight, activation="int4")


@pytest.mark.parametrize("t,capacity,tile_m", [(11, 4, 4), (9, 8, 8)])
def test_capacity_plan_and_drops_equal_jax(rng, t, capacity, tile_m):
    e, k, h = 4, 2, 16
    logits = _skewed_logits(rng, t, e)
    jr = jax_topk_route(jnp.asarray(logits), k, e)
    jp = jax_make_capacity_plan(jr, e, capacity, tile_m=tile_m)
    r = topk_route(torch.from_numpy(logits), k, e)
    p = make_capacity_plan(r, e, capacity, tile_m=tile_m)
    np.testing.assert_array_equal(p.rows.numpy(), np.asarray(jp.rows))
    np.testing.assert_array_equal(p.tile_group_ids.numpy(), np.asarray(jp.tile_group_ids))
    assert (p.t_pad, p.tile_m) == (jp.t_pad, jp.tile_m)
    n_dropped = int((p.rows == p.t_pad).sum())
    assert n_dropped > 0  # the skewed routing overflows the first expert
    # drop-aware dispatch and combine against JAX's mode="drop" / mode="fill"
    x = rng.standard_normal((t, h)).astype(np.float32)
    xs = dispatch(torch.from_numpy(x), r, p)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jax_dispatch(jnp.asarray(x), jr, jp)))
    out = rng.standard_normal((p.t_pad, h)).astype(np.float32)
    np.testing.assert_allclose(combine(torch.from_numpy(out), r, p).numpy(),
                               np.asarray(jax_combine(jnp.asarray(out), jr, jp)),
                               rtol=1e-6, atol=1e-6)  # f32 sums of k=2 products
    # a token whose pairs were all dropped combines to exactly zero
    y = combine(xs, r, p)
    lost = (p.rows.reshape(t, k) == p.t_pad).all(dim=1)
    assert torch.all(y[lost] == 0)
    # load statistics, dropped pairs included
    for cap in (0, capacity):
        js = jax_expert_load_stats(jr, cap)
        st = expert_load_stats(r, cap)
        np.testing.assert_allclose(st["load_fraction"].numpy(), np.asarray(js["load_fraction"]),
                                   rtol=1e-6)
        assert st["imbalance"].item() == pytest.approx(float(js["imbalance"]), rel=1e-6)
        assert st["dropped"].item() == int(js["dropped"])
    assert expert_load_stats(r, capacity)["dropped"].item() == n_dropped


def test_capacity_plan_rejects_ragged_capacity():
    r = topk_route(torch.randn(4, 4), 2, 4)
    with pytest.raises(ValueError, match="multiple of tile_m"):
        make_capacity_plan(r, 4, 6, tile_m=4)


def _jax_mode(jblk, mode):
    conv = dict(activation="int8")
    if mode == "einsum":
        return dataclasses.replace(jblk, prefill_impl="einsum")
    if mode == "u4_turbo":
        return dataclasses.replace(
            jblk, tile_m=32, moe_impl="u4_turbo",
            **{w: dataclasses.replace(getattr(jblk, w), **conv) for w in ("w_gate", "w_up", "w_down")},
            router=jblk.router.as_u4_turbo())
    if mode == "turbo":
        return dataclasses.replace(
            jblk, tile_m=32,
            **{w: dataclasses.replace(getattr(jblk, w), **conv) for w in ("w_gate", "w_up", "w_down")},
            router=dataclasses.replace(jblk.router, activation="int8"))
    from fused4bit_tpu.ops.int8_xla import to_int8_resident as jax_to_int8_resident
    return dataclasses.replace(
        jblk, moe_impl="xla_turbo",
        **{w: dataclasses.replace(getattr(jblk, w), w8=jax_to_int8_resident(getattr(jblk, w).weight))
           for w in ("w_gate", "w_up", "w_down")},
        router=jblk.router.as_xla_turbo())


def _port_mode(blk: MoEBlock, mode) -> MoEBlock:
    if mode == "einsum":
        blk.prefill_impl = "einsum"
        return blk
    for ex in (blk.w_gate, blk.w_up, blk.w_down):
        if mode == "xla_turbo":
            w8 = to_int8_resident(ex.weight)
            ex.w8_q8, ex.w8_scales = w8.q8, w8.scales
        else:
            ex.activation = "int8"
    if mode == "xla_turbo":
        blk.router.as_xla_turbo()
        blk.moe_impl = "xla_turbo"
    else:
        blk.tile_m = 32
        blk.router.activation = "int8_auto" if mode == "u4_turbo" else "int8"
        if mode == "u4_turbo":
            blk.moe_impl = "u4_turbo"
    return blk


# prefill_threshold 4 with 10 tokens takes each mode's prefill branch (the
# capacity layout for einsum, u4_turbo and xla_turbo; the grouped a8 kernel
# at prefill_tile_m for turbo); 3 tokens its decode branch.
@pytest.mark.parametrize("mode", ["einsum", "u4_turbo", "turbo", "xla_turbo"])
@pytest.mark.parametrize("t", [3, 10])
def test_moe_block_modes_match_jax(rng, mode, t):
    e, h, ffn, k = 4, 128, 256, 2
    jblk = dataclasses.replace(JaxMoEBlock.init(jax.random.PRNGKey(5), e, h, ffn, k),
                               prefill_threshold=4, prefill_tile_m=64)
    jblk = _jax_mode(jblk, mode)
    blk = _port_moe_block(jblk)
    blk.prefill_threshold, blk.prefill_tile_m = 4, 64
    blk = _port_mode(blk, mode)
    x = rng.standard_normal((1, t, h)).astype(np.float32)
    y_ref = np.asarray(jblk(jnp.asarray(x)))
    y = blk(torch.from_numpy(x))
    assert y.shape == (1, t, h)
    assert np.max(np.abs(y.numpy() - y_ref)) <= 1e-5 * np.max(np.abs(y_ref))
