"""Port vs JAX package: per-group INT4 weights in the planar_groups layout.

Quantization bytes, the plain versions of kernels K7, K8 (linear) and K13,
K14 (grouped experts) on CPU tensors against the JAX Pallas kernels in
interpret mode, the layers' dispatch, the MoE block and the `tiny` model in
the per_group and pg_turbo modes.

Tolerances: w4a16 (K7, K13): the plain version is dequantize + an f32
matmul, JAX sums the same products per group in another order: f32 outputs
within 1e-5 of the largest output, bf16 within 1e-2 of it (one bf16 rounding
of each side). w4a8 (K8, K14): the same quantizer and exact integer partials
on both sides, the f32 fold taken in another order (per run of 16 columns in
the port, per group in JAX): f32 within 1e-6 of the largest output, bf16
within one bf16 ulp (2^-7) of it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.models import transformer as jax_transformer
from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.transformer import MoEBlock as JaxMoEBlock
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul_per_group as jax_grouped_pg
from fused4bit_tpu.ops.grouped_matmul import (
    grouped_int4_matmul_per_group_a8 as jax_grouped_pg_a8,
)
from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group as jax_pg
from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group_a8 as jax_pg_a8
from fused4bit_tpu.quant.core import dequantize as jax_dequantize
from fused4bit_tpu.quant.core import pack_planar as jax_pack_planar
from fused4bit_tpu.quant.core import planar_to_planar_groups as jax_planar_to_planar_groups
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.layers import MoEINT4, QuantizedKVCache, QuantizedLinear
from fused4bit_tpu_torch.models import (
    MoEBlock,
    QuantizedTransformer,
    as_per_group,
    kv_cache_from_jax,
    model_from_jax,
)
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops._rows import _pg_a8_product
from fused4bit_tpu_torch.ops.int8_xla import _quantize_acts
from fused4bit_tpu_torch.quant import (
    QuantizedTensor,
    dequantize,
    pack_planar,
    planar_groups_to_planar,
    planar_to_planar_groups,
    quantize,
    reference_linear_qt,
)
from test_torch_model import _params, _prefill_and_decode_match

A16_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
A8_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_qt(ref) -> QuantizedTensor:
    return QuantizedTensor(_t(ref.packed), _t(ref.scales), _t(ref.zero_points), tuple(ref.shape),
                           granularity=ref.granularity, layout=ref.layout, block_k=ref.block_k,
                           group_size=ref.group_size)


def _jax_pg(w, gs=128, layout="planar_groups"):
    return jax_quantize(jnp.asarray(w), granularity="per_group", layout=layout, group_size=gs)


def _assert_close(y: torch.Tensor, ref, tol: float):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = y.float().numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


# --- quantization ------------------------------------------------------------


@pytest.mark.parametrize("layout", ["planar_groups", "planar"])
@pytest.mark.parametrize("gs", [128, 64])
@pytest.mark.parametrize("shape", [(16, 512), (3, 24, 256)])
def test_per_group_quantize_bytes_equal_jax(rng, shape, gs, layout):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] = 0.75          # constant row: the scale guard in every group
    w[..., 1, :gs] = -3.0        # one constant group
    ref = _jax_pg(w, gs, layout)
    qt = quantize(torch.from_numpy(w), granularity="per_group", layout=layout, group_size=gs)
    for got, want in ((qt.packed, ref.packed), (qt.scales, ref.scales),
                      (qt.zero_points, ref.zero_points)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (qt.shape, qt.granularity, qt.layout, qt.group_size) == (
        tuple(ref.shape), ref.granularity, ref.layout, ref.group_size)
    np.testing.assert_array_equal(dequantize(qt).numpy(),
                                  np.asarray(jax_dequantize(ref, dtype=jnp.float32)))
    # the group-major reorder of the planar bytes, and back
    q = rng.integers(0, 16, shape, dtype=np.uint8)
    planar = pack_planar(torch.from_numpy(q))
    packed3 = planar_to_planar_groups(planar, gs)
    np.testing.assert_array_equal(
        packed3.numpy(), np.asarray(jax_planar_to_planar_groups(jax_pack_planar(jnp.asarray(q)), gs)))
    assert torch.equal(planar_groups_to_planar(packed3), planar)


def test_planar_groups_layout_errors():
    with pytest.raises(ValueError, match="per_group"):
        quantize(torch.zeros(4, 256), layout="planar_groups")
    with pytest.raises(ValueError, match="straddle"):
        quantize(torch.zeros(4, 384), granularity="per_group", layout="planar_groups",
                 group_size=128)   # gs divides K = 384 but not K/2 = 192
    with pytest.raises(ValueError, match="divisible"):
        planar_to_planar_groups(torch.zeros(4, 96, dtype=torch.uint8), 64)


# --- the activation quantizer of the per-group w4a8 wrappers ------------------


@jax.jit
def _jax_pg_a8_quantizer(x):
    """The quantizer of the JAX per-group w4a8 wrappers
    (int4_matmul.py `_int4_group_bp_a8_padded`, grouped_matmul.py
    `_grouped_pg_bp_a8_padded`), jitted as they are."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    sx = jnp.maximum(amax, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx


def test_pg_a8_quantizer_is_the_folded_reciprocal(rng):
    """XLA compiles the wrappers' ``amax / 127.0`` as a multiply by
    f32(1/127): the port's ``fused=True`` quantizer, bit for bit; the host
    quantizer (a true division) differs in sx for some rows."""
    x = rng.standard_normal((256, 64)).astype(np.float32) * 3.0
    jq, jsx = _jax_pg_a8_quantizer(jnp.asarray(x))
    xq, sx = _quantize_acts(torch.from_numpy(x), fused=True)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    _, sx_host = _quantize_acts(torch.from_numpy(x))
    assert not np.array_equal(sx_host.numpy(), np.asarray(jsx))


# --- K7 and K8 plain versions --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_int4_matmul_per_group_matches_jax(rng, m, dtype):
    n, k = 384, 512                       # N > 256; K/2 = 256 = 2 groups of 128
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = _jax_pg(w)
    jx = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    qt = _port_qt(ref_qt)
    before = (ops.int4_matmul_per_group_reference.calls,
              ops.int4_matmul_per_group_a8_reference.calls)
    launches = (ops.int4_matmul_per_group.launches, ops.int4_matmul_per_group_a8.launches)
    y = ops.int4_matmul_per_group(xt, qt)
    y8 = ops.int4_matmul_per_group_a8(xt, qt)
    assert (ops.int4_matmul_per_group_reference.calls,
            ops.int4_matmul_per_group_a8_reference.calls) == (before[0] + 1, before[1] + 1)
    assert (ops.int4_matmul_per_group.launches,
            ops.int4_matmul_per_group_a8.launches) == launches   # CPU: no kernel
    assert y.dtype == y8.dtype == _TORCH[dtype] and y.shape == y8.shape == (m, n)
    _assert_close(y, jax_pg(jx, ref_qt), A16_TOL[dtype])
    _assert_close(y8, jax_pg_a8(jx, ref_qt), A8_TOL[dtype])


def test_pg_a8_product_is_the_exact_integer_product(rng):
    """The plain w4a8 product against float64 ``(xq * sx) @ dequant(W)^T``:
    the integers are exact, so only the f32 fold's rounding remains."""
    n, k, gs = 64, 1024, 128
    qt = quantize(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)),
                  granularity="per_group", layout="planar_groups", group_size=gs)
    xq, sx = _quantize_acts(torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32)),
                            fused=True)
    y = _pg_a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points)
    dense = (xq.double() * sx.double()) @ dequantize(qt).double().t()
    assert y.dtype == torch.float32
    assert (y.double() - dense).abs().max() <= 1e-6 * dense.abs().max()


def test_per_group_a8_exactness_guard():
    """127 * 128 * gs must stay below 2**24: gs = 2048 is refused."""
    qt = quantize(torch.randn(8, 4096), granularity="per_group", layout="planar_groups",
                  group_size=2048)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        ops.int4_matmul_per_group_a8(torch.randn(2, 4096), qt)
    qe = quantize(torch.randn(2, 8, 4096), granularity="per_group", layout="planar_groups",
                  group_size=2048)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        ops.grouped_int4_matmul_per_group_a8(torch.zeros(32, 4096),
                                             torch.zeros(1, dtype=torch.int32), qe, tile_m=32)
    ok = quantize(torch.randn(8, 2048), granularity="per_group", layout="planar_groups",
                  group_size=1024)
    assert ops.int4_matmul_per_group_a8(torch.randn(2, 2048), ok).shape == (2, 8)


@pytest.mark.parametrize("layout,gs,a16_error,a8_error", [
    ("planar_groups", 64, None, None),                  # whole 16-byte runs per group
    ("planar", 128, None, ValueError),                  # K6/K12's input; no planar w4a8 kernel
    ("planar", 64, ValueError, ValueError),             # no TPU kernel takes it either
])
def test_per_group_wrappers_share_one_format_rule(layout, gs, a16_error, a8_error):
    """K7 and K13 (and K8 and K14) accept and refuse the same weights, on
    the CPU as on the card: the check runs before the device split."""
    qt = quantize(torch.randn(8, 256), granularity="per_group", layout=layout, group_size=gs)
    qe = quantize(torch.randn(2, 8, 256), granularity="per_group", layout=layout, group_size=gs)
    x, xs, gids = torch.randn(2, 256), torch.randn(32, 256), torch.zeros(1, dtype=torch.int32)
    for err, calls in (
        (a16_error, (lambda: ops.int4_matmul_per_group(x, qt),
                     lambda: ops.grouped_int4_matmul_per_group(xs, gids, qe, tile_m=32))),
        (a8_error, (lambda: ops.int4_matmul_per_group_a8(x, qt),
                    lambda: ops.grouped_int4_matmul_per_group_a8(xs, gids, qe, tile_m=32))),
    ):
        for call in calls:
            if err is None:
                assert call().shape[-1] == 8
            else:
                with pytest.raises(err):
                    call()


# --- K13 and K14 plain versions -------------------------------------------------


def _skewed_logits(rng, t, e):
    bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
    logits = (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)
    logits[:, e - 1] = -30.0        # the last expert gets no token
    return logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a8", [False, True])
def test_grouped_per_group_matches_jax(rng, a8, dtype):
    # N = 384 > 256, several tokens per expert and groups spanning tiles
    t, e, top_k, n, kdim = 40, 4, 2, 384, 512
    tile_m = 32 if a8 else 16
    jr = jax_topk_route(jnp.asarray(_skewed_logits(rng, t, e)), top_k, e)
    jp = jax_make_dispatch_plan(jr, e, tile_m=tile_m)
    tpe = np.asarray(jr.tokens_per_expert)
    assert tpe.min() == 0 and tpe.max() > tile_m
    x = rng.standard_normal((t, kdim)).astype(np.float32)
    xs = np.zeros((jp.t_pad, kdim), np.float32)
    xs[np.asarray(jp.rows)] = np.repeat(x, top_k, axis=0)
    ref_qt = _jax_pg(rng.standard_normal((e, n, kdim)).astype(np.float32) * kdim ** -0.5)
    gids = np.asarray(jp.tile_group_ids)
    jax_op, op, plain = ((jax_grouped_pg_a8, ops.grouped_int4_matmul_per_group_a8,
                          ops.grouped_int4_matmul_per_group_a8_reference) if a8 else
                         (jax_grouped_pg, ops.grouped_int4_matmul_per_group,
                          ops.grouped_int4_matmul_per_group_reference))
    y_ref = jax_op(jnp.asarray(xs).astype(dtype), jnp.asarray(gids), ref_qt, tile_m=tile_m)
    xt = torch.from_numpy(xs).to(_TORCH[dtype])
    before, launches = plain.calls, op.launches
    y = op(xt, _t(gids), _port_qt(ref_qt), tile_m=tile_m)
    assert (plain.calls, op.launches) == (before + 1, launches)
    assert y.dtype == _TORCH[dtype] and y.shape == (jp.t_pad, n)
    _assert_close(y, y_ref, (A8_TOL if a8 else A16_TOL)[dtype])
    pad = xt.float().abs().sum(dim=1) == 0
    assert torch.all(y[pad] == 0)   # padding rows come out exactly zero


def test_grouped_per_group_a8_rejects_tile_m_not_multiple_of_32():
    qe = quantize(torch.randn(2, 8, 256), granularity="per_group", layout="planar_groups")
    with pytest.raises(ValueError, match="multiple of 32"):
        ops.grouped_int4_matmul_per_group_a8(torch.zeros(16, 256),
                                             torch.zeros(1, dtype=torch.int32), qe, tile_m=16)


# --- layer dispatch -------------------------------------------------------------


def _calls():
    return {fn.__name__: fn.calls for fn in (
        ops.int4_matmul_reference, ops.int4_matmul_a8_reference,
        ops.int4_matmul_per_group_reference, ops.int4_matmul_per_group_a8_reference,
        ops.int4_linear_transient, ops.grouped_int4_matmul_reference,
        ops.grouped_int4_matmul_a8_reference, ops.grouped_int4_matmul_per_group_reference,
        ops.grouped_int4_matmul_per_group_a8_reference)}


def _ran(before):
    after = _calls()
    return sorted(k for k in after if after[k] != before[k])


# (granularity, group_size, activation, rows) -> the op that runs
LINEAR_CASES = [
    ("per_row", 128, "bf16", 4, ["int4_matmul_reference"]),
    ("per_row", 128, "int8_auto", 256, ["int4_linear_transient"]),
    ("per_group", 128, "bf16", 4, ["int4_matmul_per_group_reference"]),
    ("per_group", 128, "bf16", 600, ["int4_matmul_per_group_reference"]),
    ("per_group", 128, "int8", 4, ["int4_matmul_per_group_a8_reference"]),
    ("per_group", 128, "int8_auto", 256, ["int4_matmul_per_group_a8_reference"]),
    # planar, gs % 128 != 0: the golden path, the counted plain version of K7
    ("per_group", 64, "bf16", 4, ["int4_matmul_per_group_reference"]),
]


@pytest.mark.parametrize("granularity,gs,activation,rows,ran", LINEAR_CASES)
def test_quantized_linear_dispatch(rng, granularity, gs, activation, rows, ran):
    w = torch.from_numpy(rng.standard_normal((48, 256)).astype(np.float32))
    lin = QuantizedLinear.from_dense(w, granularity=granularity, group_size=gs,
                                     activation=activation)
    want_layout = "planar_groups" if granularity == "per_group" and gs % 128 == 0 else "planar"
    assert (lin.weight.granularity, lin.weight.layout) == (granularity, want_layout)
    x = torch.from_numpy(rng.standard_normal((rows, 256)).astype(np.float32))
    before = _calls()
    y = lin(x)
    assert _ran(before) == ran
    assert y.shape == (rows, 48)
    if gs % 128:
        torch.testing.assert_close(y, reference_linear_qt(x, lin.weight))


def test_planar_per_group_weights_name_the_unported_kernels(rng):
    """Per-group weights in the planar layout (gs % 128 == 0) reach the plain
    versions of K6 and K12, counted, and match JAX's ``_int4_group_kernel``
    and ``_grouped_pg_kernel`` in interpret mode. (The name dates from when
    those two kernels were not ported and these weights raised.)"""
    w = rng.standard_normal((8, 256)).astype(np.float32)
    ref = _jax_pg(w, 128, "planar")
    lin = QuantizedLinear(_port_qt(ref))
    x = rng.standard_normal((2, 256)).astype(np.float32)
    before = _calls()
    before_k6 = ops.int4_matmul_per_group_planar_reference.calls
    y = lin(torch.from_numpy(x))
    assert ops.int4_matmul_per_group_planar_reference.calls == before_k6 + 1
    assert _ran(before) == []                       # no other plain version ran
    _assert_close(y, jax_pg(jnp.asarray(x), ref), A16_TOL["float32"])
    we = rng.standard_normal((2, 8, 256)).astype(np.float32)
    ref_e = _jax_pg(we, 128, "planar")
    ex = MoEINT4(_port_qt(ref_e))
    xs = rng.standard_normal((32, 256)).astype(np.float32)
    xs[20:] = 0.0
    gids = np.asarray([0, 1], np.int32)
    before_k12 = ops.grouped_int4_matmul_per_group_planar_reference.calls
    ye = ex(torch.from_numpy(xs), _t(gids), tile_m=16)
    assert ops.grouped_int4_matmul_per_group_planar_reference.calls == before_k12 + 1
    _assert_close(ye, jax_grouped_pg(jnp.asarray(xs), jnp.asarray(gids), ref_e, tile_m=16),
                  A16_TOL["float32"])


@pytest.mark.parametrize("gs,activation,ran", [
    (128, "bf16", ["grouped_int4_matmul_per_group_reference"]),
    (128, "int8", ["grouped_int4_matmul_per_group_a8_reference"]),
    # planar, gs % 128 != 0: the golden path, the counted plain version of K13
    (64, "bf16", ["grouped_int4_matmul_per_group_reference"]),
])
def test_moe_int4_dispatch(rng, gs, activation, ran):
    w = torch.from_numpy(rng.standard_normal((2, 40, 256)).astype(np.float32))
    ex = MoEINT4.from_dense(w, granularity="per_group", group_size=gs, activation=activation)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    x[40:] = 0.0
    gids = torch.tensor([0, 1], dtype=torch.int32)
    before = _calls()
    y = ex(x, gids, tile_m=32)
    assert _ran(before) == ran
    assert y.shape == (64, 40) and torch.all(y[40:] == 0)
    if gs % 128:
        wd = dequantize(ex.weight)
        dense = torch.cat([x[:32] @ wd[0].t(), x[32:] @ wd[1].t()])
        torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-5)


# --- the MoE block ----------------------------------------------------------------


def _jax_requant(m, gs=128):
    return dataclasses.replace(m, weight=_jax_pg(jax_dequantize(m.weight), gs))


def _jax_block(mode):
    e, h, ffn, k = 4, 256, 256, 2
    jblk = dataclasses.replace(JaxMoEBlock.init(jax.random.PRNGKey(5), e, h, ffn, k),
                               prefill_threshold=4, prefill_tile_m=64)
    jblk = dataclasses.replace(jblk, **{w: _jax_requant(getattr(jblk, w))
                                        for w in ("w_gate", "w_up", "w_down")})
    if mode == "a16":
        return jblk
    experts = {w: dataclasses.replace(getattr(jblk, w), activation="int8")
               for w in ("w_gate", "w_up", "w_down")}
    if mode == "u4_turbo":
        return dataclasses.replace(jblk, tile_m=32, moe_impl="u4_turbo", **experts,
                                   router=jblk.router.as_u4_turbo())
    return dataclasses.replace(jblk, tile_m=32, **experts,
                               router=dataclasses.replace(jblk.router, activation="int8"))


def _port_block(jblk) -> MoEBlock:
    router = QuantizedLinear(_port_qt(jblk.router.weight), activation=jblk.router.activation)
    experts = [MoEINT4(_port_qt(m.weight), activation=m.activation)
               for m in (jblk.w_gate, jblk.w_up, jblk.w_down)]
    return MoEBlock(router, *experts, num_experts=jblk.num_experts, top_k=jblk.top_k,
                    tile_m=jblk.tile_m, prefill_threshold=jblk.prefill_threshold,
                    prefill_tile_m=jblk.prefill_tile_m, moe_impl=jblk.moe_impl)


# prefill_threshold 4: 3 tokens take the decode branch, 10 the prefill branch,
# which for per-group experts is the dropless grouped kernel in every mode
# (u4_turbo included: JAX's transient_ok rule keeps them off the capacity path).
@pytest.mark.parametrize("mode", ["a16", "turbo", "u4_turbo"])
@pytest.mark.parametrize("t", [3, 10])
def test_moe_block_per_group_matches_jax(rng, mode, t):
    jblk = _jax_block(mode)
    blk = _port_block(jblk)
    x = rng.standard_normal((1, t, 256)).astype(np.float32)
    y_ref = np.asarray(jblk(jnp.asarray(x)))
    before, transient = _calls(), ops.int4_grouped_transient.calls
    y = blk(torch.from_numpy(x))
    assert y.shape == (1, t, 256)
    grouped = ("grouped_int4_matmul_per_group_reference" if mode == "a16"
               else "grouped_int4_matmul_per_group_a8_reference")
    assert grouped in _ran(before) and ops.int4_grouped_transient.calls == transient
    assert np.max(np.abs(y.numpy() - y_ref)) <= 1e-5 * np.max(np.abs(y_ref))


# --- the tiny model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_jax_model():
    cfg = flagship_model_config("tiny")
    return cfg, JaxTransformer.init(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("mode", ["per_group", "pg_turbo"])
def test_tiny_model_per_group_modes_match_jax(tiny_jax_model, mode):
    cfg, jmodel = tiny_jax_model
    jmodel = jax_transformer.as_per_group(jmodel)
    if mode == "pg_turbo":
        jmodel = jax_transformer.as_turbo(jmodel)
    model = model_from_jax(_params(jmodel), cfg, mode=mode, device="cpu")
    blk = model.blocks[0]
    assert (blk.attn.wq.weight.layout, blk.moe.w_down.weight.layout,
            blk.moe.router.weight.granularity, model.lm_head.weight.granularity) == (
        "planar_groups", "planar_groups", "per_row", "per_group")
    want = ("int8", "int8", 32) if mode == "pg_turbo" else ("bf16", "bf16", 16)
    assert (blk.attn.wq.activation, blk.moe.w_gate.activation, blk.moe.tile_m) == want
    # the leaves were per-group already: nothing was requantized
    np.testing.assert_array_equal(blk.moe.w_up.packed.numpy(),
                                  np.asarray(jmodel.blocks[0].moe.w_up.weight.packed))
    _prefill_and_decode_match(jmodel, model, cfg)


def test_port_as_per_group_gives_jax_bytes(tiny_jax_model):
    cfg, jmodel = tiny_jax_model
    model = model_from_jax(_params(jmodel), cfg, device="cpu")
    converted = as_per_group(model)
    assert model.blocks[0].attn.wq.weight.granularity == "per_row"   # a copy
    ref = _params(jax_transformer.as_per_group(jmodel))
    got = {".lm_head.weight": converted.lm_head,
           ".blocks[1].attn.wo.weight": converted.blocks[1].attn.wo,
           ".blocks[0].moe.router.weight": converted.blocks[0].moe.router,
           ".blocks[0].moe.w_down.weight": converted.blocks[0].moe.w_down,
           ".blocks[1].moe.w_gate.weight": converted.blocks[1].moe.w_gate}
    for key, mod in got.items():
        for field in ("packed", "scales", "zero_points"):
            np.testing.assert_array_equal(getattr(mod, field).numpy(), ref[f"{key}.{field}"],
                                          err_msg=f"{key}.{field}")


def test_model_from_jax_reads_per_group_leaves_by_site(tiny_jax_model):
    cfg, jmodel = tiny_jax_model
    params = _params(jax_transformer.as_per_group(jmodel))
    with pytest.raises(ValueError, match=r"\.blocks\[0\]\.attn\.wq\.weight\.packed.*per-group"):
        model_from_jax(params, cfg, device="cpu")                   # mode="kernel"
    with pytest.raises(ValueError, match="per-group"):
        model_from_jax(params, cfg, mode="turbo", device="cpu")
    bad = dict(params)
    key = ".blocks[1].moe.w_up.weight.scales"
    bad[key] = bad[key][..., :-1]                                    # 2*Gh - 1 scales
    with pytest.raises(ValueError, match=r"\.blocks\[1\]\.moe\.w_up\.weight"):
        model_from_jax(bad, cfg, mode="per_group", device="cpu")
    bad = dict(params)
    key = ".lm_head.weight.packed"
    bad[key] = bad[key][None]                                        # a 4-D linear
    with pytest.raises(ValueError, match=r"\.lm_head\.weight"):
        model_from_jax(bad, cfg, mode="per_group", device="cpu")


# --- entry points build on the card unless asked for the CPU -----------------------


ENTRY_POINTS = {
    "QuantizedTransformer.init": lambda cfg: QuantizedTransformer.init(cfg),
    "MoEBlock.init": lambda cfg: MoEBlock.init(4, 64, 128, 2),
    "QuantizedLinear.init": lambda cfg: QuantizedLinear.init(64, 32),
    "QuantizedKVCache.init": lambda cfg: QuantizedKVCache.init(1, 2, 8, 64),
    "model_from_jax": lambda cfg: model_from_jax({}, cfg),
    "kv_cache_from_jax": lambda cfg: kv_cache_from_jax({}),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """With no device, an entry point that allocates builds on the CUDA card;
    on a machine without one it raises and names ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry](flagship_model_config("tiny"))


def test_from_dense_keeps_the_weights_device():
    lin = QuantizedLinear.from_dense(torch.randn(8, 256), granularity="per_group")
    ex = MoEINT4.from_dense(torch.randn(2, 8, 256), device="cpu")
    assert lin.packed.device.type == ex.packed.device.type == "cpu"
