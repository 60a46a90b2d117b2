"""Port vs JAX package: per-group INT4 weights in the planar layout (what the
checkpoint converter produces) and the k-split grouped product.

The plain versions of kernels K6 (linear) and K12 (grouped experts) on CPU
tensors against the JAX Pallas kernels ``_int4_group_kernel`` and
``_grouped_pg_kernel`` in interpret mode, K9's path
(``grouped_int4_matmul(mode="ksplit")``) against ``_grouped_ksplit_kernel``,
and the layers' dispatch of planar per-group weights.

Tolerances: K6/K12 dequantize to the compute type as the TPU kernels do (bf16:
the scale, then the product, each rounded to bf16; f32: one rounding), then
sum the same products in another order: f32 outputs within 1e-5 of the
largest output, bf16 within 2e-2 of it (one bf16 rounding of each side). K9:
K2's plain version, a dequantize and an f32 matmul, against JAX's k-split
accumulation: the same bars.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul as jax_grouped
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul_per_group as jax_grouped_pg
from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group as jax_pg
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import MoEINT4, QuantizedLinear
from fused4bit_tpu_torch.ops._mma import _ksplit_mma_launch
from fused4bit_tpu_torch.ops._rows import _ksplit_splits
from fused4bit_tpu_torch.ops.grouped_matmul import MODES
from fused4bit_tpu_torch.quant import QuantizedTensor, dequantize, quantize, reference_linear_qt

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_qt(ref) -> QuantizedTensor:
    return QuantizedTensor(_t(ref.packed), _t(ref.scales), _t(ref.zero_points), tuple(ref.shape),
                           granularity=ref.granularity, layout=ref.layout, block_k=ref.block_k,
                           group_size=ref.group_size)


def _assert_close(y: torch.Tensor, ref, tol: float):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = y.float().numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref))


def _skewed_plan(rng, t, e, top_k, tile_m):
    """JAX's routing of skewed logits (the last expert gets no token) and
    its dispatch plan."""
    bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
    logits = (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)
    logits[:, e - 1] = -30.0
    jr = jax_topk_route(jnp.asarray(logits), top_k, e)
    return jr, jax_make_dispatch_plan(jr, e, tile_m=tile_m)


def _sorted_rows(rng, jr, jp, t, k, top_k):
    x = rng.standard_normal((t, k)).astype(np.float32)
    xs = np.zeros((jp.t_pad, k), np.float32)
    xs[np.asarray(jp.rows)] = np.repeat(x, top_k, axis=0)
    return xs


# --- K6 -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,gs", [(1, 128), (8, 128), (40, 128), (8, 256)])
def test_int4_matmul_per_group_planar_matches_jax(rng, m, gs, dtype):
    n, k = 384, 512                       # N > 256; K/2 = 256: 2 groups of 128, or 1 of 256
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    w[0] = 0.5                            # a constant row: the scale guard in every group
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = jax_quantize(jnp.asarray(w), granularity="per_group", layout="planar",
                          group_size=gs)
    qt = _port_qt(ref_qt)
    before = (ops.int4_matmul_per_group_planar_reference.calls,
              ops.int4_matmul_per_group_reference.calls)
    launches = (ops.int4_matmul_per_group.planar_launches, ops.int4_matmul_per_group.launches)
    y = ops.int4_matmul_per_group(torch.from_numpy(x).to(_TORCH[dtype]), qt)
    assert (ops.int4_matmul_per_group_planar_reference.calls,
            ops.int4_matmul_per_group_reference.calls) == (before[0] + 1, before[1])
    assert (ops.int4_matmul_per_group.planar_launches,
            ops.int4_matmul_per_group.launches) == launches   # CPU: no kernel
    assert y.dtype == _TORCH[dtype] and y.shape == (m, n)
    _assert_close(y, jax_pg(jnp.asarray(x).astype(dtype), ref_qt), TOL[dtype])


def test_k6_plain_version_rounds_as_the_tpu_kernel(rng):
    """In bf16 the TPU kernel rounds the scale and then the product to bf16:
    the plain version repeats both roundings, so it is not the golden
    (f32-dequantized) product, and it equals JAX's interpret-mode output on
    these inputs to within one bf16 ulp of the largest output."""
    n, k = 256, 512
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((8, k)).astype(np.float32)
    ref_qt = jax_quantize(jnp.asarray(w), granularity="per_group", layout="planar",
                          group_size=128)
    qt = _port_qt(ref_qt)
    xt = torch.from_numpy(x).bfloat16()
    y = ops.int4_matmul_per_group_planar_reference(xt, qt).float()
    golden = reference_linear_qt(xt, qt, dtype=torch.bfloat16).float()
    ref = torch.from_numpy(np.array(jax_pg(jnp.asarray(x, jnp.bfloat16), ref_qt)
                                    .astype(jnp.float32)))
    ulp = 2.0 ** -7 * ref.abs().max()
    assert (y - ref).abs().max() <= ulp
    assert (golden - ref).abs().max() > (y - ref).abs().max()


# --- K12 ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_per_group_planar_matches_jax(rng, dtype):
    # N = 384 > 256, several tokens per expert, one expert with none
    t, e, top_k, n, k, tile_m = 40, 4, 2, 384, 512, 16
    jr, jp = _skewed_plan(rng, t, e, top_k, tile_m)
    tpe = np.asarray(jr.tokens_per_expert)
    assert tpe.min() == 0 and tpe.max() > tile_m
    xs = _sorted_rows(rng, jr, jp, t, k, top_k)
    ref_qt = jax_quantize(jnp.asarray(rng.standard_normal((e, n, k)).astype(np.float32)
                                      * k ** -0.5),
                          granularity="per_group", layout="planar", group_size=128)
    gids = np.asarray(jp.tile_group_ids)
    y_ref = jax_grouped_pg(jnp.asarray(xs).astype(dtype), jnp.asarray(gids), ref_qt,
                           tile_m=tile_m)
    xt = torch.from_numpy(xs).to(_TORCH[dtype])
    plain = ops.grouped_int4_matmul_per_group_planar_reference
    op = ops.grouped_int4_matmul_per_group
    before, launches = plain.calls, (op.planar_launches, op.launches)
    y = op(xt, _t(gids), _port_qt(ref_qt), tile_m=tile_m)
    assert (plain.calls, op.planar_launches, op.launches) == (before + 1, *launches)
    assert y.dtype == _TORCH[dtype] and y.shape == (jp.t_pad, n)
    _assert_close(y, y_ref, TOL[dtype])
    pad = xt.float().abs().sum(dim=1) == 0
    assert torch.all(y[pad] == 0)   # padding rows come out exactly zero


# --- K9 -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ksplit_matches_jax(rng, dtype):
    """``mode="ksplit"`` against JAX's k-split kernel in interpret mode; on
    the CPU it runs K2's plain version, which K9 computes too."""
    t, e, top_k, n, k, tile_m = 40, 4, 2, 384, 1024, 16   # JAX: tile_kh 512, two k steps
    jr, jp = _skewed_plan(rng, t, e, top_k, tile_m)
    xs = _sorted_rows(rng, jr, jp, t, k, top_k)
    ref_qt = jax_quantize(jnp.asarray(rng.standard_normal((e, n, k)).astype(np.float32)
                                      * k ** -0.5))
    gids = np.asarray(jp.tile_group_ids)
    y_ref = jax_grouped(jnp.asarray(xs).astype(dtype), jnp.asarray(gids), ref_qt,
                        tile_m=tile_m, mode="ksplit")
    before = ops.grouped_int4_matmul_reference.calls
    launches = (ops.grouped_int4_matmul.launches, ops.grouped_int4_matmul.ksplit_launches)
    y = ops.grouped_int4_matmul(torch.from_numpy(xs).to(_TORCH[dtype]), _t(gids),
                                _port_qt(ref_qt), tile_m=tile_m, mode="ksplit")
    assert ops.grouped_int4_matmul_reference.calls == before + 1
    assert (ops.grouped_int4_matmul.launches,
            ops.grouped_int4_matmul.ksplit_launches) == launches   # CPU: no kernel
    _assert_close(y, y_ref, TOL[dtype])


def test_grouped_modes():
    """The TPU schedules run K2's plain version; an unknown mode raises."""
    qt = quantize(torch.randn(2, 40, 256))
    xs, gids = torch.randn(32, 256), torch.tensor([0, 1], dtype=torch.int32)
    want = ops.grouped_int4_matmul_reference(xs, gids, qt, tile_m=16)
    for mode in MODES:
        assert torch.equal(ops.grouped_int4_matmul(xs, gids, qt, tile_m=16, mode=mode), want)
    with pytest.raises(ValueError, match="mode='k_split'"):
        ops.grouped_int4_matmul(xs, gids, qt, tile_m=16, mode="k_split")


@pytest.mark.parametrize("n,k,launch", [
    (4096, 14336, (448, 1, 2)),   # layer2 down projection: K2's two slices, on two CTAs
    (14336, 4096, (128, 1, 2)),   # gate/up: K2 takes one slice; K9 at least two
    (256, 14336, (56, 1, 16)),    # 16 row tiles: K2's 17 slices in whole chunks, 16 CTAs
    (1024, 14336, (184, 1, 5)),   # 64 row tiles: 5 slices
    (64, 1024, (8, 1, 8)),        # K/2 = 8 chunks: one CTA per chunk
])
def test_ksplit_splits(n, k, launch):
    """K9's launch on the tensor-core body (bf16): K2's slices of K/2, at
    least two, on CTAs along K; it reads no T, so a decode step and the
    600-token prefill of the down projection take the same shape."""
    assert _ksplit_mma_launch(n, k, sms=132) == launch


@pytest.mark.parametrize("t_pad,n,k,sms,splits", [
    (144, 4096, 14336, 132, 1),   # layer2 down projection at decode (T=8): 2304 CTAs
    (16, 256, 14336, 132, 9),     # 16 CTAs on the H100's 132 SMs
    (16, 256, 14336, 114, 8),     # the same grid on a card of 114 SMs
    (16, 1024, 14336, 114, 2),    # 64 CTAs: 2 splits give 128
    (8, 64, 1024, 114, 1),        # K/2 = 512 is one chunk: nothing to split
])
def test_ksplit_f32_splits(t_pad, n, k, sms, splits):
    """f32 K9 on the CUDA-core loop (8 rows of x per CTA): enough CTAs for one
    per SM of the card it runs on, at most one per chunk of 512 packed
    bytes."""
    assert _ksplit_splits(t_pad, n, k, rows=8, sms=sms) == splits


# --- layer dispatch ---------------------------------------------------------------


def _calls():
    return {fn.__name__: fn.calls for fn in (
        ops.int4_matmul_per_group_reference, ops.int4_matmul_per_group_planar_reference,
        ops.int4_matmul_per_group_a8_reference, ops.grouped_int4_matmul_reference,
        ops.grouped_int4_matmul_per_group_reference,
        ops.grouped_int4_matmul_per_group_planar_reference,
        ops.grouped_int4_matmul_per_group_a8_reference)}


def _ran(before):
    after = _calls()
    return sorted(k for k in after if after[k] != before[k])


@pytest.mark.parametrize("gs,activation,ran", [
    (128, "bf16", ["int4_matmul_per_group_planar_reference"]),   # K6
    (128, "int8", ["int4_matmul_per_group_planar_reference"]),   # no planar w4a8: K6, as JAX
    (64, "bf16", ["int4_matmul_per_group_reference"]),           # no kernel: golden
])
def test_quantized_linear_planar_dispatch(rng, gs, activation, ran):
    w = torch.from_numpy(rng.standard_normal((48, 256)).astype(np.float32))
    lin = QuantizedLinear(quantize(w, granularity="per_group", layout="planar", group_size=gs),
                          activation=activation)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    before = _calls()
    y = lin(x)
    assert _ran(before) == ran and y.shape == (4, 48)
    if gs % 128:
        torch.testing.assert_close(y, reference_linear_qt(x, lin.weight))


@pytest.mark.parametrize("gs,activation,ran", [
    (128, "bf16", ["grouped_int4_matmul_per_group_planar_reference"]),   # K12
    (128, "int8", ["grouped_int4_matmul_per_group_planar_reference"]),
    (64, "bf16", ["grouped_int4_matmul_per_group_reference"]),           # golden
])
def test_moe_int4_planar_dispatch(rng, gs, activation, ran):
    w = torch.from_numpy(rng.standard_normal((2, 40, 256)).astype(np.float32))
    ex = MoEINT4(quantize(w, granularity="per_group", layout="planar", group_size=gs),
                 activation=activation)
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


def test_moe_int4_passes_mode_on():
    """``MoEINT4`` hands its keyword arguments to the grouped op, as in JAX:
    ``mode="ksplit"`` reaches ``grouped_int4_matmul`` (K2's plain version on
    the CPU), an unknown mode is refused there, and the per-group op, which
    takes no mode, refuses it."""
    ex = MoEINT4(quantize(torch.randn(2, 40, 256)))
    xs, gids = torch.randn(32, 256), torch.tensor([0, 1], dtype=torch.int32)
    before = _calls()
    y = ex(xs, gids, tile_m=16, mode="ksplit")
    assert _ran(before) == ["grouped_int4_matmul_reference"]
    assert torch.equal(y, ex(xs, gids, tile_m=16))
    with pytest.raises(ValueError, match="mode"):
        ex(xs, gids, tile_m=16, mode="split")
    pg = MoEINT4(quantize(torch.randn(2, 40, 256), granularity="per_group", layout="planar"))
    with pytest.raises(TypeError, match="mode"):
        pg(xs, gids, tile_m=16, mode="ksplit")
