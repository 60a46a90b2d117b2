"""Port vs JAX package: the w4a8 activation quantizer and the w4a8 linear
and grouped products (the plain versions of kernels K4/K5 and K10/K11 on
CPU tensors; the JAX Pallas kernels in interpret mode).

Tolerances: the integer dots are exact on both sides and the f32 epilogue
runs in the same order, so f32 outputs agree to 1e-6 of the largest output
and bf16 outputs to one bf16 ulp (2^-7) of the largest output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.moe import make_dispatch_plan as jax_make_dispatch_plan
from fused4bit_tpu.layers.moe import topk_route as jax_topk_route
from fused4bit_tpu.ops.grouped_matmul import grouped_int4_matmul_a8 as jax_grouped_a8
from fused4bit_tpu.ops.int4_matmul import int4_matmul_a8 as jax_int4_matmul_a8
from fused4bit_tpu.ops.int8_xla import _quantize_acts as jax_quantize_acts
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.ops import (
    grouped_int4_matmul_a8,
    grouped_int4_matmul_a8_reference,
    int4_matmul_a8,
    int4_matmul_a8_reference,
)
from fused4bit_tpu_torch.ops.int8_xla import _quantize_acts
from fused4bit_tpu_torch.quant import QuantizedTensor, dequantize

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_qt(ref) -> QuantizedTensor:
    return QuantizedTensor(_t(ref.packed), _t(ref.scales), _t(ref.zero_points),
                           tuple(ref.shape), block_k=ref.shape[-1])


def _assert_close(y: torch.Tensor, ref, dtype: str):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = y.float().numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= TOL[dtype] * np.max(np.abs(ref))


@jax.jit
def _jax_fused_prologue(x):
    """The quantization prologue of the fused TPU kernels, as they write it
    (int4_matmul.py `_int4_a8_fused_kernel`), compiled as they are."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=1, keepdims=True)
    sx = jnp.maximum(amax, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx


@pytest.mark.parametrize("fused", [False, True])
def test_activation_quantizer_bitwise_equals_jax(rng, fused):
    x = rng.standard_normal((64, 64)).astype(np.float32) * 3.0
    x[1] = 0.0                      # an all-zero row: sx = 1e-8 / 127, xq = 0
    x[2, :4] = [127.0, 2.5, -3.5, 0.5]
    x[2, 4:] = 0.0                  # sx = 1 exactly: halves round to even
    jax_quantizer = _jax_fused_prologue if fused else jax_quantize_acts
    for dtype in ("float32", "bfloat16"):
        xq, sx = _quantize_acts(torch.from_numpy(x).to(_TORCH[dtype]), fused=fused)
        jq, jsx = jax_quantizer(jnp.asarray(x).astype(dtype))
        assert xq.dtype == torch.int8 and sx.dtype == torch.float32
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    xq, sx = _quantize_acts(torch.from_numpy(x), fused=fused)
    assert sx[2].item() == 1.0
    assert xq[2, :4].tolist() == [127, 2, -4, 0]
    assert torch.all(xq[1] == 0)


def test_fused_quantizer_scale_differs_from_host_in_last_bit(rng):
    """The two quantizers are not interchangeable: for some rows the folded
    reciprocal gives an sx one f32 ulp away from the division."""
    x = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    _, sx_host = _quantize_acts(x)
    _, sx_fused = _quantize_acts(x, fused=True)
    ulp = torch.abs(sx_host - sx_fused) / torch.finfo(torch.float32).eps / sx_host
    assert torch.any(sx_host != sx_fused) and torch.all(ulp <= 1.0)


@pytest.mark.parametrize("fuse_quant", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", [(1, 96, 128), (8, 384, 256), (40, 128, 512)])
def test_int4_matmul_a8_matches_jax(rng, m, n, k, dtype, fuse_quant):
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = jax_quantize(jnp.asarray(w))
    jx = jnp.asarray(x).astype(dtype)
    y_ref = jax_int4_matmul_a8(jx, ref_qt, fuse_quant=fuse_quant)
    xt = torch.from_numpy(x).to(_TORCH[dtype])
    before = int4_matmul_a8_reference.calls
    y = int4_matmul_a8(xt, _port_qt(ref_qt), fuse_quant=fuse_quant)
    assert int4_matmul_a8_reference.calls == before + 1  # a CPU tensor: the plain version
    assert y.dtype == _TORCH[dtype] and y.shape == (m, n)
    _assert_close(y, y_ref, dtype)


def _skewed_logits(rng, t, e):
    bias = np.log(1.0 / (np.arange(e) + 1.0)) * 3.0
    logits = (bias[None, :] + rng.standard_normal((t, e))).astype(np.float32)
    logits[:, e - 1] = -30.0        # the last expert gets no token
    return logits


@pytest.mark.parametrize("fuse_quant", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_a8_matches_jax(rng, dtype, fuse_quant):
    # N = 384 > 256, several tokens per expert, one expert with none
    t, e, top_k, n, kdim, tile_m = 40, 4, 2, 384, 256, 32
    jr = jax_topk_route(jnp.asarray(_skewed_logits(rng, t, e)), top_k, e)
    jp = jax_make_dispatch_plan(jr, e, tile_m=tile_m)
    tpe = np.asarray(jr.tokens_per_expert)
    assert tpe.min() == 0 and tpe.max() > tile_m
    x = rng.standard_normal((t, kdim)).astype(np.float32)
    xs = np.zeros((jp.t_pad, kdim), np.float32)
    xs[np.asarray(jp.rows)] = np.repeat(x, top_k, axis=0)
    w = rng.standard_normal((e, n, kdim)).astype(np.float32) * kdim ** -0.5
    ref_qt = jax_quantize(jnp.asarray(w))
    gids = np.asarray(jp.tile_group_ids)
    y_ref = jax_grouped_a8(jnp.asarray(xs).astype(dtype), jnp.asarray(gids), ref_qt,
                           tile_m=tile_m, fuse_quant=fuse_quant)
    xt = torch.from_numpy(xs).to(_TORCH[dtype])
    before = grouped_int4_matmul_a8_reference.calls
    y = grouped_int4_matmul_a8(xt, _t(gids), _port_qt(ref_qt), tile_m=tile_m,
                               fuse_quant=fuse_quant)
    assert grouped_int4_matmul_a8_reference.calls == before + 1
    assert y.dtype == _TORCH[dtype] and y.shape == (jp.t_pad, n)
    _assert_close(y, y_ref, dtype)
    pad = xt.float().abs().sum(dim=1) == 0
    assert torch.all(y[pad] == 0)   # padding rows come out exactly zero


def test_grouped_a8_rejects_tile_m_not_multiple_of_32():
    qt = QuantizedTensor(torch.zeros((2, 8, 16), dtype=torch.uint8), torch.ones(2, 8),
                         torch.zeros(2, 8), (2, 8, 32), block_k=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        grouped_int4_matmul_a8(torch.zeros(16, 32), torch.zeros(1, dtype=torch.int32), qt,
                               tile_m=16)


def test_a8_reference_matches_dense_golden(rng):
    """The exact integer dot equals the dequantized float product of the
    quantized activations, up to f32 rounding."""
    w = rng.standard_normal((64, 128)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32))
    qt = _port_qt(jax_quantize(jnp.asarray(w)))
    xq, sx = _quantize_acts(x)
    dense = (xq.double() * sx.double()) @ dequantize(qt).double().t()
    y = int4_matmul_a8_reference(x, qt)
    torch.testing.assert_close(y.double(), dense, rtol=1e-5, atol=1e-5)
