"""Port vs JAX package: the integer-GEMM paths of ``ops/int8_xla.py`` (the
i8-resident copy and the transient unpack) and the regime dispatch of
``QuantizedLinear.as_u4_turbo``.

The products are exact int32 on both sides and the f32 epilogue runs in the
same order, so f32 outputs agree to 1e-6 of the largest output and bf16
outputs to one bf16 ulp (2^-7) of it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.linear import QuantizedLinear as JaxQuantizedLinear
from fused4bit_tpu.ops import int8_xla as jx
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.layers import QuantizedLinear
from fused4bit_tpu_torch.ops import (
    Int8Resident,
    int4_grouped_transient,
    int4_linear_transient,
    int4_matmul_a8_reference,
    int8_grouped_capacity,
    int8_linear,
    to_int8_resident,
)
from fused4bit_tpu_torch.quant import QuantizedTensor

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


def _weights(rng, *shape):
    w = rng.standard_normal(shape).astype(np.float32) * shape[-1] ** -0.5
    return jax_quantize(jnp.asarray(w))


def test_to_int8_resident_bitwise_equals_jax(rng):
    for shape in ((96, 128), (3, 40, 64)):
        ref_qt = _weights(rng, *shape)
        jw8 = jx.to_int8_resident(ref_qt)
        w8 = to_int8_resident(_port_qt(ref_qt))
        assert isinstance(w8, Int8Resident) and w8.q8.dtype == torch.int8
        np.testing.assert_array_equal(w8.q8.numpy(), np.asarray(jw8.q8))
        np.testing.assert_array_equal(w8.scales.numpy(), np.asarray(jw8.scales))
        assert (w8.out_dim, w8.in_dim, w8.nbytes) == (jw8.out_dim, jw8.in_dim, jw8.nbytes)
        assert w8.q8.abs().max() <= 15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_paths_match_jax(rng, dtype):
    ref_qt = _weights(rng, 96, 128)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jxx, xt = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(_TORCH[dtype])
    qt = _port_qt(ref_qt)
    before = (int8_linear.calls, int4_linear_transient.calls)
    y_res = int8_linear(xt, to_int8_resident(qt))
    y_tr = int4_linear_transient(xt, qt)
    assert (int8_linear.calls, int4_linear_transient.calls) == (before[0] + 1, before[1] + 1)
    assert y_res.dtype == _TORCH[dtype] and y_res.shape == (2, 5, 96)
    _assert_close(y_res, jx.int8_linear(jxx, jx.to_int8_resident(ref_qt)), dtype)
    _assert_close(y_tr, jx.int4_linear_transient(jxx, ref_qt), dtype)
    # the transient unpack and the resident copy are the same integers
    torch.testing.assert_close(y_tr, y_res, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_capacity_paths_match_jax(rng, dtype):
    e, c, k, n = 4, 8, 128, 96
    ref_qt = _weights(rng, e, n, k)
    xe = rng.standard_normal((e, c, k)).astype(np.float32)
    xe[1, 5:] = 0.0                    # empty capacity rows
    jxe, xt = jnp.asarray(xe).astype(dtype), torch.from_numpy(xe).to(_TORCH[dtype])
    qt = _port_qt(ref_qt)
    y_res = int8_grouped_capacity(xt, to_int8_resident(qt))
    y_tr = int4_grouped_transient(xt, qt)
    assert y_res.shape == (e, c, n) and y_res.dtype == _TORCH[dtype]
    _assert_close(y_res, jx.int8_grouped_capacity(jxe, jx.to_int8_resident(ref_qt)), dtype)
    _assert_close(y_tr, jx.int4_grouped_transient(jxe, ref_qt), dtype)
    assert torch.all(y_tr[1, 5:] == 0)


def test_u4_turbo_linear_regime_dispatch(rng):
    """as_u4_turbo: 4 rows take the w4a8 path, 256 rows the transient one;
    both agree with the JAX layer after the same conversion."""
    w = rng.standard_normal((96, 128)).astype(np.float32)
    jlin = JaxQuantizedLinear.from_dense(jnp.asarray(w)).as_u4_turbo()
    lin = QuantizedLinear(_port_qt(jlin.weight)).as_u4_turbo()
    assert lin.activation == "int8_auto" and lin.w8 is None
    for m, a8_calls, transient_calls in ((4, 1, 0), (QuantizedLinear._AUTO_PREFILL_M, 0, 1)):
        x = rng.standard_normal((m, 128)).astype(np.float32)
        before = (int4_matmul_a8_reference.calls, int4_linear_transient.calls)
        y = lin(torch.from_numpy(x))
        assert int4_matmul_a8_reference.calls - before[0] == a8_calls, m
        assert int4_linear_transient.calls - before[1] == transient_calls, m
        _assert_close(y, jlin(jnp.asarray(x)), "float32")


def test_xla_turbo_linear_matches_jax(rng):
    w = rng.standard_normal((96, 128)).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32)
    jlin = JaxQuantizedLinear.from_dense(jnp.asarray(w), jnp.asarray(b)).as_xla_turbo()
    lin = QuantizedLinear(_port_qt(jlin.weight), torch.from_numpy(b)).as_xla_turbo()
    assert lin.activation == "int8_xla"
    np.testing.assert_array_equal(lin.w8.q8.numpy(), np.asarray(jlin.w8.q8))
    x = rng.standard_normal((3, 128)).astype(np.float32)
    before = int8_linear.calls
    y = lin(torch.from_numpy(x))
    assert int8_linear.calls == before + 1
    _assert_close(y, jlin(jnp.asarray(x)), "float32")
