"""Port vs JAX package: ``QuantizedDense`` (the flax layer of
``fused4bit_tpu/layers/flax_compat.py``) as an ``nn.Module``.

JAX-initialised variables carried across byte for byte, the output held to
JAX's ``QuantizedDense.apply`` on the same bytes: f32 within 1e-3 (the
linear's tolerance, ``tests/test_torch_linear.py``), bf16 within
2e-2 * max|y| (a bf16 product summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.flax_compat import QuantizedDense as JaxQuantizedDense
from fused4bit_tpu.quant import quantize as jax_quantize
from fused4bit_tpu_torch.layers import QuantizedDense, QuantizedLinear
from fused4bit_tpu_torch.layers.flax_compat import lecun_normal
from fused4bit_tpu_torch.models import quantized_dense_from_jax
from fused4bit_tpu_torch.ops import int4_matmul_reference

K, N = 256, 96


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.array(leaf) for path, leaf in leaves}


@pytest.fixture(scope="module")
def jax_dense():
    module = JaxQuantizedDense(features=N, use_bias=True)
    variables = module.init(jax.random.PRNGKey(0), jnp.ones((1, K), jnp.float32))
    bias = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    variables = {**variables, "params": {"bias": jnp.asarray(bias)}}
    return module, variables


def test_variables_carry_across_byte_for_byte(jax_dense):
    _, variables = jax_dense
    layer = quantized_dense_from_jax(_flat(variables), device="cpu")
    qt = variables["quantized"]["weight"]
    for name in ("packed", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(layer, name).numpy(), np.asarray(getattr(qt, name)))
    np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(variables["params"]["bias"]))
    assert (layer.in_features, layer.features) == (K, N)


def test_unread_leaf_raises(jax_dense):
    _, variables = jax_dense
    flat = _flat(variables)
    flat["['params']['extra']"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        quantized_dense_from_jax(flat, device="cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", None), ("bfloat16", 2e-2)])
def test_output_matches_jax_apply(jax_dense, rng, dtype, tol):
    module, variables = jax_dense
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    ref = np.asarray(module.apply(variables, jnp.asarray(x, getattr(jnp, dtype)))
                     .astype(jnp.float32))
    layer = quantized_dense_from_jax(_flat(variables), device="cpu")
    before = int4_matmul_reference.calls
    y = layer(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert int4_matmul_reference.calls == before + 1   # K1's plain version on the CPU
    assert y.dtype == getattr(torch, dtype) and y.shape == (2, 3, N)
    err = np.max(np.abs(y.float().numpy() - ref))
    assert err <= (1e-3 if tol is None else tol * np.max(np.abs(ref)))
    # the same bytes in a QuantizedLinear give the same bits
    assert torch.equal(y, QuantizedLinear(layer.weight, layer.bias)(
        torch.from_numpy(x).to(getattr(torch, dtype))))


def test_from_kernel_quantizes_as_jax(rng):
    """A flax Dense kernel [K, N] carried across: JAX's quantize of its
    transpose, byte for byte."""
    kernel = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
    layer = QuantizedDense.from_kernel(torch.from_numpy(kernel))
    jqt = jax_quantize(jnp.asarray(kernel).T)
    for name in ("packed", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(layer, name).numpy(), np.asarray(getattr(jqt, name)))
    assert layer.bias is None
    assert all(getattr(layer, n).is_contiguous() for n in ("packed", "scales", "zero_points"))


def test_init_draws_flax_lecun_normal():
    """lecun_normal: a normal truncated to ±2 standard deviations, scaled to
    variance 1/K; the same seed gives the same layer."""
    k, n = 512, 256
    w = lecun_normal(k, n, generator=torch.Generator().manual_seed(0), device="cpu")
    assert w.shape == (k, n)
    assert abs(w.std().item() * k ** 0.5 - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 * k ** -0.5 + 1e-6
    a, b = (QuantizedDense(k, n, use_bias=True, generator=torch.Generator().manual_seed(1),
                           device="cpu") for _ in range(2))
    assert torch.equal(a.packed, b.packed) and torch.equal(a.bias, torch.zeros(n))
    assert a.weight.shape == (n, k) and a.weight.granularity == "per_row"
    # the kernels take contiguous bytes only (K1's operand check on the card)
    assert all(getattr(a, name).is_contiguous() for name in ("packed", "scales", "zero_points"))
