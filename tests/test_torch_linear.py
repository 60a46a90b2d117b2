"""Port vs JAX package: the INT4 linear (kernel K1's plain version on CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.linear import QuantizedLinear as JaxQuantizedLinear
from fused4bit_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.layers import QuantizedLinear
from fused4bit_tpu_torch.ops import int4_matmul, int4_matmul_reference
from fused4bit_tpu_torch.quant import QuantizedTensor, quantize


def _port_qt(ref) -> QuantizedTensor:
    return QuantizedTensor(
        torch.from_numpy(np.array(ref.packed)), torch.from_numpy(np.array(ref.scales)),
        torch.from_numpy(np.array(ref.zero_points)), tuple(ref.shape), block_k=ref.shape[-1],
    )


# (600, 256, 256) takes the > 512-row path: dequantize, then a dense matmul.
@pytest.mark.parametrize("m,n,k", [(1, 8, 256), (8, 384, 512), (600, 256, 256)])
def test_int4_matmul_matches_jax(rng, m, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = jax_quantize(jnp.asarray(w))
    y_ref = np.asarray(jax_int4_matmul(jnp.asarray(x), ref_qt))
    y = int4_matmul(torch.from_numpy(x), _port_qt(ref_qt))
    assert y.dtype == torch.float32 and y.shape == (m, n)
    assert np.max(np.abs(y.numpy() - y_ref)) <= 1e-3


def test_cpu_tensor_takes_the_plain_version(rng):
    qt = quantize(torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)))
    before, launches = int4_matmul_reference.calls, int4_matmul.launches
    int4_matmul(torch.ones(2, 3, 64), qt)
    assert int4_matmul_reference.calls == before + 1
    assert int4_matmul.launches == launches


def test_quantized_linear_bf16_matches_jax(rng):
    n, k = 96, 128
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    b = rng.standard_normal((n,)).astype(np.float32)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    jlin = JaxQuantizedLinear.from_dense(jnp.asarray(w), jnp.asarray(b))
    y_ref = np.asarray(jlin(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    lin = QuantizedLinear(_port_qt(jlin.weight), torch.from_numpy(b))
    y = lin(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and y.shape == (2, 3, n)
    assert np.max(np.abs(y.float().numpy() - y_ref)) <= 2e-2 * np.max(np.abs(y_ref))


def test_out_features_slices_padded_rows(rng):
    w = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    padded = torch.cat([w, torch.zeros(8, 64)])
    lin = QuantizedLinear.from_dense(padded, out_features=8)
    full = QuantizedLinear.from_dense(w)
    x = torch.randn(4, 64)
    assert lin.out_dim == 8
    torch.testing.assert_close(lin(x), full(x))
