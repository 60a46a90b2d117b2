"""Port vs JAX package: quantization bytes, scales and zero points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.quant.core import dequantize as jax_dequantize
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.quant import dequantize, pack_planar, quantize, unpack_planar


def _weights(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] = 0.75          # constant row: the scale guard
    w[..., 1, :] = -3.0          # constant negative row
    w[..., 2, ::2] = 0.0         # half-zero row
    return w


@pytest.mark.parametrize("shape", [(16, 64), (3, 24, 128)])
def test_quantize_bytes_equal_jax(rng, shape):
    w = _weights(rng, shape)
    ref = jax_quantize(jnp.asarray(w), granularity="per_row", layout="planar")
    qt = quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(qt.zero_points.numpy(), np.asarray(ref.zero_points))
    assert qt.shape == tuple(ref.shape) and qt.in_dim == ref.in_dim and qt.out_dim == ref.out_dim
    np.testing.assert_array_equal(
        dequantize(qt).numpy(), np.asarray(jax_dequantize(ref, dtype=jnp.float32))
    )


def test_constant_row_guard_scale(rng):
    w = _weights(rng, (8, 32))
    qt = quantize(torch.from_numpy(w))
    np.testing.assert_allclose(qt.scales[0].item(), 1.0 / 15, rtol=1e-7)
    np.testing.assert_allclose(qt.scales[1].item(), 3.0 / 15, rtol=1e-7)
    # dequantize round-trips within half a step
    err = (dequantize(qt) - torch.from_numpy(w)).abs().amax(dim=-1)
    assert torch.all(err <= qt.scales * 0.5 + 1e-6)


def test_pack_planar_roundtrip(rng):
    q = torch.from_numpy(rng.integers(0, 16, (5, 64), dtype=np.uint8))
    packed = pack_planar(q)
    assert packed.shape == (5, 32) and packed.dtype == torch.uint8
    assert torch.equal(unpack_planar(packed), q)
    # low nibble = column c, high nibble XOR 8 = column c + K/2
    assert torch.equal(packed & 0xF, q[:, :32])
    assert torch.equal((packed >> 4) ^ 8, q[:, 32:])


def test_per_tensor_and_interleaved_quantize_as_jax():
    """per_tensor and the interleaved layout, once refused, quantize a
    constant weight as JAX does: the scale guard's scale, zero point 0,
    every code 0 (tests/test_torch_quant_formats.py covers them fully)."""
    for kw in (dict(granularity="per_tensor"), dict(layout="interleaved")):
        qt = quantize(torch.zeros(4, 8), **kw)
        ref = jax_quantize(jnp.zeros((4, 8)), **kw)
        for field in ("packed", "scales", "zero_points"):
            np.testing.assert_array_equal(getattr(qt, field).numpy(),
                                          np.asarray(getattr(ref, field)))
        assert (qt.granularity, qt.layout) == (ref.granularity, ref.layout)
