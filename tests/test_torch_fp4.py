"""Port vs JAX package: emulated FP4 (E2M1), ``quant.fp4``.

Codes, scales and dequantized values equal JAX's exactly; ``fp4_matmul``
(a float32 matmul in both packages, summed in another order) within
1e-5 * max|y| in f32, and one bf16 ulp of the largest output in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.quant import fp4 as jax_fp4
from fused4bit_tpu_torch.quant import (
    E2M1_VALUES,
    FP4Tensor,
    dequantize_fp4,
    fp4_matmul,
    quantize_fp4,
)


def _both(w):
    return quantize_fp4(torch.from_numpy(w)), jax_fp4.quantize_fp4(jnp.asarray(w))


def _ties():
    """Every grid value, every midpoint and their f32 neighbours, signed; a 6
    in the row so that the scale is 1 and ws is w itself."""
    grid = np.asarray(E2M1_VALUES)
    mids = (grid[:-1] + grid[1:]) / 2
    pts = np.concatenate([grid, mids, np.nextafter(mids, 0), np.nextafter(mids, 7)])
    row = np.concatenate([pts, -pts, [6.0]]).astype(np.float32)
    return np.tile(np.pad(row, (0, 64 - row.size)), (2, 1))


@pytest.mark.parametrize("case", ["ties", "normal", "experts"])
def test_codes_scales_and_values_match_jax(rng, case):
    w = {"ties": _ties(),
         "normal": rng.standard_normal((64, 128)).astype(np.float32),
         "experts": (rng.standard_normal((4, 24, 64))
                     * np.asarray([1.0, 0.02, 100.0, 3.0])[:, None, None]).astype(np.float32),
         }[case]
    t, jt = _both(w)
    assert t.codes.dtype == torch.uint8 and t.shape == jt.shape == w.shape
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(jt.codes))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(jt.scale))
    np.testing.assert_array_equal(dequantize_fp4(t).numpy(),
                                  np.asarray(jax_fp4.dequantize_fp4(jt)))
    np.testing.assert_array_equal(dequantize_fp4(t, torch.bfloat16).float().numpy(),
                                  np.asarray(jax_fp4.dequantize_fp4(jt, jnp.bfloat16)
                                             .astype(jnp.float32)))


def test_midpoints_round_to_the_lower_magnitude():
    t = quantize_fp4(torch.tensor([[0.25, 0.75, 5.0, -2.5, 6.0, 0.0]]))
    np.testing.assert_array_equal(t.codes.numpy(), [[0, 1, 6, 8 | 4, 7, 0]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp4_matmul_matches_jax(rng, dtype):
    w = rng.standard_normal((3, 48, 128)).astype(np.float32)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    t, jt = _both(w)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(jax_fp4.fp4_matmul(jx, jt).astype(jnp.float32))
    y = fp4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), t)
    assert y.dtype == getattr(torch, dtype) and y.shape == (3, 5, 48)
    tol = (1e-5 if dtype == "float32" else 2.0 ** -7) * np.max(np.abs(ref))
    assert np.max(np.abs(y.float().numpy() - ref)) <= tol
    y32 = fp4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), t, dtype=torch.float32)
    assert y32.dtype == torch.float32


def test_nbytes_ideal_matches_jax(rng):
    w = rng.standard_normal((4, 8, 16)).astype(np.float32)
    t, jt = _both(w)
    assert t.nbytes_ideal == jt.nbytes_ideal == 4 * 8 * 16 // 2 + 4 * 4
    assert quantize_fp4(torch.zeros(128, 256)).nbytes_ideal < 128 * 256
    assert isinstance(t, FP4Tensor)
