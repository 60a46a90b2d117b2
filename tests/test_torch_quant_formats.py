"""Port vs JAX package: the per_tensor granularity, the interchange layouts
(interleaved, block_planar) and the rest of the quantization core.

Bytes, scales, zero points and dequantized values are compared exactly;
the float32 oracles (``reference_quantized_linear``) to 1e-5 of their
largest output (the two libraries sum the matmul in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.layers.kv_cache import dequantize_kv as jax_dequantize_kv
from fused4bit_tpu.layers.kv_cache import quantize_kv as jax_quantize_kv
from fused4bit_tpu.quant import core as jq
from fused4bit_tpu.quant.reference import reference_quantized_linear as jax_reference_ql
from fused4bit_tpu_torch.layers import dequantize_kv, quantize_kv
from fused4bit_tpu_torch.quant import core as pq
from fused4bit_tpu_torch.quant import reference_quantized_linear


def _weights(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] = 0.75          # constant row: the per-row scale guard
    w[..., 2, ::2] = 0.0         # half-zero row
    return w


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_same(qt, ref):
    for field in ("packed", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(qt, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    for field in ("shape", "granularity", "layout", "block_k", "group_size", "bits"):
        assert getattr(qt, field) == getattr(ref, field), field


# (granularity, layout, group_size, block_k)
FORMATS = [
    ("per_tensor", "planar", 128, None),
    ("per_tensor", "interleaved", 128, None),
    ("per_tensor", "block_planar", 128, 128),
    ("per_row", "interleaved", 128, None),
    ("per_row", "block_planar", 128, None),
    ("per_row", "block_planar", 128, 64),
    ("per_group", "interleaved", 64, None),
    ("per_group", "block_planar", 64, 128),      # a block holds two groups
    ("per_group", "block_planar", 128, 64),      # a group spans two blocks
]


@pytest.mark.parametrize("shape", [(16, 256), (3, 24, 256)])
@pytest.mark.parametrize("granularity,layout,gs,block_k", FORMATS)
def test_quantize_equals_jax(rng, shape, granularity, layout, gs, block_k):
    """Packed bytes, scales and zero points equal JAX's exactly, for a 2-D
    weight and an expert stack (per_tensor: one scalar per expert), and so
    does the dequantized weight."""
    w = _weights(rng, shape)
    kw = dict(granularity=granularity, layout=layout, group_size=gs, block_k=block_k)
    ref = jq.quantize(jnp.asarray(w), **kw)
    qt = pq.quantize(torch.from_numpy(w), **kw)
    _assert_same(qt, ref)
    if granularity == "per_tensor":
        assert qt.scales.shape == shape[:-2]
    np.testing.assert_array_equal(pq.dequantize(qt).numpy(), np.asarray(jq.dequantize(ref)))


def test_block_planar_nesting_is_checked_as_in_jax(rng):
    w = rng.standard_normal((4, 384)).astype(np.float32)
    for quantize, x in ((jq.quantize, jnp.asarray(w)), (pq.quantize, torch.from_numpy(w))):
        with pytest.raises(ValueError, match="must nest"):
            quantize(x, granularity="per_group", layout="block_planar", group_size=96,
                     block_k=128)


def test_packers_and_repackers_equal_jax(rng):
    q = rng.integers(0, 16, (5, 256), dtype=np.uint8)
    b = rng.integers(0, 256, (5, 128), dtype=np.uint8)
    for name, args in (("pack_interleaved", (q,)), ("unpack_interleaved", (b,)),
                       ("pack_block_planar", (q, 64)), ("unpack_block_planar", (b, 64)),
                       ("interleaved_to_planar", (b,)),
                       ("interleaved_to_block_planar", (b, 128))):
        want = np.asarray(getattr(jq, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                               for a in args)))
        got = getattr(pq, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                  for a in args))
        assert got.dtype == torch.uint8, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert torch.equal(pq.unpack_interleaved(pq.pack_interleaved(torch.from_numpy(q))),
                       torch.from_numpy(q))


@pytest.mark.parametrize("k", [64, 96, 256, 384, 1536, 4096, 14336])
def test_choose_block_k_equals_jax(k):
    assert pq.choose_block_k(k) == jq.choose_block_k(k)
    assert pq.choose_block_k(k, preferred=256) == jq.choose_block_k(k, preferred=256)


@pytest.mark.parametrize("granularity,layout", [("per_row", "planar"),
                                                ("per_group", "planar"),
                                                ("per_group", "planar_groups"),
                                                ("per_row", "interleaved")])
def test_pad_rows_equals_jax(rng, granularity, layout):
    """Rows padded at conversion equal JAX's bytes and dequantize to exact
    zeros; a weight already at the multiple comes back unchanged."""
    w = _weights(rng, (2, 20, 256))
    kw = dict(granularity=granularity, layout=layout, group_size=128)
    ref, qt = jq.pad_rows(jq.quantize(jnp.asarray(w), **kw), 24), pq.quantize(
        torch.from_numpy(w), **kw)
    padded = pq.pad_rows(qt, 24)
    _assert_same(padded, ref)
    assert torch.all(pq.dequantize(padded)[:, 20:] == 0)
    assert pq.pad_rows(qt, 4) is qt


def test_pad_rows_refuses_per_tensor_as_jax():
    w = np.ones((6, 32), np.float32)
    with pytest.raises(NotImplementedError):
        jq.pad_rows(jq.quantize(jnp.asarray(w), granularity="per_tensor"), 8)
    with pytest.raises(NotImplementedError):
        pq.pad_rows(pq.quantize(torch.from_numpy(w), granularity="per_tensor"), 8)


def test_reference_signature_entry_points_equal_jax(rng):
    """quantize_weights gives the reference library's interleaved bytes,
    dequantize_weights their values, and reference_quantized_linear the
    oracle's product, as JAX's do."""
    w = _weights(rng, (48, 128))
    packed, scales, zps = pq.quantize_weights(torch.from_numpy(w))
    jp, js, jz = jq.quantize_weights(jnp.asarray(w))
    for got, want in ((packed, jp), (scales, js), (zps, jz)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pq.dequantize_weights(packed, scales, zps).numpy(),
                                  np.asarray(jq.dequantize_weights(jp, js, jz)))
    for shape in ((128,), (3, 5, 128)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jax_reference_ql(jnp.asarray(x), jp, js, jz))
        got = reference_quantized_linear(torch.from_numpy(x), packed, scales, zps)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantize_kv_equals_jax(rng):
    x = rng.standard_normal((2, 3, 7, 64)).astype(np.float32)
    x[0, 0, 0] = 0.5                              # a constant vector
    got, want = quantize_kv(torch.from_numpy(x)), jax_quantize_kv(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            dequantize_kv(*got, dtype=dtype).float().numpy(),
            np.asarray(jax_dequantize_kv(*want, dtype=jdtype).astype(jnp.float32)))


@pytest.mark.parametrize("granularity,layout", [("per_row", "planar"),
                                                ("per_tensor", "planar"),
                                                ("per_group", "planar_groups"),
                                                ("per_group", "interleaved")])
def test_nbytes_and_memory_reduction_equal_jax(rng, granularity, layout):
    w = rng.standard_normal((4, 32, 256)).astype(np.float32)
    kw = dict(granularity=granularity, layout=layout, group_size=128)
    ref, qt = jq.quantize(jnp.asarray(w), **kw), pq.quantize(torch.from_numpy(w), **kw)
    assert qt.nbytes == ref.nbytes
    assert qt.memory_reduction_vs() == ref.memory_reduction_vs()
    assert qt.memory_reduction_vs(torch.bfloat16) == ref.memory_reduction_vs(jnp.bfloat16)
