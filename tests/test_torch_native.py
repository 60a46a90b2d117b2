"""Port vs JAX package: the native host packer (``fused4bit_tpu_torch.native``).

Exact throughout: the library, its NumPy fallback and both packages'
quantizers give the same bytes, scales and zero points, bit for bit. The
constructed tie row is one where multiplying by the scale's reciprocal (as
the JAX library does) rounds a value to the other code than dividing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu import native as jax_native
from fused4bit_tpu.quant import quantize as jax_quantize
from fused4bit_tpu_torch import native
from fused4bit_tpu_torch.quant import QuantizedTensor, dequantize, quantize


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def tie_row(seed=0):
    """A 1x128 row: 64 N(0, 0.02) values, then 64 copies of one value next to
    a half-code boundary, found by walking ``nextafter`` from the boundary
    until ``round(x / scale + zp)`` and the JAX library's
    ``round(fma(x, 1/scale, zp))`` part; also returns the two codes."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 0.02, 64).astype(np.float32)
    mn, mx = base.min(), base.max()
    scale = np.float32(max((mx - mn) / np.float32(15.0), np.float32(1e-8)))
    zp = np.float32(np.clip(np.round(-mn / scale), 0, 15))
    inv = np.float32(1.0) / scale
    for c in range(1, 15):
        x = np.float32((c + 0.5 - float(zp)) * float(scale))
        for direction in (np.float32(np.inf), np.float32(-np.inf)):
            y = x
            for _ in range(64):
                div = np.round(np.float32(y / scale) + zp)
                # the f64 sum of the exact product and zp is exact: one rounding, an FMA's
                fma = np.round(np.float32(np.float64(y) * np.float64(inv) + np.float64(zp)))
                if mn < y < mx and div != fma:
                    return np.concatenate([base, np.full(64, y, np.float32)])[None, :], div, fma
                y = np.nextafter(y, direction)
    raise AssertionError("no tie found")


def test_library_builds_here():
    # g++ is on this machine and on the card's: the C++ path must be live
    assert native.native_available()
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("shape", [(64, 128), (32, 256), (7, 4096), (3, 14)])
def test_library_matches_numpy_fallback_bitexact(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    before = native.quantize_pack_planar.native_calls
    got = native.quantize_pack_planar(w)
    assert native.quantize_pack_planar.native_calls == before + 1
    _assert_same(got, native._numpy_quantize_pack(w))
    _assert_same(native.dequantize_planar(*got), jax_native.dequantize_planar(*got))


@pytest.mark.parametrize("shape", [(64, 128), (32, 256)])
def test_matches_both_quantizers(rng, shape):
    """JAX's own test shapes: the port's packer, the port's quantize and
    JAX's quantize give the same bytes, scales and zero points."""
    w = rng.standard_normal(shape).astype(np.float32)
    packed, scales, zps = native.quantize_pack_planar(w)
    qt = quantize(torch.from_numpy(w))
    jqt = jax_quantize(jnp.asarray(w), layout="planar")
    _assert_same((packed, scales, zps), (qt.packed, qt.scales, qt.zero_points))
    _assert_same((packed, scales, zps), (jqt.packed, jqt.scales, jqt.zero_points))


def test_tie_row_gives_the_quantizers_bytes():
    w, div, fma = tie_row()
    assert div != fma   # the row does hold a tie the reciprocal arithmetic rounds otherwise
    want = jax_native._numpy_quantize_pack(w)
    jqt = jax_quantize(jnp.asarray(w), layout="planar")
    _assert_same(want, (jqt.packed, jqt.scales, jqt.zero_points))
    qt = quantize(torch.from_numpy(w))
    _assert_same((qt.packed, qt.scales, qt.zero_points), want)
    _assert_same(native.quantize_pack_planar(w), want)
    _assert_same(native._numpy_quantize_pack(w), want)
    # the tied value's code is the division's: high nibbles of bytes 0-63
    np.testing.assert_array_equal(qt.packed[0].numpy() >> 4, np.full(64, int(div) ^ 8))


def test_roundtrip(rng):
    w = rng.standard_normal((16, 64)).astype(np.float32)
    packed, scales, zps = native.quantize_pack_planar(w)
    w2 = native.dequantize_planar(packed, scales, zps)
    assert np.max(np.abs(w2 - w)) < 0.5
    qt = QuantizedTensor(torch.from_numpy(packed), torch.from_numpy(scales),
                         torch.from_numpy(zps), (16, 64), block_k=64)
    np.testing.assert_array_equal(dequantize(qt).numpy(), w2)


def test_constant_rows():
    w = np.full((4, 32), 2.5, np.float32)
    w[2] = 0.0
    packed, scales, zps = native.quantize_pack_planar(w)
    _assert_same((packed, scales, zps), native._numpy_quantize_pack(w))
    w2 = native.dequantize_planar(packed, scales, zps)
    assert not np.any(np.isnan(w2))
    assert np.max(np.abs(w2 - w)) < 0.5


def test_rejects_odd_k_and_non_matrices():
    with pytest.raises(ValueError):
        native.quantize_pack_planar(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError):
        native.quantize_pack_planar(np.zeros((2, 3, 4), np.float32))


def test_every_csrc_file_is_package_data():
    """An installed copy of the port holds every source it builds at first
    use: the CUDA kernels and the native packer's csrc/quantpack.cpp."""
    import fnmatch
    import pathlib
    import tomllib

    root = pathlib.Path(native.__file__).resolve().parent
    with open(root.parent / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["fused4bit_tpu_torch"]
    files = [p.relative_to(root).as_posix() for p in (root / "csrc").iterdir() if p.is_file()]
    assert "csrc/quantpack.cpp" in files
    assert [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)] == []
