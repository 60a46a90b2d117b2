"""The native host-side packer: per-row INT4 quantize + planar pack on the CPU.

Counterpart of ``fused4bit_tpu/native.py``, with its own copy of the C++
source (``csrc/quantpack.cpp``), which divides by the scale where the JAX
copy multiplies by its reciprocal: the JAX library's bytes then part from
its quantizer's where a value sits next to a half-code boundary, and this
one's do not. The source is compiled with g++ at first use into
``ops._build.BUILD_DIR`` (``fused4bit_tpu_torch/_build/``), under a file name
that carries a hash of the source and the flags, and loaded with ctypes.
Without a compiler the NumPy fallback runs; both give
``quant.core.quantize``'s bytes, scales and zero points bit for bit
(``tests/test_torch_native.py``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from .ops._build import BUILD_DIR, CSRC

__all__ = ["native_available", "quantize_pack_planar", "dequantize_planar"]

_SRC = CSRC / "quantpack.cpp"
# -ffp-contract=off: no FMA may fuse the division's rounding with the zero
# point's addition (the quantizer rounds each).
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC")

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path():
    """The file of the library built from the source and flags as they are."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libquantpack_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; None when
    g++ is missing or fails."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = os.path.join(tmpdir, so.name)
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", tmp], check=True,
                               capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                return None
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.quantize_pack_planar_f32.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int64, _U8P,
                                             _F32P, _F32P]
    lib.quantize_pack_planar_f32.restype = None
    lib.dequantize_planar_f32.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, _F32P, _F32P,
                                          _F32P]
    lib.dequantize_planar_f32.restype = None
    return lib


def native_available() -> bool:
    """Whether the C++ library built and loaded."""
    return _load() is not None


def _numpy_quantize_pack(w: np.ndarray):
    """Pure-NumPy fallback, bit for bit the library's arithmetic."""
    n, k = w.shape
    mn = w.min(axis=1)
    mx = w.max(axis=1)
    scale = (mx - mn) / 15.0
    scale = np.where(mx == mn, np.maximum(np.abs(mx), 1.0) / 15.0, scale)
    scale = np.maximum(scale, 1e-8).astype(np.float32)
    zp = np.clip(np.round(-mn / scale), 0, 15).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None] + zp[:, None]), 0, 15).astype(np.uint8)
    half = k // 2
    lo = q[:, :half]
    hi = q[:, half:] ^ 0x8
    return ((hi << 4) | lo).astype(np.uint8), scale, zp


def quantize_pack_planar(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row INT4 quantize + planar pack of a host [n, k] float32 array.

    Returns (packed [n, k/2] u8, scales [n] f32, zero_points [n] f32) in the
    kernels' layout (``quant.core.pack_planar``). Each call that runs the
    library adds one to ``quantize_pack_planar.native_calls``.
    """
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"w must be [n, k], got shape {w.shape}")
    n, k = w.shape
    if k % 2:
        raise ValueError("k must be even")
    lib = _load()
    if lib is None:
        return _numpy_quantize_pack(w)
    packed = np.empty((n, k // 2), np.uint8)
    scales = np.empty((n,), np.float32)
    zps = np.empty((n,), np.float32)
    lib.quantize_pack_planar_f32(w.ctypes.data_as(_F32P), n, k, packed.ctypes.data_as(_U8P),
                                 scales.ctypes.data_as(_F32P), zps.ctypes.data_as(_F32P))
    quantize_pack_planar.native_calls += 1
    return packed, scales, zps


quantize_pack_planar.native_calls = 0


def dequantize_planar(packed: np.ndarray, scales: np.ndarray, zps: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`quantize_pack_planar`: f32 [n, k]."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    scales = np.ascontiguousarray(scales, np.float32)
    zps = np.ascontiguousarray(zps, np.float32)
    n, half = packed.shape
    if scales.shape != (n,) or zps.shape != (n,):
        raise ValueError(f"scales {scales.shape} and zero points {zps.shape} must be ({n},)")
    lib = _load()
    if lib is None:
        lo = (packed & 0x0F).astype(np.float32)
        hi = ((packed >> 4) ^ 0x8).astype(np.float32)
        q = np.concatenate([lo, hi], axis=1)
        return (q - zps[:, None]) * scales[:, None]
    out = np.empty((n, 2 * half), np.float32)
    lib.dequantize_planar_f32(packed.ctypes.data_as(_U8P), n, 2 * half,
                              scales.ctypes.data_as(_F32P), zps.ctypes.data_as(_F32P),
                              out.ctypes.data_as(_F32P))
    return out
