"""Minimal native safetensors reader/writer (pure NumPy, zero deps).

The port's own copy of ``fused4bit_tpu/models/safetensors_io.py`` (the port
imports nothing of the JAX package). The format: a little-endian u64 header
length, a JSON header mapping each tensor name to ``{"dtype", "shape",
"data_offsets"}`` into the byte buffer that follows. NumPy in and out, as in
the JAX package; ``models.convert`` moves each array to the device as it
quantizes it.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np

__all__ = ["load_safetensors", "save_safetensors"]

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
    # BF16 has no numpy dtype: loaded as u16 and upcast via bit tricks below
    "BF16": np.uint16,
}
_NAMES = {
    np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
    np.dtype(np.bool_): "BOOL",
}


def _bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    out = raw_u16.astype(np.uint32) << 16
    return out.view(np.float32)


def load_safetensors(path: str, upcast_bf16: bool = True) -> Dict[str, np.ndarray]:
    """Load every tensor in a .safetensors file into a flat numpy dict.

    BF16 tensors are upcast to float32 (numpy has no bfloat16) unless
    ``upcast_bf16=False``, in which case the raw uint16 bits are returned.
    """
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = meta["dtype"]
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_DTYPES[dt]).reshape(meta["shape"])
        if dt == "BF16" and upcast_bf16:
            arr = _bf16_to_f32(arr)
        out[name] = arr
    return out


def save_safetensors(
    path: str, tensors: Mapping[str, np.ndarray], metadata: Mapping[str, str] = None
) -> None:
    """Write a flat dict of numpy arrays as a .safetensors file."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs = []
    off = 0
    for name, a in tensors.items():
        a = np.ascontiguousarray(a)
        if a.dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {a.dtype} for {name!r}")
        b = a.tobytes()
        header[name] = {
            "dtype": _NAMES[a.dtype],
            "shape": list(a.shape),
            "data_offsets": [off, off + len(b)],
        }
        blobs.append(b)
        off += len(b)
    hj = json.dumps(header).encode()
    # pad header to 8-byte alignment (spec recommendation)
    pad = (8 - len(hj) % 8) % 8
    hj += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for b in blobs:
            f.write(b)
