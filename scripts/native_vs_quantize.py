#!/usr/bin/env python3
"""Count the bytes where the JAX package's native packer parts from the
quantizer, at full `layer2` widths, on the host CPU.

The JAX library (fused4bit_tpu/csrc/quantpack.cpp, built by
fused4bit_tpu/native.py with -O3 -march=native) multiplies by the scale's
reciprocal; the port's library (fused4bit_tpu_torch/csrc/quantpack.cpp,
-ffp-contract=off) divides, as both packages' `quantize` do. For seeded
N(0, 0.02) weights of each shape this prints the packed bytes, scales and
zero points of each library that differ from the port's `quantize`. The
JAX library's count depends on the host CPU (-march=native decides whether
the multiply-add is contracted into an FMA).

    env PYTHONPATH=. python3 scripts/native_vs_quantize.py
"""
from __future__ import annotations

import os
import platform

import numpy as np
import torch

from fused4bit_tpu import native as jax_native
from fused4bit_tpu_torch import native
from fused4bit_tpu_torch.quant import quantize

SHAPES = ((4096, 4096), (14336, 4096), (4096, 14336))


def main() -> None:
    print(f"host: {platform.processor() or platform.machine()}, {os.cpu_count()} cores; JAX "
          f"library built: {jax_native.native_available()}, port library built: "
          f"{native.native_available()}")
    rng = np.random.default_rng(0)
    for shape in SHAPES:
        w = rng.normal(0.0, 0.02, shape).astype(np.float32)
        qt = quantize(torch.from_numpy(w))
        want = (qt.packed.numpy(), qt.scales.numpy(), qt.zero_points.numpy())
        for name, lib in (("JAX library", jax_native), ("port library", native)):
            got = lib.quantize_pack_planar(w)
            counts = [int((g != v).sum()) for g, v in zip(got, want)]
            print(f"{shape}: {name} vs quantize: {counts[0]} packed bytes, {counts[1]} scales, "
                  f"{counts[2]} zero points differ")


if __name__ == "__main__":
    main()
