#!/usr/bin/env python3
"""K1's row threshold on one GPU: the tensor-core kernel against dequantize +
torch.matmul, per row count, at the `layer2` linear shapes.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/linear_sweep.py

For each [N, K] weight of a `layer2` linear (q/o 4096 x 4096, k/v 1024 x
4096, the INT4 router 8 x 4096, the LM head 8192 x 4096; random weights from
a seed, quantized per row) and each M in ROWS, times
``ops.int4_matmul(x, qt, prefill_threshold=...)`` on the kernel (K1) and on
the dequantize + matmul path, in turns (kernel, dense, dense, kernel), each
the median of ITERS calls with CUDA events and the L2 cache flushed before
every call (chip_smoke.Timer). Prints one JSON line per (N, M), then, per
shape, the crossover (the first M at which the dense path is faster, the
faster of each path's two readings) and the threshold this gives
``int4_matmul``: the largest M in ROWS below every shape's crossover, since
one threshold serves every linear. The card's name and power limit lead the
output. Imports nothing of JAX.
"""
from __future__ import annotations

import json

import torch

from chip_smoke import Timer, card
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.quant import quantize

SHAPES = ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096))
ROWS = (16, 32, 64, 128, 256, 512, 640)
ITERS = 20
KERNEL, DENSE = 1 << 30, 0  # prefill_threshold that keeps every M on K1, or none


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("linear_sweep: no CUDA device")
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer("cuda")
    crossover = {}
    with torch.no_grad():
        for n, k in SHAPES:
            qt = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
                ms = {"kernel": [], "dense": []}
                for name in ("kernel", "dense", "dense", "kernel"):
                    threshold = KERNEL if name == "kernel" else DENSE
                    ms[name].append(timer(lambda: ops.int4_matmul(x, qt, prefill_threshold=threshold),
                                          iters=ITERS))
                kernel, dense = min(ms["kernel"]), min(ms["dense"])
                if dense < kernel and n not in crossover:
                    crossover[n] = m
                print(json.dumps(dict(n=n, k=k, m=m, kernel_ms=ms["kernel"],
                                      dense_ms=ms["dense"])), flush=True)
            crossover.setdefault(n, None)
    first = min((m for m in crossover.values() if m is not None), default=None)
    threshold = max((m for m in ROWS if first is None or m < first), default=None)
    print(json.dumps({"crossover_rows": {f"{n}x{k}": crossover[n] for n, k in SHAPES},
                      "threshold": threshold}))


if __name__ == "__main__":
    main()
