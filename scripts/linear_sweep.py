#!/usr/bin/env python3
"""K1's row threshold on one GPU: the tensor-core kernel against dequantize +
torch.matmul, per row count, at the `layer2` linear shapes; with ``--pg``,
K7's: its tall tile (``csrc/int4_mma.cuh``) against the warpgroup body
(``csrc/grouped_wgmma.cu``) at the per-group cells' linears.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/linear_sweep.py [--pg]

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

``--pg``: the K7 linears of K-EXAONE-236B (``chip_smoke.PG_LINEAR_SHAPES``,
896 rows in its cell) and Mixtral-8x22B (384 rows), per group of 128
(planar_groups); it times only (``chip_smoke.check_pg_linear_wg`` and
``tests/test_torch_pg_linear_wg_chip.py`` hold the body to the plain
version). Per shape, ``ops.int4_matmul_per_group`` timed at each M in
PG_ROWS on the tall tile and on the body (``WG_MIN_LINEAR_ROWS`` moved out
of the way or down to 65), in turns (old, new, new, old); then, at the
cell's rows, the body at the rule's launch (``_wg_linear_launch``: whole
items, ranges of the slices left) beside other launches: all whole, all
cut into 2, 3 or 4 ranges, the rule's whole items with one range more or
fewer (``tests/test_torch_pg_linear_wg.py``'s ``TIMED_LAUNCHES`` holds one
such reading). Last line: each shape's crossover (the first M from which
the body wins at every larger M) and ``WG_MIN_LINEAR_ROWS``: the first M
in PG_ROWS from which the body wins at every shape.
"""
from __future__ import annotations

import argparse
import importlib
import json
from unittest import mock

import torch

from chip_smoke import PG_LINEAR_SHAPES, Timer, _pg_quantize, card, linear_bound
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _wg
from fused4bit_tpu_torch.quant import quantize

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")

SHAPES = ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096))
ROWS = (16, 32, 64, 128, 256, 512, 640)
ITERS = 20
KERNEL, DENSE = 1 << 30, 0  # prefill_threshold that keeps every M on K1, or none


# rows above 64 only: at 64 and below K7 keeps its decode tile whatever the rule
PG_ROWS = (65, 72, 80, 96, 128, 160, 192, 256, 320, 384, 512, 640, 896, 1024)


def _k7(x, qt, wg: bool):
    """K7 on the warpgroup body (wg) or on the tall tile, whatever M."""
    with mock.patch.object(im, "WG_MIN_LINEAR_ROWS", 65 if wg else 1 << 30):
        return ops.int4_matmul_per_group(x, qt)


def _held(full: int, s: int):
    """The body's launch rule held at ``full`` whole items (None: all) and
    ``s`` ranges of K/2 for the other slices."""
    def rule(m, n, k, sms):
        blocks = -(-m // _wg._WG_ROWS)
        items = (n // _wg._WG_SLICE) * blocks
        whole = items if full is None else full
        return whole, s, min(whole + (items - whole) * s, sms)
    return mock.patch.object(_wg, "_wg_linear_launch", rule)


def pg_main() -> None:
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wins = {}
    with torch.no_grad():
        for cell_m, shapes in PG_LINEAR_SHAPES.items():
            for n, k in shapes:
                qt = _pg_quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
                faster = []
                for m in PG_ROWS:
                    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
                    ms = {"old": [], "new": []}
                    for name in ("old", "new", "new", "old"):
                        ms[name].append(timer(lambda: _k7(x, qt, name == "new"), iters=10))
                    bound = linear_bound(x, qt)["bound_ms"]
                    faster.append(min(ms["new"]) < min(ms["old"]))
                    print(json.dumps(dict(n=n, k=k, m=m, old_ms=ms["old"], new_ms=ms["new"],
                                          bound_ms=bound,
                                          new_roofline=100 * bound / min(ms["new"]))), flush=True)
                wins[f"{n}x{k}"] = faster
                x = torch.randn((cell_m, k), generator=gen, device="cuda").bfloat16()
                rule = _wg._wg_linear_launch(cell_m, n, k, sms)
                launch_ms = {"rule": timer(lambda: _k7(x, qt, True), iters=10)}
                chunks = (k // 2) // _wg._WG_CHUNK
                for full, s in ((None, 1), (0, 2), (0, 3), (0, 4), (rule[0], rule[1] + 1),
                                (rule[0], max(2, rule[1] - 1))):
                    if (s - 1) * -(-chunks // s) >= chunks:
                        continue                                   # a range would be empty
                    with _held(full, s):
                        launch_ms[f"{full},{s}"] = timer(lambda: _k7(x, qt, True), iters=10)
                print(json.dumps(dict(n=n, k=k, m=cell_m, rule=rule, launch_ms=launch_ms)),
                      flush=True)
                del qt
                torch.cuda.empty_cache()
    crossover = {}
    for shape, faster in wins.items():
        crossover[shape] = next((m for i, m in enumerate(PG_ROWS) if all(faster[i:])), None)
    start = next((m for i, m in enumerate(PG_ROWS)
                  if all(all(f[i:]) for f in wins.values())), None)
    print(json.dumps({"crossover_rows": crossover, "WG_MIN_LINEAR_ROWS": start}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("linear_sweep: no CUDA device")
    parser = argparse.ArgumentParser()
    parser.add_argument("--pg", action="store_true",
                        help="K7's tall tile against the warpgroup body at the per-group cells")
    if parser.parse_args().pg:
        return pg_main()
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
