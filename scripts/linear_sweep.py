#!/usr/bin/env python3
"""K1's and K7's row thresholds on one GPU. By default K1's: at the `layer2`
and Mixtral-8x7B linears, its tall tile (``csrc/int4_mma.cuh``), the
warpgroup body (``csrc/grouped_wgmma.cu``) and dequantize + torch.matmul;
with ``--pg``, K7's: its tall tile against the body at the per-group cells'
linears.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/linear_sweep.py [--pg]

For each [N, K] weight of SHAPES (`layer2`'s q/o 4096 x 4096, k/v 1024 x
4096, INT4 router 8 x 4096 and LM head 8192 x 4096, which are also
Mixtral-8x7B's but for its LM head 32000 x 4096; random weights from a
seed, quantized per row) and each M in ROWS, times ``ops.int4_matmul`` on
the tall tile (``WG_MIN_LINEAR_ROWS`` moved out of the way), on the body
(where it takes the shape: not the router, N=8) and on the dense path
(``prefill_threshold`` 0), in turns (tall, body, dense, dense, body, tall),
each the median of ITERS calls with CUDA events and the L2 cache flushed
before every call (chip_smoke.Timer). Prints one JSON line per (N, M) with
the bound (chip_smoke.linear_bound). Then, at the 8x7B cell's 576 rows,
the body at the rule's launch (``_wg_linear_launch``) beside other launches
(all items whole, all cut into 2, 3 or 4 ranges, the rule's whole items
with one range more or fewer). Last line: per shape the crossover (the
first M at which the dense path beats the kernel K1 runs there, the body or
the tall tile, the faster of each path's two readings); the threshold this
gives ``int4_matmul``: the largest M in ROWS below every shape's crossover,
since one threshold serves every linear (the largest M swept where there
is none); the first M from which the body beats the tall tile at every
shape it takes (``WG_MIN_LINEAR_ROWS``); and ``K1_chunk_us``, the
per-chunk cost of ``_wg._WG_CHUNK_US`` fitted to the all-whole launches at
576 rows (a CTA's time over its waves of items, less the fixed cost per
item, over the chunks of an item; the median over the shapes). The card's
name and power limit lead the output. Imports nothing of JAX.

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
import statistics
from unittest import mock

import torch

from chip_smoke import PG_LINEAR_SHAPES, Timer, _pg_quantize, card, linear_bound
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _wg
from fused4bit_tpu_torch.quant import quantize

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")

SHAPES = ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096), (32000, 4096))
ROWS = (65, 128, 256, 384, 512, 576, 640, 1024, 2048, 4096)
CELL_ROWS = 576  # Mixtral-8x7B's offline cell
ITERS = 20
KERNEL, DENSE = 1 << 30, 0  # prefill_threshold that keeps every M on K1, or none


# rows above 64 only: at 64 and below K7 keeps its decode tile whatever the rule
PG_ROWS = (65, 72, 80, 96, 128, 160, 192, 256, 320, 384, 512, 640, 896, 1024)


def _k7(x, qt, wg: bool):
    """K7 on the warpgroup body (wg) or on the tall tile, whatever M."""
    with mock.patch.object(im, "WG_MIN_LINEAR_ROWS", 65 if wg else 1 << 30):
        return ops.int4_matmul_per_group(x, qt)


def _k1(x, qt, path: str):
    """K1 on the tall tile, the warpgroup body (where it takes the shape) or
    the dense path, whatever M."""
    if path == "dense":
        return ops.int4_matmul(x, qt, prefill_threshold=DENSE)
    with mock.patch.object(im, "WG_MIN_LINEAR_ROWS", 65 if path == "wg" else 1 << 30):
        return ops.int4_matmul(x, qt, prefill_threshold=KERNEL)


def _held(full: int, s: int):
    """The body's launch rule held at ``full`` whole items (None: all) and
    ``s`` ranges of K/2 for the other slices."""
    def rule(m, n, k, sms, kernel):
        blocks = -(-m // _wg._WG_ROWS)
        items = (n // _wg._WG_SLICE) * blocks
        whole = items if full is None else full
        return whole, s, min(whole + (items - whole) * s, sms)
    return mock.patch.object(_wg, "_wg_linear_launch", rule)


def _launches(run, m, n, k, kernel, timer) -> dict:
    """The body's ms at the rule's launch and at the others the sweeps time,
    and the rule's launch."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = _wg._wg_linear_launch(m, n, k, sms, kernel)
    launch_ms = {"rule": timer(run, iters=10)}
    chunks = (k // 2) // _wg._WG_CHUNK
    for full, s in ((None, 1), (0, 2), (0, 3), (0, 4), (rule[0], rule[1] + 1),
                    (rule[0], max(2, rule[1] - 1))):
        if (s - 1) * -(-chunks // s) >= chunks:
            continue                                   # a range would be empty
        with _held(full, s):
            launch_ms[f"{full},{s}"] = timer(run, iters=10)
    return dict(n=n, k=k, m=m, rule=rule, launch_ms=launch_ms)


def pg_main() -> None:
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer("cuda")
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
                print(json.dumps(_launches(lambda: _k7(x, qt, True), cell_m, n, k, "K7", timer)),
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    crossover, wg_wins, chunk_us = {}, {}, {}
    with torch.no_grad():
        for n, k in SHAPES:
            qt = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
            body = _wg._wg_takes(torch.bfloat16, 0, n, k)
            paths = ("tall", "wg", "dense") if body else ("tall", "dense")
            kernel = "wg" if body else "tall"
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
                ms = {path: [] for path in paths}
                for path in paths + paths[::-1]:
                    ms[path].append(timer(lambda: _k1(x, qt, path), iters=ITERS))
                best = {path: min(v) for path, v in ms.items()}
                if best["dense"] < best[kernel] and n not in crossover:
                    crossover[n] = m
                if body:
                    wg_wins.setdefault(n, []).append(best["wg"] < best["tall"])
                bound = linear_bound(x, qt)["bound_ms"]
                print(json.dumps(dict(n=n, k=k, m=m, **{f"{p}_ms": v for p, v in ms.items()},
                                      bound_ms=bound,
                                      roofline={p: 100 * bound / v for p, v in best.items()})),
                      flush=True)
            crossover.setdefault(n, None)
            if body:
                x = torch.randn((CELL_ROWS, k), generator=gen, device="cuda").bfloat16()
                line = _launches(lambda: _k1(x, qt, "wg"), CELL_ROWS, n, k, "K1", timer)
                print(json.dumps(line), flush=True)
                items = (n // _wg._WG_SLICE) * -(-CELL_ROWS // _wg._WG_ROWS)
                waves = -(-items // sms)
                chunk_us[n] = ((1e3 * line["launch_ms"]["None,1"] / waves - _wg._WG_ITEM_US)
                               / ((k // 2) // _wg._WG_CHUNK))
            del qt
            torch.cuda.empty_cache()
    first = min((m for m in crossover.values() if m is not None), default=None)
    threshold = max(m for m in ROWS if first is None or m < first)
    start = next((m for i, m in enumerate(ROWS) if all(all(f[i:]) for f in wg_wins.values())),
                 None)
    print(json.dumps({"crossover_rows": {f"{n}x{k}": crossover[n] for n, k in SHAPES},
                      "threshold": threshold, "WG_MIN_LINEAR_ROWS": start,
                      "chunk_us": {f"{n}x4096": v for n, v in chunk_us.items()},
                      "K1_chunk_us": statistics.median(chunk_us.values())}))


if __name__ == "__main__":
    main()
