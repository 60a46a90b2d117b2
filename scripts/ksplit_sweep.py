#!/usr/bin/env python3
"""K9 (split-K grouped product) at several split counts against K2, on one GPU.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/ksplit_sweep.py

The `layer2` down projection's experts (8 x [4096, 14336], random weights
from a seed, per row) at T = 8 and 64 tokens (tile_m 16) and T = 600
(tile_m 128), skewed routing. Per T: K2, then K9 with 1, 2, 4, 7 and 14
splits (the C entry point called with each count; the wrapper picks its own),
then K2 again, each timed as chip_smoke.Timer times (CUDA events, L2 flushed,
median), and each K9 output's max|d| against K2's. Prints the card and one
line per T. Imports nothing of JAX.
"""
from __future__ import annotations

import torch

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import dispatch
from fused4bit_tpu_torch.ops import _build
from fused4bit_tpu_torch.quant import quantize

SPLITS = (1, 2, 4, 7, 14)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ksplit_sweep: no CUDA device")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    timer, lib = cs.Timer(dev), _build.library()
    e, n, k = 8, 4096, 14336
    qt = quantize(torch.randn((e, n, k), generator=gen, device=dev) * k ** -0.5)
    print(cs.card())
    for t, tile_m in ((8, 16), (64, 16), (600, 128)):
        routing, plan = cs._skewed_plan(t, e, 2, tile_m, gen, dev)
        xs = dispatch(torch.randn((t, k), generator=gen, device=dev).bfloat16(), routing, plan)
        gids, t_pad = plan.tile_group_ids, plan.t_pad
        rows_used = torch.empty((-(-t_pad // 16),), dtype=torch.int32, device=dev)
        y = torch.empty((t_pad, n), dtype=torch.bfloat16, device=dev)
        y2 = ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m)
        iters = 10 if t == 600 else 30

        def k9(splits):
            partial = torch.empty((splits, t_pad, n), dtype=torch.float32, device=dev)

            def run():
                _build.check(lib.f4b_grouped_int4_matmul_ksplit_bf16(
                    xs.data_ptr(), gids.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(),
                    qt.zero_points.data_ptr(), rows_used.data_ptr(), partial.data_ptr(),
                    y.data_ptr(), t_pad, n, k, tile_m, splits, _build.stream_of(xs)), "K9")
            return run

        def k2():
            return ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m)

        row = {"K2 first": timer(k2, iters=iters)}
        for splits in SPLITS:
            run = k9(splits)
            run()
            torch.cuda.synchronize()
            row[f"K9 {splits} ms"] = timer(run, iters=iters)
            row[f"K9 {splits} max|d| vs K2"] = (y.float() - y2.float()).abs().max().item()
        row["K2 last"] = timer(k2, iters=iters)
        print(f"T={t} tile_m={tile_m} T_pad={t_pad} tokens per expert "
              f"{routing.tokens_per_expert.tolist()}: {row}")


if __name__ == "__main__":
    main()
