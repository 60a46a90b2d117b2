#!/usr/bin/env python3
"""The w4a8 grouped expert kernels K10, K11 and K14 on one GPU: where their
time goes, and the launch shapes of the int8 tensor-core body.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/grouped_a8_sweep.py [--profile] [--sweep]

``--profile`` (the default when neither is given) times, at the `layer2`
expert shapes (8 experts, gate/up N=14336 K=4096 and down N=4096 K=14336,
random weights from a seed, skewed top-2 routing), at the decode check (T=8,
tile_m 32) and at prefill (T=600, tile_m 128), bf16 activations:

* each wrapper call with CUDA events, the L2 cache flushed before each call
  (``chip_smoke.Timer``): K10 ``grouped_int4_matmul_a8``, K11
  (``fuse_quant=True``) and K14
  ``grouped_int4_matmul_per_group_a8`` (per group of 128, planar_groups);
* under ``torch.profiler``, the device time per call split into the host
  quantizer's kernels, the pass over x before the main kernel (rows in use,
  and the row sums of the int8 body), the main kernel, and the second pass
  that adds a K split's partials.

It calls only the public wrappers, so the same script times a parent tree
(``cd <parent checkout> && env PYTHONPATH=. python3 <this script>``).

``--sweep`` launches the int8 tensor-core body (``csrc/int8_mma.cuh``) at
the launch rule's shape (``ops._int8._a8_mma_launch``) and at the
other candidate shapes (ws chunks per warp, kw warps along K per CTA, splits
CTAs along K), each held bit for bit against the rule's output (K10's integers
are exact; K14's f32 fold is compared with its plain version at the same
shape), and times each cold and under the profiler.

One JSON line per measurement; the card's name and power limit lead the
output. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import dispatch
from fused4bit_tpu_torch.quant import quantize

E, FFN, HIDDEN = 8, 14336, 4096
PROJECTIONS = {"gate_up": (FFN, HIDDEN), "down": (HIDDEN, FFN)}
SHAPES = {"decode": (8, 32), "prefill": (600, 128)}
# K/2 cut into this many slices, with this many warps along K per CTA (the
# rest are CTAs along K): one to sixteen slices, and eight also as 4 x 2.
SLICES = ((1, 1), (2, 2), (4, 4), (8, 8), (8, 4), (16, 8))


def candidates(k: int, gs: int) -> list:
    """Launch shapes ``(ws, kw, splits)`` timed beside the rule's, in whole
    chunks (whole groups for K14) of K/2."""
    from fused4bit_tpu_torch.ops._int8 import _i8_chunk

    cb = _i8_chunk(gs)
    unit = gs // cb if gs else 1
    units = -(-(k // 2) // (cb * unit))
    out = []
    for slices, kw in SLICES:
        if slices <= units:
            ws = unit * -(-units // slices)
            out.append((ws, kw, -(-units * unit // (kw * ws))))
    return list(dict.fromkeys(out))


def _part(name: str) -> str:
    """Which part of a w4a8 grouped call a device kernel belongs to."""
    if "bitwise_not" in name:
        return "flush"
    if "rows_in_use" in name or "a8_prepass" in name:
        return "prepass"
    if "int8_mma_reduce" in name:
        return "second_pass"
    if "a8_rows_kernel" in name or "int8_mma_kernel" in name:
        return "main"
    return "quantizer"


def device_parts(fn, flush, calls=10) -> dict:
    """Device ms per call of each part (see :func:`_part`), the L2 flushed
    before each call by a kernel of its own (left out of the sums), and the
    device kernels launched per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    out, main, kernels = {}, [], 0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        part = _part(e.key)
        out[part] = out.get(part, 0.0) + (e.cuda_time_total if t is None else t) / calls / 1e3
        if part == "main":
            main.append(e.key[:80])
        if part != "flush" and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += e.count
    out.pop("flush", None)
    out["total"] = sum(out.values())
    out["main_kernels"] = main
    out["kernels_per_call"] = kernels / calls
    return out


def _inputs(gen, proj, shape):
    n, k = PROJECTIONS[proj]
    t, tile_m = SHAPES[shape]
    routing, plan = cs._skewed_plan(t, E, 2, tile_m, gen, "cuda")
    xs = dispatch(torch.randn((t, k), generator=gen, device="cuda").bfloat16(), routing, plan)
    return xs, plan.tile_group_ids, tile_m, routing.tokens_per_expert.tolist()


def profile_wrappers(gen, card) -> None:
    timer = cs.Timer("cuda")
    flush = timer.flush
    for proj, (n, k) in PROJECTIONS.items():
        w = torch.randn((E, n, k), generator=gen, device="cuda") * k ** -0.5
        weights = {"K10": quantize(w), "K14": cs._pg_quantize(w)}
        weights["K11"] = weights["K10"]
        del w
        for shape in SHAPES:
            xs, gids, tile_m, loads = _inputs(gen, proj, shape)
            calls = {
                "K10": lambda: ops.grouped_int4_matmul_a8(xs, gids, weights["K10"], tile_m=tile_m),
                "K11": lambda: ops.grouped_int4_matmul_a8(xs, gids, weights["K11"], tile_m=tile_m,
                                                          fuse_quant=True),
                "K14": lambda: ops.grouped_int4_matmul_per_group_a8(xs, gids, weights["K14"],
                                                                    tile_m=tile_m),
            }
            for kernel, fn in calls.items():
                qt = weights[kernel]
                t = SHAPES[shape][0]
                line = dict(kernel=kernel, projection=proj, shape=shape, t=t, tile_m=tile_m,
                            n=n, k=k, t_pad=xs.shape[0], tokens_per_expert=loads,
                            wrapper_cold_ms=timer(fn, iters=20 if shape == "decode" else 5),
                            device_ms=device_parts(fn, flush),
                            **cs.grouped_bound(xs, gids, qt, 2 * t, a8=True), card=card)
                print(json.dumps(line), flush=True)
        del weights
        torch.cuda.empty_cache()


def sweep_shapes(gen, card) -> None:
    # the int8 body's launcher and rule (ops._int8; --profile alone also times
    # older trees)
    from fused4bit_tpu_torch.ops._int8 import _a8_mma_launch, _launch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer("cuda")
    for proj, (n, k) in PROJECTIONS.items():
        w = torch.randn((E, n, k), generator=gen, device="cuda") * k ** -0.5
        weights = {"K10": quantize(w), "K14": cs._pg_quantize(w)}
        del w
        for shape in SHAPES:
            xs, gids, tile_m, loads = _inputs(gen, proj, shape)
            for kernel, qt in weights.items():
                gs = qt.group_size if kernel == "K14" else 0
                rule = _a8_mma_launch(n, k, gs, sms)
                ref = _launch(xs, qt, kernel, gids=gids, tile_m=tile_m, launch=rule)
                line = dict(kernel=kernel, projection=proj, shape=shape, n=n, k=k,
                            tokens_per_expert=loads, rule=list(rule), card=card)
                for cand in dict.fromkeys([rule, *candidates(k, gs)]):
                    fn = lambda: _launch(xs, qt, kernel, gids=gids,  # noqa: E731
                                         tile_m=tile_m, launch=cand)
                    y = fn()
                    if kernel == "K10" or cand == rule:
                        same = torch.equal(y, ref)
                    else:  # another split folds in another order: its own plain version
                        plain = ops.grouped_int4_matmul_per_group_a8_reference(
                            xs, gids, qt, tile_m=tile_m, launch=cand)
                        same = torch.equal(y, plain)
                    if not same:
                        raise AssertionError(f"{kernel} {proj} {shape} {cand}: not bit-equal")
                    line[str(list(cand))] = dict(
                        cold_ms=timer(fn, iters=20 if shape == "decode" else 5),
                        device_ms=device_parts(fn, timer.flush))
                print(json.dumps(line), flush=True)
        del weights
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grouped_a8_sweep: no CUDA device")
    card = cs.card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8)
    with torch.no_grad():
        if args.profile or not args.sweep:
            profile_wrappers(gen, card)
        if args.sweep:
            sweep_shapes(gen, card)


if __name__ == "__main__":
    main()
