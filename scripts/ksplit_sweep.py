#!/usr/bin/env python3
"""K9 (the k-split grouped product) at candidate launch shapes of the
tensor-core body against K2, on one GPU.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/ksplit_sweep.py

The `layer2` down projection's experts (8 x [4096, 14336], random weights
from a seed, per row) at T = 8 and 64 tokens (tile_m 16) and T = 600
(tile_m 128), skewed routing, bf16. Per T: K2 through its wrapper (its own
launch rule), then the body with grouped addressing
(``ops._mma._launch(..., launch=)``) at K9's rule
(``_ksplit_mma_launch``) and at each candidate of :data:`CANDIDATES`, then K2
again. Each is timed as ``chip_smoke.Timer`` times (CUDA events, L2 flushed,
median), its device time split under ``torch.profiler`` into the first pass
(rows in use), the main kernel and the second pass
(``grouped_mma_sweep.device_parts``), and its output held
against K2's at K2's bf16 bar with its padding rows exactly 0. One JSON line
per T, led by the card's name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import json

import torch

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import dispatch
from fused4bit_tpu_torch.ops._mma import _ksplit_mma_launch, _launch
from fused4bit_tpu_torch.quant import quantize
from grouped_mma_sweep import device_parts

# (CTAs along K, warps along K per CTA): K/2 cut into splits * kw slices of
# whole chunks of 64 packed bytes
CANDIDATES = ((2, 1), (2, 2), (4, 1), (4, 2), (7, 1), (7, 2))


def shape_of(k: int, splits: int, kw: int) -> tuple:
    """The launch ``(ws, kw, splits)`` that cuts K/2 into ``splits * kw``
    slices of whole chunks."""
    chunks = -(-(k // 2) // 64)
    ws = 8 * -(-chunks // (kw * splits))
    return ws, kw, -(-8 * chunks // (kw * ws))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ksplit_sweep: no CUDA device")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    timer = cs.Timer(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    e, n, k = 8, 4096, 14336
    qt = quantize(torch.randn((e, n, k), generator=gen, device=dev) * k ** -0.5)
    card = cs.card()
    print(card)
    rule = _ksplit_mma_launch(n, k, sms)
    with torch.no_grad():
        for t, tile_m in ((8, 16), (64, 16), (600, 128)):
            routing, plan = cs._skewed_plan(t, e, 2, tile_m, gen, dev)
            xs = dispatch(torch.randn((t, k), generator=gen, device=dev).bfloat16(), routing,
                          plan)
            gids = plan.tile_group_ids
            pad = xs.abs().sum(dim=1) == 0
            iters = 5 if t == 600 else 20

            def k2():
                return ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m)

            y2 = k2()
            tol = cs.BF16_REL_TOL * y2.float().abs().max().item()
            line = dict(t=t, tile_m=tile_m, n=n, k=k, t_pad=plan.t_pad,
                        tokens_per_expert=routing.tokens_per_expert.tolist(), rule=list(rule),
                        **cs.grouped_bound(xs, gids, qt, 2 * t), card=card)
            line["K2 first"] = dict(ms=timer(k2, iters=iters),
                                    device_ms=device_parts(k2, timer.flush))
            cands = [rule] + [shape_of(k, s, w) for s, w in CANDIDATES]
            for cand in dict.fromkeys(cands):
                def k9(cand=cand):
                    return _launch(xs, qt, "K9", gids=gids, tile_m=tile_m, launch=cand)

                y = k9()
                torch.cuda.synchronize()
                err = (y.float() - y2.float()).abs().max().item()
                if not err <= tol or not bool((y[pad] == 0).all()):
                    raise AssertionError(f"K9 {cand} T={t}: max|d| {err} vs K2 (tol {tol}), "
                                         "or padding rows not 0")
                line[str(list(cand))] = dict(ms=timer(k9, iters=iters),
                                             device_ms=device_parts(k9, timer.flush),
                                             max_abs_vs_k2=err)
            line["K2 last"] = dict(ms=timer(k2, iters=iters),
                                   device_ms=device_parts(k2, timer.flush))
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
