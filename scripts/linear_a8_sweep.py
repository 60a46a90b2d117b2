#!/usr/bin/env python3
"""The w4a8 linears K8 (per group), K5 (per row, XLA's folded quantizer)
and K4 (per row, the host quantizer's division) on one GPU: where their
time goes, and the launch shapes of the int8 tensor-core body they run.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/linear_a8_sweep.py [--profile] [--sweep]

At the `layer2` linear shapes (K=4096; N=4096 for q and o, 1024 for k and v,
8192 for the lm_head, and for K5 and K4 also 8 for the router; random
weights from a seed, quantized per group of 128 in the planar_groups layout
for K8, per row for K5 and K4), and for K4 also at deep K (N=4096, K=14336,
where the JAX fuse gate picks it), bf16 activations:

``--profile`` (the default when neither is given) times, at M = 8 (a
decode step), 40 (the self-draft verify) and 640 (the long prefill),
``ops.int4_matmul_per_group_a8`` (K8), ``ops.int4_matmul_a8(...,
fuse_quant=True)`` (K5) and ``ops.int4_matmul_a8(..., fuse_quant=False)``
(K4): each wrapper call with CUDA events, the L2 cache
flushed before each call (``chip_smoke.Timer``), and under
``torch.profiler`` its device time split into the host quantizer's kernels,
the first pass over x (quantize and sum), the main kernel and the second
pass that adds a K split's partials, the kernels it launches per call, and
the gap (wrapper time less the device time of its kernels). It calls only
the public wrappers, so the same script times a parent tree (``cd <parent
checkout> && env PYTHONPATH=. python3 <this script> --profile``).

``--sweep`` launches the int8 body at M = 8 and 640 at the launch rule's
shape (``ops._int8._linear_a8_launch``) and at other candidates (ws
chunks per warp, kw warps along K per CTA, splits CTAs along K; whole
groups), each held bit for bit against the plain version at the same shape
(``int4_matmul_per_group_a8_reference(..., launch=)``), and times each cold
and under the profiler; the same for K4 at deep K at its rule's shape
(``ops._int8._row_a8_launch``) and per-row candidates, each held bit for
bit against ``int4_matmul_a8_reference(..., fuse_quant=False)`` (its int32
sums are exact at every shape).

One JSON line per measurement; the card's name and power limit lead the
output. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.quant import quantize
from grouped_a8_sweep import device_parts

K, GS = 4096, 128
PROJECTIONS = {"q_o": 4096, "k_v": 1024, "lm_head": 8192}
K5_PROJECTIONS = {**PROJECTIONS, "router": 8}
ROWS = (8, 40, 640)
K4_DEEP = (4096, 14336)   # (N, K) of the w4a8 linear at deep K
# K/2 cut into this many slices of whole groups, with this many warps along
# K per CTA (the rest are CTAs along K).
SLICES = ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (8, 4), (8, 8), (16, 8))


def candidates(k: int, gs: int) -> list:
    """Launch shapes ``(ws, kw, splits)`` timed beside the rule's: K/2 in
    whole groups (``gs`` 0, per row: chunks of 64 packed bytes), cut into the
    slices of :data:`SLICES`."""
    from fused4bit_tpu_torch.ops._int8 import _i8_chunk

    unit = gs // _i8_chunk(gs) if gs else 1          # chunks per group
    groups = -(-(k // 2) // (gs or 64))
    out = []
    for slices, kw in SLICES:
        if slices <= groups:
            ws = unit * -(-groups // slices)
            out.append((ws, kw, -(-groups * unit // (kw * ws))))
    return list(dict.fromkeys(out))


def _weights(gen, n):
    return cs._pg_quantize(torch.randn((n, K), generator=gen, device="cuda") * K ** -0.5)


def _timed(timer, fn, m) -> dict:
    """A call's cold wrapper time, its device parts and the gap between."""
    cold = timer(fn, iters=5 if m == 640 else 20)
    parts = device_parts(fn, timer.flush)
    return dict(wrapper_cold_ms=cold, device_ms=parts, gap_ms=cold - parts["total"])


def profile_wrapper(gen, card) -> None:
    timer = cs.Timer("cuda")
    for proj, n in K5_PROJECTIONS.items():
        qt = _weights(gen, n) if proj in PROJECTIONS else None
        q5 = quantize(torch.randn((n, K), generator=gen, device="cuda") * K ** -0.5)
        x640 = torch.randn((640, K), generator=gen, device="cuda").bfloat16()
        for m in ROWS:
            x = x640[:m].contiguous()
            if qt is not None:
                fn = lambda: ops.int4_matmul_per_group_a8(x, qt)  # noqa: E731
                print(json.dumps(dict(kernel="K8", projection=proj, m=m, n=n, k=K, gs=GS,
                                      **_timed(timer, fn, m),
                                      **cs.linear_bound(x, qt, a8=True), card=card)), flush=True)
            for kernel, fuse in (("K5", True), ("K4", False)):
                fn = lambda: ops.int4_matmul_a8(x, q5, fuse_quant=fuse)  # noqa: E731
                print(json.dumps(dict(kernel=kernel, projection=proj, m=m, n=n, k=K,
                                      **_timed(timer, fn, m), **cs.linear_bound(x, q5, a8=True),
                                      card=card)), flush=True)
        del qt, q5
        torch.cuda.empty_cache()
    n, k = K4_DEEP
    q4 = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
    x640 = torch.randn((640, k), generator=gen, device="cuda").bfloat16()
    for m in ROWS:
        x = x640[:m].contiguous()
        fn = lambda: ops.int4_matmul_a8(x, q4, fuse_quant=False)  # noqa: E731
        print(json.dumps(dict(kernel="K4", projection="deep_k", m=m, n=n, k=k,
                              **_timed(timer, fn, m), **cs.linear_bound(x, q4, a8=True),
                              card=card)), flush=True)


def sweep_shapes(gen, card) -> None:
    # the int8 body's launcher and K8's rule (absent from trees before K8 ran
    # the int8 body, which --profile alone can time)
    from fused4bit_tpu_torch.ops._int8 import _launch, _linear_a8_launch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer("cuda")
    for proj, n in PROJECTIONS.items():
        qt = _weights(gen, n)
        x640 = torch.randn((640, K), generator=gen, device="cuda").bfloat16()
        rule = _linear_a8_launch(n, K, GS, sms)
        for m in (8, 640):
            x = x640[:m].contiguous()
            line = dict(kernel="K8", projection=proj, m=m, n=n, k=K, gs=GS, rule=list(rule),
                        **cs.linear_bound(x, qt, a8=True), card=card)
            for cand in dict.fromkeys([rule, *candidates(K, GS)]):
                fn = lambda: _launch(x, qt, "K8", launch=cand)  # noqa: E731
                if not torch.equal(fn(), ops.int4_matmul_per_group_a8_reference(x, qt,
                                                                                 launch=cand)):
                    raise AssertionError(f"K8 {proj} M={m} {cand}: not bit-equal to its plain "
                                         "version at the same shape")
                line[str(list(cand))] = dict(cold_ms=timer(fn, iters=5 if m == 640 else 20),
                                             device_ms=device_parts(fn, timer.flush))
            print(json.dumps(line), flush=True)
        del qt
        torch.cuda.empty_cache()


def sweep_k4(gen, card) -> None:
    """K4 at deep K: the rule's shape and the per-row candidates, M 8 and
    640, each bit for bit against the plain version."""
    from fused4bit_tpu_torch.ops._int8 import _launch, _row_a8_launch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer("cuda")
    n, k = K4_DEEP
    qt = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
    x640 = torch.randn((640, k), generator=gen, device="cuda").bfloat16()
    for m in (8, 640):
        x = x640[:m].contiguous()
        rule = _row_a8_launch(n, k, m, sms)
        want = ops.int4_matmul_a8_reference(x, qt, fuse_quant=False)
        line = dict(kernel="K4", projection="deep_k", m=m, n=n, k=k, rule=list(rule),
                    **cs.linear_bound(x, qt, a8=True), card=card)
        for cand in dict.fromkeys([rule, *candidates(k, 0)]):
            fn = lambda: _launch(x, qt, "K4", launch=cand)  # noqa: E731
            if not torch.equal(fn(), want):
                raise AssertionError(f"K4 deep K M={m} {cand}: not bit-equal to its plain "
                                     "version")
            line[str(list(cand))] = dict(cold_ms=timer(fn, iters=5 if m == 640 else 20),
                                         device_ms=device_parts(fn, timer.flush))
        print(json.dumps(line), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("linear_a8_sweep: no CUDA device")
    card = cs.card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(10)
    with torch.no_grad():
        if args.profile or not args.sweep:
            profile_wrapper(gen, card)
        if args.sweep:
            sweep_shapes(gen, card)
            sweep_k4(gen, card)


if __name__ == "__main__":
    main()
