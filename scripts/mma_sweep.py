#!/usr/bin/env python3
"""Launch shapes of the tensor-core linear body (csrc/int4_mma.cuh) on one GPU.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/mma_sweep.py

For each `layer2` linear shape (q/o 4096 x 4096, k/v 1024 x 4096, the INT4
router 8 x 4096, the LM head 8192 x 4096; random weights from a seed), K1
(per row) and K6 (per group of 128), and M in (8, 40) (a decode step of 8
slots, the self-draft verify of gamma 4), launches the body at the rule's
shape (``ops._mma._mma_launch``) and at the other candidate shapes
(ws k steps per warp, kw warps along K per CTA, splits CTAs along K), each
held against the rule's output at BF16_REL_TOL of its largest value, and
times each: "cold" with the L2 cache flushed before every call
(chip_smoke.Timer), "warm" without the flush, and under torch.profiler the
device time of the main kernel and of the second pass that adds the splits.
The library call (torch._weight_int4pack_mm on the same codes) is timed
beside them. One JSON line per (shape, kernel, M); the card's name and power
limit lead the output. Imports nothing of JAX.
"""
from __future__ import annotations

import json

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fused4bit_tpu_torch.ops import _build, _mma
from fused4bit_tpu_torch.quant import quantize


CANDIDATES = {
    4096: [(32, 1, 8), (32, 2, 4), (32, 4, 2), (32, 8, 1), (16, 8, 2)],
    1024: [(32, 8, 1), (32, 4, 2), (16, 8, 2), (8, 8, 4)],
    8: [(1, 8, 32), (2, 8, 16), (4, 8, 8), (32, 8, 1)],
    8192: [(32, 1, 8), (32, 2, 4), (32, 4, 2), (32, 8, 1)],
}
K = 4096


def launch(lib, x, qt, ws, kw, splits, k6):
    """The body at an explicit launch shape, as ``ops`` launches it."""
    m, k = x.shape
    n = qt.out_dim
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    fn = lib.f4b_int4_matmul_planar_pg_bf16 if k6 else lib.f4b_int4_matmul_bf16
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zero_points.data_ptr(),
             y.data_ptr(), partial.data_ptr(), m, n, k, *([qt.group_size] if k6 else []),
             ws, kw, splits, 16, _build.stream_of(x))
    _build.check(err, "int4_mma")
    return y


def device_ms(fn, calls=10) -> dict:
    """Device time per call of the body's main kernel and of its second pass."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "int4_mma" in e.key:
            out["reduce" if "reduce" in e.key else "main"] = e.device_time_total / calls / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_sweep: no CUDA device")
    print(cs.card())
    lib = _build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    cold = cs.Timer("cuda")
    warm = cs.Timer("cuda")
    warm.flush = torch.empty(16, dtype=torch.uint8, device="cuda")
    tiny = torch.zeros(1, device="cuda")
    print(json.dumps(dict(one_tiny_kernel_cold_ms=cold(lambda: tiny.add_(1)),
                          one_tiny_kernel_warm_ms=warm(lambda: tiny.add_(1)))))
    with torch.no_grad():
        for n, shapes in CANDIDATES.items():
            w = torch.randn((n, K), generator=gen, device="cuda") * K ** -0.5
            for k6 in (False, True):
                qt = (quantize(w, granularity="per_group", layout="planar", group_size=128) if k6
                      else quantize(w))
                rule = _mma._mma_launch(n, K, sms)
                for m in (8, 40):
                    x = torch.randn((m, K), generator=gen, device="cuda").bfloat16()
                    ref = launch(lib, x, qt, *rule, k6)
                    tol = cs.BF16_REL_TOL * ref.float().abs().max().item()
                    yard = cs.int4pack_yardstick(x, qt)
                    line = dict(n=n, k=K, m=m, kernel="K6" if k6 else "K1", rule=list(rule),
                                library_cold_ms=cold(yard), library_warm_ms=warm(yard))
                    for shape in dict.fromkeys([rule, *shapes]):
                        fn = lambda: launch(lib, x, qt, *shape, k6)  # noqa: E731
                        d = (fn().float() - ref.float()).abs().max().item()
                        if not d <= tol:
                            raise AssertionError(f"{shape}: max|d| {d} > {tol}")
                        line[str(list(shape))] = dict(cold_ms=cold(fn), warm_ms=warm(fn),
                                                      device_ms=device_ms(fn))
                    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
