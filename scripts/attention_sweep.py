#!/usr/bin/env python3
"""Decode attention over the INT4 KV cache against a context sweep on one GPU.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/attention_sweep.py

At the `layer2` attention shape (32 query heads, 8 kv heads of 128, bf16
queries) and for batch 8 at 256, 1024, 4096 and 16384 positions and batch 1
at 16384 (every row full: one decode step at the last position), it holds
K3 (ops.int4_decode_attention on a QuantizedKVCache, random K/V from a seed)
against its plain version at chip_smoke.ATTN_ABS_TOL, and times it against
one library call for the same function, scaled_dot_product_attention over
the cache dequantized to bf16 beforehand (chip_smoke.sdpa_yardstick, which
reads four times the packed bytes): CUDA events with the L2 cache flushed
before every call (chip_smoke.Timer), each timed twice in the order K3,
SDPA, SDPA, K3. Beside them stand K3's bound (chip_smoke.attention_bound:
the packed codes plus 16 bytes of scale planes per position and kv head
over 3.35 TB/s), the share of it the kernel reaches, the segment and CTA
count of the split-S rule (ops.decode_attention._attn_segment), under
torch.profiler the device time of the main kernel and of the second pass
that merges the CTAs' partials, and, from 4096 positions on, K3's time with
the rule replaced by each of the segment sizes 64, 128, 256 and 512 (its
output held to the rule's at the same bar). One JSON line per shape; the
card's name and power limit lead the output. Imports nothing of JAX.
"""
from __future__ import annotations

import json

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import decode_attention

HQ, H_KV, D = 32, 8, 128
SHAPES = [(8, 256), (8, 1024), (8, 4096), (8, 16384), (1, 16384)]   # (batch, positions)
SEGMENTS = (64, 128, 256, 512)   # the candidates timed against the rule's


def device_ms(fn, calls=10) -> dict:
    """Device time per call of the attention body's main kernel and of its
    second pass."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "int4_attention" in e.key:
            out["merge" if "merge" in e.key else "main"] = e.device_time_total / calls / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep: no CUDA device")
    print(cs.card())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = cs.Timer("cuda")
    with torch.no_grad():
        for b, s in SHAPES:
            cache = cs._filled_cache(b, H_KV, s, D, [s] * b, gen, "cuda")
            q = torch.randn((b, HQ, D), generator=gen, device="cuda").bfloat16()
            y = ops.int4_decode_attention(q, cache)
            ref = ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1)[:, :, 0]
            err = (y.float() - ref.float()).abs().max().item()
            if not err <= cs.ATTN_ABS_TOL:
                raise AssertionError(f"B={b} S={s}: max|d| {err} > {cs.ATTN_ABS_TOL}")
            del ref
            kernel = lambda: ops.int4_decode_attention(q, cache)  # noqa: E731
            sdpa = cs.sdpa_yardstick(q, cache)
            times = {"kernel_ms": [], "sdpa_ms": []}
            for key, fn in (("kernel_ms", kernel), ("sdpa_ms", sdpa), ("sdpa_ms", sdpa),
                            ("kernel_ms", kernel)):
                times[key].append(timer(fn))
            work = cs.attention_bound(q, cache, cache.lengths - 1, 1)
            rule = decode_attention._attn_segment
            seg = rule(s, H_KV, sms)
            line = dict(
                batch=b, positions=s, max_abs_err=err, **times, bound_ms=work["bound_ms"],
                bound_by=work["bound_by"],
                bound_share=[work["bound_ms"] / t for t in times["kernel_ms"]],
                segment=seg, ctas_per_row=decode_attention._attn_ctas(s, seg),
                device_ms=device_ms(kernel))
            if s >= 4096:
                for cand in SEGMENTS:
                    decode_attention._attn_segment = lambda *_, cand=cand: cand
                    d = (kernel().float() - y.float()).abs().max().item()
                    if not d <= cs.ATTN_ABS_TOL:
                        raise AssertionError(f"B={b} S={s} segment {cand}: max|d| {d}")
                    line[f"segment_{cand}_ms"] = [timer(kernel) for _ in range(2)]
                decode_attention._attn_segment = rule
            print(json.dumps(line), flush=True)
            del cache, q, sdpa
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
