#!/usr/bin/env python3
"""Drive the PyTorch port (fused4bit_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. require a CUDA card; print its name and power limit, the CUDA version
     and nvcc's version;
  2. build the kernels of fused4bit_tpu_torch/csrc (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version at the shapes the
     `layer2` serving path gives it (Mixtral-8x7B layer width), and time both
     with CUDA events (L2 flushed before each launch);
  4. serve 12 requests on the `layer2` model (random weights from a seeded
     generator) with 8 slots, and check that the serving run launched every
     kernel and no plain version;
  5. run the `tiny` model with the same weights on the card and on the CPU,
     and compare the logits.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.layers import QuantizedKVCache, dispatch, make_dispatch_plan, topk_route
from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config
from fused4bit_tpu_torch.ops import _build
from fused4bit_tpu_torch.quant import quantize
from fused4bit_tpu_torch.serving import GenerationRequest, ServingEngine

# Tolerances, kernel vs plain version on the same inputs:
# - bf16 output: both round one f32 sum to bf16, summed in another order, so a
#   few bf16 ulps of the largest output: max|d| <= 1e-2 * max|y_plain|.
# - f32 output at K >= 4096: the reference's ladder for a 4096-deep f32 sum
#   taken in another order: max|d| <= 1e-2.
# - K3: outputs are convex combinations of values of order 1, rounded to
#   bf16 once, with ps rounded to bf16 at a running max in the kernel and at
#   the row max in the plain version: max|d| <= 2e-2.
BF16_REL_TOL = 1e-2
F32_ABS_TOL = 1e-2
ATTN_ABS_TOL = 2e-2
# Whole model on the card vs the CPU: bf16 activations through 2 layers.
MODEL_REL_TOL = 2e-2

SOURCES = {
    "int4_matmul": ("fused4bit_tpu_torch/csrc/int4_matmul.cu",
                    "fused4bit_tpu/ops/int4_matmul.py:90"),
    "grouped_int4_matmul": ("fused4bit_tpu_torch/csrc/grouped_matmul.cu",
                            "fused4bit_tpu/ops/grouped_matmul.py:59"),
    "int4_attention": ("fused4bit_tpu_torch/csrc/decode_attention.cu",
                       "fused4bit_tpu/ops/decode_attention.py:71"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    line = card()
    print(line)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return line


def build() -> float:
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (0 s means the library was already built)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    return secs


class Timer:
    """Median device time of one call, with CUDA events around each call
    and the L2 cache flushed before it (the serving path finds weights cold)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            # keep the card busy while the host enqueues, so the events time
            # the device work and not the host's launch overhead
            torch.cuda._sleep(1_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def _compare(name, shape, y, ref, tol, results, timer, fn, ref_fn):
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"{name} {shape}: non-finite output")
    err = (y.float() - ref.float()).abs().max().item()
    ms = timer(fn) if timer else float("nan")
    plain_ms = timer(ref_fn, iters=5) if timer else float("nan")
    ok = err <= tol
    print(f"  {name:20s} {shape:34s} max|d| {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {shape}: max|d| {err} > {tol}")
    results.append(dict(name=name, shape=shape, err=err, ms=ms, plain_ms=plain_ms))


def check_linear(device, results, timer, gen):
    for n, k in ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096)):
        w = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
        qt = quantize(w)
        for m in (1, 8, 32):
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            ref = ops.int4_matmul_reference(x, qt)
            y = ops.int4_matmul(x, qt)
            torch.cuda.synchronize()
            _compare("int4_matmul", f"M={m} N={n} K={k} bf16", y, ref,
                     BF16_REL_TOL * ref.float().abs().max().item(), results, timer,
                     lambda: ops.int4_matmul(x, qt),
                     lambda: ops.int4_matmul_reference(x, qt))
        if n == 1024:
            x = torch.randn((8, k), generator=gen, device=device)
            ref = ops.int4_matmul_reference(x, qt)
            _compare("int4_matmul", f"M=8 N={n} K={k} f32", ops.int4_matmul(x, qt),
                     ref, F32_ABS_TOL, results, None, None, None)


def _skewed_plan(t, e, top_k, tile_m, gen, device):
    """Routing skewed so some experts get several tokens and some none."""
    bias = torch.log(1.0 / (torch.arange(e, device=device) + 1.0)) * 4.0
    logits = bias[None, :] + torch.randn((t, e), generator=gen, device=device)
    routing = topk_route(logits, top_k, e)
    return routing, make_dispatch_plan(routing, e, tile_m=tile_m)


def check_grouped(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    for n, k in ((ffn, hidden), (hidden, ffn)):       # gate/up, then down
        w = torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5
        qt = quantize(w)
        del w
        for t, tile_m in ((8, 16), (600, 128)):
            routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
            x = torch.randn((t, k), generator=gen, device=device).bfloat16()
            xs = dispatch(x, routing, plan)
            gids = plan.tile_group_ids
            ref = ops.grouped_int4_matmul_reference(xs, gids, qt, tile_m=tile_m)
            y = ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m)
            torch.cuda.synchronize()
            pad = xs.abs().sum(dim=1) == 0
            if not bool((y[pad] == 0).all()):
                raise AssertionError("grouped_int4_matmul: padding rows are not exactly zero")
            loads = routing.tokens_per_expert.tolist()
            _compare("grouped_int4_matmul",
                     f"T={t} tile_m={tile_m} N={n} K={k}", y, ref,
                     BF16_REL_TOL * ref.float().abs().max().item(), results, timer,
                     lambda: ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m),
                     lambda: ops.grouped_int4_matmul_reference(xs, gids, qt, tile_m=tile_m))
            print(f"    tokens per expert {loads}, T_pad {plan.t_pad}")
            if t == 8:  # the f32 instantiation, at the decode shape
                xf = xs.float()
                _compare("grouped_int4_matmul", f"T={t} tile_m={tile_m} N={n} K={k} f32",
                         ops.grouped_int4_matmul(xf, gids, qt, tile_m=tile_m),
                         ops.grouped_int4_matmul_reference(xf, gids, qt, tile_m=tile_m),
                         F32_ABS_TOL, results, None, None, None)
        del qt


def _filled_cache(b, h_kv, s_max, d, lengths, gen, device):
    cache = QuantizedKVCache.init(b, h_kv, s_max, d, device=device)
    kv = torch.randn((2, b, h_kv, s_max - 1, d), generator=gen, device=device)
    cache.append(kv[0], kv[1], start=torch.zeros(b, dtype=torch.int32, device=device))
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=device))
    return cache


def check_attention(device, results, timer, gen, b=8, hq=32, h_kv=8, d=128, s_max=256):
    lengths = [(1, 2, 37, 255)[i % 4] for i in range(b)]
    cache = _filled_cache(b, h_kv, s_max, d, lengths, gen, device)
    q = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    ref = ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1)[:, :, 0]
    y = ops.int4_decode_attention(q, cache)
    _compare("int4_attention", f"decode B={b} lengths {sorted(set(lengths))}", y, ref,
             ATTN_ABS_TOL, results, timer, lambda: ops.int4_decode_attention(q, cache),
             lambda: ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1))
    qf = q.float()  # the f32 instantiation
    _compare("int4_attention", f"decode B={b} f32", ops.int4_decode_attention(qf, cache),
             ops.int4_attention_reference(qf[:, :, None], cache, cache.lengths - 1)[:, :, 0],
             ATTN_ABS_TOL, results, None, None, None)
    # a 32-token prefill chunk starting at odd positions
    t = 32
    starts = torch.tensor([(1, 37, 101, 223)[i % 4] for i in range(b)], dtype=torch.int32,
                          device=device)
    cache.lengths.copy_(starts + t)
    q = torch.randn((b, hq, t, d), generator=gen, device=device).bfloat16()
    ref = ops.int4_attention_reference(q, cache, starts)
    y = ops.int4_prefill_attention(q, cache, starts)
    _compare("int4_attention", f"prefill B={b} T={t} starts odd", y, ref, ATTN_ABS_TOL,
             results, timer, lambda: ops.int4_prefill_attention(q, cache, starts),
             lambda: ops.int4_attention_reference(q, cache, starts))


def check_kernels(device="cuda", timing=True):
    """Phase 3: every kernel against its plain version at the layer2 shapes."""
    gen = torch.Generator(device=device).manual_seed(1)
    timer = Timer(device) if timing else None
    results = []
    check_linear(device, results, timer, gen)
    check_grouped(device, results, timer, gen)
    check_attention(device, results, timer, gen)
    torch.cuda.empty_cache()
    return results


def _reset_counts():
    ops.int4_matmul.launches = 0
    ops.grouped_int4_matmul.launches = 0
    ops.int4_attention.launches = 0
    ops.int4_matmul_reference.calls = 0
    ops.grouped_int4_matmul_reference.calls = 0
    ops.int4_attention_reference.calls = 0


def serve(device="cuda", scale="layer2", card_line=""):
    """Phase 4: the continuous-batching server on the layer2 model."""
    cfg = flagship_model_config(scale)
    t0 = time.perf_counter()
    model = QuantizedTransformer.init(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                      device=device)
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(0)
    lengths = [3, 70, 12, 33, 45, 64, 7, 20, 50, 66, 5, 31]     # 1 to 3 prefill chunks
    budgets = [8 + (5 * i) % 9 for i in range(len(lengths))]   # 8..16 new tokens
    eng = ServingEngine(model, cfg, num_slots=8, max_seq=256, prefill_bucket=32)
    for uid, (n, new) in enumerate(zip(lengths, budgets)):
        eng.submit(GenerationRequest(uid=uid, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                                     max_new_tokens=new))
    _reset_counts()
    decode_ms = []
    t0 = time.perf_counter()
    with torch.no_grad():
        while eng.active or eng.queue:
            queued = len(eng.queue)
            s0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if len(eng.queue) == queued:  # no admission: a pure decode step
                decode_ms.append((time.perf_counter() - s0) * 1e3)
    wall = time.perf_counter() - t0
    launches = {
        "int4_matmul": ops.int4_matmul.launches,
        "grouped_int4_matmul": ops.grouped_int4_matmul.launches,
        "int4_attention": ops.int4_attention.launches,
    }
    plain = (ops.int4_matmul_reference.calls
             + ops.grouped_int4_matmul_reference.calls
             + ops.int4_attention_reference.calls)
    out = eng.finished
    for uid, want in enumerate(budgets):
        got = out.get(uid)
        if got is None or len(got) != want:
            raise AssertionError(f"uid {uid}: {None if got is None else len(got)} tokens, want {want}")
        if not all(0 <= tok < cfg.vocab_size for tok in got):
            raise AssertionError(f"uid {uid}: token out of the vocabulary")
    tokens = sum(budgets)
    print(f"serve: {len(lengths)} requests, {tokens} tokens in {wall:.2f} s wall "
          f"({tokens / wall:.1f} tok/s), decode {statistics.median(decode_ms):.2f} ms/step median "
          f"over {len(decode_ms)} steps, taken on {card_line}")
    print(f"serve: kernel launches {launches}, plain-version calls {plain}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the serving path was never launched: {launches}")
    if plain:
        raise AssertionError(f"the serving path ran a plain version {plain} times")
    del eng, model
    torch.cuda.empty_cache()
    return launches


def whole_model(device="cuda"):
    """Phase 5: the tiny model, same weights, card (kernels) vs CPU (plain)."""
    cfg = flagship_model_config("tiny")
    cpu = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(device)
    b, t, max_seq = 2, 12, 64
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, t)))
    caches_c, caches_g = cpu.init_cache(cfg, b, max_seq), gpu.init_cache(cfg, b, max_seq)
    positions = torch.arange(t, dtype=torch.int32)
    worst = 0.0
    with torch.no_grad():
        for step in range(4):  # one prefill, then 3 decode steps on the CPU's greedy token
            ref, caches_c = cpu(tokens, caches_c, positions)
            got, caches_g = gpu(tokens.to(device), caches_g, positions.to(device))
            ref, got = ref.float(), got.float().cpu()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"tiny step {step}: bad output {tuple(got.shape)}")
            err = (got - ref).abs().max().item()
            tol = MODEL_REL_TOL * ref.abs().max().item()
            worst = max(worst, err / tol)
            top2 = ref[:, -1].topk(2, dim=-1).indices
            nxt = got[:, -1].argmax(dim=-1)
            if err > tol or not all(nxt[i] in top2[i] for i in range(b)):
                raise AssertionError(f"tiny step {step}: max|d| {err} (tol {tol}), "
                                     f"argmax {nxt.tolist()} vs CPU top-2 {top2.tolist()}")
            tokens = ref[:, -1].argmax(dim=-1)[:, None]
            positions = torch.tensor([t + step], dtype=torch.int32)
    print(f"tiny model: card vs CPU over prefill + 3 decode steps, worst max|d|/tol {worst:.3f}, "
          f"argmax in CPU top-2: ok")


def main() -> None:
    card_line = require_card()
    build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        print(f"kernels vs plain versions (times: median, L2 flushed, on {card_line}):")
        results = check_kernels()
    launches = serve(card_line=card_line)
    whole_model()
    # ms / plain_ms: each kernel at its decode shape on the serving path
    main_shape = {"int4_matmul": "M=8 N=4096 K=4096 bf16",
                  "grouped_int4_matmul": "T=8 tile_m=16 N=14336 K=4096",
                  "int4_attention": "decode B=8 lengths [1, 2, 37, 255]"}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in results if r["name"] == name]
        main_row = next(r for r in rows if r["shape"] == main_shape[name])
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=max(r["err"] for r in rows),
                            ms=main_row["ms"], plain_ms=main_row["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
