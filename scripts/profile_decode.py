#!/usr/bin/env python3
"""Where a `layer2` decode step's time goes, per execution mode, on one GPU.

Run from the repository root:

    python3 scripts/profile_decode.py

Builds `layer2` (random weights from a seed) once, and once more converted
from a seeded dense checkpoint per group of 128 (`convert_checkpoint`:
planar weights on K6 and K12, a dense router; mode "converted_pg128"),
and the per_group mode's model with its bytes in the planar layout (the
same weights and routing as per_group, on K6 and K12; mode
"per_group_planar"),
fills SLOTS slots with PROMPT-token prompts through the serving engine (in
the default mode both on the contiguous cache and on the paged one, page
128), then per mode and round:
times STEPS decode steps on the host clock (each ends in a device sync),
and runs STEPS more under `torch.profiler` to sum the device kernel time.
The seven modes alternate within each of ROUNDS rounds, so they share the
card's state. Prints one JSON line per (round, mode): wall ms/step, device
ms/step, busy share (device / wall), kernels per step, the attention
kernel's (K3 or K3') device ms/step, the five kernels with the most device
time, and the device ms and launches per step of each w4a8 kernel (by name:
the CUDA-core loops, the int8 body's first pass, main kernel and second
pass). It calls only the package's public API, so it also profiles a parent
tree (``cd <parent checkout> && env PYTHONPATH=. python3 <this script>``).
Imports nothing of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from fused4bit_tpu_torch.models import (
    QuantizedTransformer,
    SeededCheckpoint,
    as_per_group,
    as_turbo,
    as_u4_turbo,
    convert_checkpoint,
    flagship_model_config,
)
from fused4bit_tpu_torch.layers import MoEINT4, QuantizedLinear
from fused4bit_tpu_torch.quant import planar_groups_to_planar
from fused4bit_tpu_torch.serving import GenerationRequest, ServingEngine

ROUNDS = 2
STEPS = 10    # decode steps timed, and as many profiled, per mode and round
SLOTS = 8
PROMPT = 20   # tokens per prompt


def _planar(pg):
    """The per-group model with every planar_groups weight reordered to the
    planar layout: the same values, served by K6 and K12."""
    def conv(mod):
        w = mod.weight
        if w.layout != "planar_groups":
            return mod
        w = dataclasses.replace(w, packed=planar_groups_to_planar(w.packed).contiguous(),
                                layout="planar")
        return QuantizedLinear(w) if isinstance(mod, QuantizedLinear) else MoEINT4(w)

    planar = copy.deepcopy(pg)
    for blk in planar.blocks:
        for name in ("wq", "wk", "wv", "wo"):
            setattr(blk.attn, name, conv(getattr(blk.attn, name)))
        for name in ("w_gate", "w_up", "w_down"):
            setattr(blk.moe, name, conv(getattr(blk.moe, name)))
    planar.lm_head = conv(planar.lm_head)
    return planar


def _modes(model, cfg):
    """mode -> (model, engine options)."""
    pg = as_per_group(model)
    converted = convert_checkpoint(SeededCheckpoint(cfg, "cuda"), cfg, device="cuda",
                                   granularity="per_group", group_size=128)
    return {"default": (model, {}), "paged": (model, dict(paged=True, page_size=128)),
            "u4_turbo": (as_u4_turbo(model), {}), "per_group": (pg, {}),
            "pg_turbo": (as_turbo(pg), {}), "converted_pg128": (converted, {}),
            "per_group_planar": (_planar(pg), {})}


def _engine(model, cfg, **engine_kw):
    rng = np.random.default_rng(0)
    eng = ServingEngine(model, cfg, num_slots=SLOTS, max_seq=256, prefill_bucket=32, **engine_kw)
    for uid in range(SLOTS):
        eng.submit(GenerationRequest(uid=uid, prompt=rng.integers(1, cfg.vocab_size, PROMPT).tolist(),
                                     max_new_tokens=200))
    eng.step()          # admits every slot (one prefill each), then one decode step
    for _ in range(3):  # warm-up decode steps
        eng.step()
    torch.cuda.synchronize()
    return eng


def _short(name: str) -> str:
    """A kernel's name without its namespaces and arguments."""
    return name.replace("f4b::(anonymous namespace)::", "").split("(")[0].replace("void ", "")


def _profile(eng) -> dict:
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / STEPS
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    attention = sum(e.self_device_time_total for e in kernels if "attention" in e.key)
    a8 = {_short(e.key): (e.self_device_time_total / 1e3 / STEPS, e.count / STEPS)
          for e in kernels if "a8" in e.key or "int8_mma" in e.key}
    return dict(wall_ms_per_step=wall, device_ms_per_step=device, busy=device / wall,
                kernels_per_step=sum(e.count for e in kernels) / STEPS,
                attention_ms_per_step=attention / 1e3 / STEPS,
                top=[(e.key[:60], e.self_device_time_total / 1e3 / STEPS, e.count // STEPS)
                     for e in top],
                a8_kernels=a8)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = flagship_model_config("layer2")
    model = QuantizedTransformer.init(cfg, generator=torch.Generator("cuda").manual_seed(0),
                                      device="cuda")
    engines = {m: _engine(mm, cfg, **kw) for m, (mm, kw) in _modes(model, cfg).items()}
    for rnd in range(ROUNDS):
        for m, eng in engines.items():
            row = dict(round=rnd, mode=m, card=card, **_profile(eng))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
