"""The port's decode benchmark: the counterpart of ``bench.py`` at the
repository's root. Run it on the card with::

    python -m fused4bit_tpu_torch.bench

It times the INT4 Mixtral-geometry model (`layer2`: 2 layers of the exact
Mixtral-8x7B layer, batch 8) in three execution modes against its dense
bf16 twins, as a greedy 24-step decode loop, and prints ``bench.py``'s JSON
line as its last line, with one added key, ``"device"`` (the card's name and
power limit as ``nvidia-smi`` gives them). Earlier lines give each model's
wall ms per step when the same loop runs eagerly.

The pieces are twins of ``bench.py``'s local functions:

* :func:`decode_loop`: the scan body (``bench.py:62-71``), run eagerly;
* :class:`CapturedLoop`: the twin of ``jax.jit(loop)``. JAX compiles the
  24-step ``lax.scan`` into one program that the host dispatches once; here
  the whole loop is captured in one CUDA graph and replayed. The capture
  counts as the compile;
* :func:`bench`: wall seconds per step, the median of 4 repeats, each from a
  fresh first token, ended by fetching the tokens to the host;
* :func:`bench_device`: device ms per step of one replay of the loop that
  :func:`bench` timed, by CUDA events, best of 3 (``bench.py`` reads a
  profiler trace);
* :func:`run`: the sequence of models of ``bench.py:141-167`` and its JSON
  dict.

Where the port parts from JAX:

* The weights are drawn from a ``torch.Generator`` on the device, seeded 0
  for `layer2` and 1 for `small` (JAX: ``PRNGKey(0)`` and ``PRNGKey(1)``),
  so they are other numbers than JAX's.
* The caches update in place. Every step writes its own positions and the
  lengths follow from them, so a loop from position 0 repeats the last one.
* :func:`bench_device` times the replay with CUDA events: under
  ``torch.profiler`` the graph's kernels run slower than untraced, and the
  profiler's range read more device ms than the untraced replay's wall
  clock (PERF.md).
* On the card a failure raises; :func:`bench_device` never returns None
  there (``bench.py`` returns None on any exception). On the CPU, which has
  no graphs, :func:`bench` times :func:`decode_loop` and :func:`bench_device`
  returns None, as ``bench.py`` does off the TPU.

This module imports torch and the port, and nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from . import ops
from ._device import resolve_device
from .models import QuantizedTransformer, as_u4_turbo, as_xla_turbo, dense_from_quantized
from .models import flagship_model_config
from .utils.profiling import entry, span

__all__ = ["METRIC", "decode_loop", "CapturedLoop", "bench", "bench_eager", "bench_device",
           "run", "card_line", "main"]

METRIC = "int4_model_decode_ms_per_step_mixtral_layer_geometry_2L_b8"
BATCH, STEPS, REPEATS, MAX_SEQ = 8, 24, 4, 256
DEVICE_REPEATS = 3
# Spin cycles that keep the card busy while the host enqueues a timed replay
# (about 10 ms at the H100's clock; a replay's launch takes less).
_HOLD_CYCLES = 20_000_000


def _device_of(model) -> torch.device:
    return model.embed.device


def _counts() -> Dict[str, int]:
    """Every kernel's launches, the resident-int8 linears' calls and the
    plain versions' calls so far."""
    return {**ops.launch_counts(), "int8_linear": ops.int8_linear.calls,
            "plain": ops.plain_calls()}


def decode_loop(model, caches, tok0: torch.Tensor, pos0: torch.Tensor,
                steps: int) -> torch.Tensor:
    """``steps`` greedy decode steps from ``tok0`` [B, 1] at ``pos0`` [B, 1]
    (int32): each step's logits, their argmax over the last position as the
    next token, the positions plus one. Returns the tokens [steps, B, 1]
    int32, stacked as ``lax.scan`` stacks its outputs. The caches update in
    place. Each step is a top-level entry of the layer spans
    (``utils.profiling``); the argmax, the next positions and the stacked
    tokens are its ``sample`` span."""
    toks = []
    tok, pos = tok0, pos0
    with torch.no_grad():
        for _ in range(steps):
            with entry():
                logits, caches = model(tok, caches, pos)
                with span("sample"):
                    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
                    pos = pos + 1
            toks.append(tok)
    with entry(), span("sample"):
        return torch.stack(toks)


class _EagerLoop:
    """:func:`decode_loop` from position 0 as a callable of the first token:
    what :func:`bench` times on the CPU, and :func:`bench_eager` anywhere."""

    def __init__(self, model, caches, batch: int, steps: int):
        self.model, self.caches, self.steps = model, caches, steps
        self.pos0 = torch.zeros((batch, 1), dtype=torch.int32, device=_device_of(model))

    def __call__(self, tok0: torch.Tensor) -> torch.Tensor:
        return decode_loop(self.model, self.caches, tok0, self.pos0, self.steps)


class CapturedLoop:
    """The whole ``steps``-step :func:`decode_loop` captured in one CUDA
    graph, the twin of ``jax.jit(loop)``.

    The constructor runs one eager loop on a side stream (it builds the
    kernel library and sets the kernels' shared-memory attributes, so
    nothing lazy is left for the capture), captures the loop from the
    static buffers ``tok0`` and ``pos0`` (zeros) into ``graph``, and replays
    it once, so that the graph's first upload is not in a timed replay (as
    ``bench.py``'s compile call runs its program once); its tokens land in
    ``toks``. ``launches``: the launches the graph holds, by counter
    (the kernels', ``int8_linear``'s and the plain versions'), counted once
    at the capture; ``capture_seconds``: the capture's wall time, the
    graph's instantiation included; ``first_replay_seconds``: that untimed
    first replay's wall time. ``__call__(tok0)`` copies ``tok0`` into
    the static buffer, replays the graph and returns a copy of the tokens. A
    model on the CPU raises: there is no eager fallback."""

    def __init__(self, model, caches, batch: int, steps: int = STEPS):
        device = _device_of(model)
        if device.type != "cuda":
            raise RuntimeError(f"CapturedLoop captures a CUDA graph: the model is on {device}; "
                               "a model built with device='cpu' runs decode_loop")
        self.model, self.caches, self.steps = model, caches, steps
        self.tok0 = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.pos0 = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            decode_loop(model, caches, self.tok0, self.pos0, steps)
        torch.cuda.current_stream(device).wait_stream(side)
        before, t0 = _counts(), time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.toks = decode_loop(model, caches, self.tok0, self.pos0, steps)
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
        t0 = time.perf_counter()
        self.graph.replay()
        torch.cuda.synchronize(device)
        self.first_replay_seconds = time.perf_counter() - t0

    def __call__(self, tok0: torch.Tensor) -> torch.Tensor:
        self.tok0.copy_(tok0)
        self.graph.replay()
        return self.toks.clone()

    def device_ms(self, tok0: torch.Tensor) -> float:
        """Device ms of one replay from ``tok0``: CUDA events on the stream
        before and after the graph, the card held in a spin kernel while the
        host enqueues them, so the launch's host cost is not counted."""
        self.tok0.copy_(tok0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def _seconds_per_step(loop, repeats: int) -> float:
    """Median over ``repeats`` of wall seconds per step, each repeat from a
    fresh first token ``r + 3``, ended by fetching the tokens to the host
    (``bench.py``'s barrier)."""
    b = loop.pos0.shape[0]
    ts = []
    for r in range(repeats):
        tok0 = torch.full((b, 1), r + 3, dtype=torch.int32, device=loop.pos0.device)
        t0 = time.perf_counter()
        loop(tok0).cpu()
        ts.append((time.perf_counter() - t0) / loop.steps)
    return sorted(ts)[len(ts) // 2]


def bench(m, caches, *, steps: int = STEPS,
          repeats: int = REPEATS) -> Tuple[float, Union[CapturedLoop, _EagerLoop]]:
    """Wall seconds per decode step of ``m`` (``bench.py:61-84``), the median
    of ``repeats``, and the timed loop: captured in a CUDA graph on the card
    (the capture is not timed), eager on the CPU."""
    timed = CapturedLoop if _device_of(m).type == "cuda" else _EagerLoop
    loop = timed(m, caches, caches[0].lengths.shape[0], steps)
    return _seconds_per_step(loop, repeats), loop


def bench_eager(m, caches, *, steps: int = STEPS) -> float:
    """:func:`bench`'s reading for the eager :func:`decode_loop`, on any
    device: what a loop launched from Python costs a step."""
    return _seconds_per_step(_EagerLoop(m, caches, caches[0].lengths.shape[0], steps), REPEATS)


def bench_device(loop) -> Optional[float]:
    """Device ms per decode step (``bench.py:86-123``) of a loop that
    :func:`bench` returned: one replay timed by CUDA events
    (:meth:`CapturedLoop.device_ms`), over its steps; the best of
    ``DEVICE_REPEATS``. None for the CPU's eager loop."""
    if not isinstance(loop, CapturedLoop):
        return None
    tok0 = torch.zeros_like(loop.tok0)
    return min(loop.device_ms(tok0) for _ in range(DEVICE_REPEATS)) / loop.steps


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(device=None, *, scale: str = "layer2", small_scale: str = "small", batch: int = BATCH,
        steps: int = STEPS, repeats: int = REPEATS, on_loop: Optional[Callable] = None) -> dict:
    """``bench.py``'s measurement (``bench.py:43-209``) and its JSON dict.

    At ``scale``: the INT4 model (default mode: K1, K2, K3), its
    ``as_u4_turbo`` copy (K5, K10, K3), the ``dense_all`` bf16 twin and its
    ``as_xla_turbo`` copy (int8 linears, K2, K3); at ``small_scale``: the
    INT4 model, the gather twin and the ``dense_all`` twin. Each model is
    built, timed and freed (with its graph's memory) before the next. The
    dict holds ``bench.py``'s keys, ``"backend"`` ("gpu" or "cpu"), and
    ``"device"``: :func:`card_line` on the card, None on the CPU.
    ``device``: None for the CUDA card (raises ``RuntimeError`` without
    one), ``"cpu"`` for the plain versions. ``on_loop(name, loop, seconds,
    device_ms)``, when given, is called with each timed loop and its
    readings (see :func:`bench`, :func:`bench_device`) before the loop is
    freed; ``name`` is ``"<scale> <model>"``."""
    device = resolve_device(device)
    cfg, cfg_s = flagship_model_config(scale), flagship_model_config(small_scale)

    def timed(name, m, c):
        seconds, loop = bench(m, m.init_cache(c, batch, MAX_SEQ), steps=steps, repeats=repeats)
        device_ms = bench_device(loop)
        if on_loop is not None:
            on_loop(name, loop, seconds, device_ms)
        return seconds, device_ms

    def init(c, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return QuantizedTransformer.init(c, generator=gen, device=device)

    model = init(cfg, 0)
    t_kernel, d_kernel = timed(f"{scale} kernel", model, cfg)
    u4 = as_u4_turbo(model)
    t_u4, d_u4 = timed(f"{scale} u4_turbo", u4, cfg)
    del u4
    _free(device)
    strong = dense_from_quantized(model, moe_impl="dense_all")
    t_strong, d_strong = timed(f"{scale} dense_all", strong, cfg)
    del strong
    _free(device)
    turbo = as_xla_turbo(model)
    t_turbo, _ = timed(f"{scale} xla_turbo", turbo, cfg)
    del turbo, model
    _free(device)

    model_s = init(cfg_s, 1)
    t_kernel_s, _ = timed(f"{small_scale} kernel", model_s, cfg_s)
    naive_s = dense_from_quantized(model_s)
    t_naive_s, _ = timed(f"{small_scale} gather", naive_s, cfg_s)
    del naive_s
    _free(device)
    strong_s = dense_from_quantized(model_s, moe_impl="dense_all")
    t_strong_s, _ = timed(f"{small_scale} dense_all", strong_s, cfg_s)
    del strong_s, model_s
    _free(device)

    t_int4 = min(t_kernel, t_u4, t_turbo)
    d_int4 = min(x for x in (d_kernel, d_u4) if x is not None) \
        if (d_kernel or d_u4) else None
    return {
        "metric": METRIC,
        "value": round(t_int4 * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(t_strong / t_int4, 3),
        "vs_strong_dense": round(t_strong / t_int4, 3),
        "int4_kernel_ms": round(t_kernel * 1e3, 3),
        "int4_u4_turbo_ms": round(t_u4 * 1e3, 3),
        "int4_xla_turbo_ms": round(t_turbo * 1e3, 3),
        "bf16_strong_ms": round(t_strong * 1e3, 3),
        "small_scale": {
            "int4_kernel_ms": round(t_kernel_s * 1e3, 3),
            "bf16_strong_ms": round(t_strong_s * 1e3, 3),
            "bf16_naive_ms": round(t_naive_s * 1e3, 3),
            "vs_strong_dense": round(t_strong_s / t_kernel_s, 3),
            "vs_naive_dense": round(t_naive_s / t_kernel_s, 3),
        },
        "int4_kernel_device_ms": round(d_kernel, 3) if d_kernel is not None else None,
        "int4_u4_turbo_device_ms": round(d_u4, 3) if d_u4 is not None else None,
        "bf16_strong_device_ms": round(d_strong, 3) if d_strong is not None else None,
        "vs_strong_dense_device": (round(d_strong / d_int4, 3)
                                   if d_int4 and d_strong else None),
        "backend": "gpu" if device.type == "cuda" else "cpu",
        "device": card_line(device) if device.type == "cuda" else None,
    }


def main() -> int:
    """Each model's eager wall ms per step on an earlier line, then the JSON
    line, last."""
    def eager(name, loop, seconds, device_ms):
        s = bench_eager(loop.model, loop.caches, steps=loop.steps)
        print(f"{name}: eager {s * 1e3:.3f} ms/step wall (decode_loop), captured "
              f"{seconds * 1e3:.3f} wall, {device_ms:.3f} device", flush=True)

    print(json.dumps(run(on_loop=eager)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
