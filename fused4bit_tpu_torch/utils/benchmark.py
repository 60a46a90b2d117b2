"""Benchmark timing utilities.

Counterpart of ``fused4bit_tpu/utils/benchmark.py``:

* :func:`time_fn`: host-clock seconds per call over repeated calls, after a
  warm-up, ending in a wait for the card (JAX's ``block_until_ready``);
* :func:`time_fn_scan`: seconds per application of ``fn`` in a chain of
  ``iters`` data-dependent applications run as one unit, so the per-call
  host dispatch is amortized away. JAX runs the chain in one ``jit``; on a
  CUDA tensor the port captures it in one CUDA graph and replays that, on a
  CPU tensor it loops. Each application's input mixes the previous output
  in non-linearly, and the dependence covers the whole output, so no
  application can be skipped or hoisted;
* :func:`time_fn_slope` and :func:`time_chain_slope`: per-op seconds as the
  slope between chains of two lengths (one op re-applied, or distinct
  weight sets), which cancels a fixed cost per chain step.

A graph capture replays exactly the kernels launched while capturing, on
the stream ``torch.cuda.current_stream`` names (the port's ctypes launches
take it, ``ops._build.stream_of``); a host sync inside ``fn`` would break
the capture. The launch counters of the ops count the captured launches
once, not the replays. For per-kernel device times prefer
:mod:`~fused4bit_tpu_torch.utils.device_profile`; these timers measure what
a host-driven caller pays, on the host clock.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = [
    "BenchmarkResult", "time_fn", "time_fn_scan", "time_fn_slope",
    "time_chain_slope", "print_table",
]


@dataclasses.dataclass
class BenchmarkResult:
    """One benchmark measurement."""

    name: str
    mean_ms: float
    std_ms: float = 0.0
    num_tokens: int = 0
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_second(self) -> float:
        if self.num_tokens == 0 or self.mean_ms == 0:
            return 0.0
        return self.num_tokens / (self.mean_ms / 1e3)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def _block(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor."""
    for t in _tensors(out):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn: Callable[[], object], *, warmup: int = 5, iters: int = 50) -> float:
    """Mean host-clock seconds per call (dispatch included)."""
    for _ in range(warmup):
        out = fn()
    _block(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _block(out)
    return (time.perf_counter() - t0) / iters


def _mix(x0: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """The next input: x0 with the carry mixed in non-linearly, so that a
    linear ``fn`` cannot be factored out of the chain (XOR for integers)."""
    if x0.dtype.is_floating_point:
        return torch.sin(x0 + carry)
    return x0 ^ carry


def _dep(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A scalar carry of x's dtype that depends on every element of ``y``,
    non-linearly (``abs`` blocks a rewrite to a product of sums), and that is
    nonzero in bf16; for integer carriers a parity."""
    y0 = (y.real if y.is_complex() else y).float().abs().sum()
    if not dtype.is_floating_point:
        return (y0.to(torch.int64) % 2).to(dtype)
    return (torch.tanh(y0) * 1e-6).to(dtype)


def _seconds_per_iter(body: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      x: torch.Tensor, *, iters: int, warmup: int, repeats: int) -> float:
    """Median over ``repeats`` of the seconds per iteration of ``iters``
    chained ``carry = body(x, carry)`` iterations, each repeat on a fresh
    input, ended by fetching the carry to the host."""
    def chain(x0):
        carry = torch.zeros((), dtype=x0.dtype, device=x0.device)
        for _ in range(iters):
            carry = body(x0, carry)
        return carry

    if x.is_cuda:
        static_x = x.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            chain(static_x)   # builds and loads every kernel before the capture
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(static_x)

        def run(xr):
            static_x.copy_(xr)
            torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            graph.replay()
            out.item()
            return time.perf_counter() - t0
    else:
        def run(xr):
            t0 = time.perf_counter()
            chain(xr).item()
            return time.perf_counter() - t0

    for _ in range(warmup):
        run(x)
    # a fresh input per repeat: identical repeated requests can be served
    # anomalously fast
    times = [run(x + (1 + r % 2)) for r in range(repeats)]
    return statistics.median(times) / iters


def time_fn_scan(fn: Callable[..., torch.Tensor], x: torch.Tensor, *, consts=(),
                 iters: int = 50, warmup: int = 2, repeats: int = 5) -> float:
    """Seconds per application of ``fn(x, *consts)`` in a chain of ``iters``
    dependent applications run as one unit (one CUDA graph on the card),
    median over ``repeats``; the carry's small ops are part of the number."""
    def body(x0, carry):
        return _dep(fn(_mix(x0, carry), *consts), x0.dtype)

    return _seconds_per_iter(body, x, iters=iters, warmup=warmup, repeats=repeats)


def time_fn_slope(fn: Callable[..., torch.Tensor], x: torch.Tensor, *, consts=(),
                  iters: int = 8, repeats: int = 5, warmup: int = 1, chain: int = 8) -> float:
    """Per-op seconds by the two-point slope: chains of ``chain`` and of 1
    dependent applications per step, ``(t(chain) - t(1)) / (chain - 1)``,
    which cancels any fixed cost per step."""
    def step_time(reps):
        def body(x0, carry):
            for _ in range(reps):
                carry = _dep(fn(_mix(x0, carry), *consts), x0.dtype)
            return carry

        return _seconds_per_iter(body, x, iters=iters, warmup=warmup, repeats=repeats)

    t1 = step_time(1)
    tc = step_time(chain)
    return max((tc - t1) / (chain - 1), 1e-9)


def time_chain_slope(step_fn: Callable, x: torch.Tensor, weight_sets, *, p_small: int = 1,
                     p_large: Optional[int] = None, iters: int = 16, repeats: int = 5,
                     warmup: int = 1) -> float:
    """Per-application seconds of ``step_fn(y, ws) -> y'`` (shape-preserving)
    chained across DISTINCT weight sets, so every link streams other bytes:
    ``(t(p_large) - t(p_small)) / (p_large - p_small)``. A sine between
    links keeps adjacent linear links from composing."""
    p_large = p_large if p_large is not None else len(weight_sets)
    if p_large > len(weight_sets):
        raise ValueError(f"p_large={p_large} > {len(weight_sets)} weight sets")

    def step_time(p):
        sets = tuple(weight_sets[:p])

        def body(x0, carry):
            y = torch.sin(x0 + carry)
            for w in sets:
                y = torch.sin(step_fn(y, w))
            return _dep(y, x0.dtype)

        return _seconds_per_iter(body, x, iters=iters, warmup=warmup, repeats=repeats)

    ts = step_time(p_small)
    tl = step_time(p_large)
    return max((tl - ts) / (p_large - p_small), 1e-9)


def print_table(results: List[BenchmarkResult], baseline: Optional[str] = None) -> str:
    """Render results as a table, with speedups against ``baseline``."""
    base = None
    if baseline is not None:
        for r in results:
            if r.name == baseline:
                base = r.mean_ms
    lines = [
        f"{'implementation':<28} {'mean ms':>10} {'tokens/s':>12} {'speedup':>8}",
        "-" * 62,
    ]
    for r in results:
        sp = f"{base / r.mean_ms:.2f}x" if base else "-"
        lines.append(
            f"{r.name:<28} {r.mean_ms:>10.3f} {r.tokens_per_second:>12.0f} {sp:>8}"
        )
    out = "\n".join(lines)
    print(out)
    return out
