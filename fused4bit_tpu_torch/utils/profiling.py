"""Profiling and tracing hooks.

Counterpart of ``fused4bit_tpu/utils/profiling.py``: :func:`trace` records
a ``torch.profiler`` trace (host ops, and the card's kernels where a CUDA
device exists) and exports it as a Chrome trace into ``log_dir``;
:func:`annotate` names a region (``torch.profiler.record_function``), which
also appears on the card's timeline around the kernels it launched;
:class:`Stopwatch` times sections on the host clock, waiting for the card
at each section's end.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["trace", "annotate", "Stopwatch"]


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Record a profiler trace of the block into ``log_dir`` as a Chrome
    trace (``<pid>_<ns>.pt.trace.json``; open with Perfetto or TensorBoard).
    The card is synchronized before the trace stops."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class Stopwatch:
    """Host-clock section timer with a report, for harness scripts. Each
    section ends with a wait for the card (when CUDA is in use), so it
    counts the device work its launches queued."""

    def __init__(self) -> None:
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.sections[name] = self.sections.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = [
            f"{name:<30} {secs:8.3f}s {100*secs/total:5.1f}%"
            for name, secs in sorted(self.sections.items(), key=lambda kv: -kv[1])
        ]
        out = "\n".join(lines)
        print(out)
        return out
