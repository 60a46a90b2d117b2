"""The profiler's records of a traced stretch of a run, and what the
metrics read from them.

``record(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside a range ``portbench.traced``, exports the Chrome trace
into the run's ``TMPDIR``, reads it and deletes it. The parsing follows
``fused4bit_tpu_torch/utils/device_profile.py``: device operations are the
events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` (``ts`` and
``dur`` in microseconds); each keeps its start, so the union of their
intervals (busy time), the idle gaps and the host operation under each gap
can be worked out. Kernel records are read, never ``record_function``
ranges on the device, which overstate a CUDA graph's time.

Kernel families (what the roofline metrics divide by) are told apart by
name: the port's kernels are the ``__global__`` functions of its ``csrc/``
(read from the sources, so a kernel added there is counted as the port's
own), and a split launch's second pass (``*_reduce_kernel``) belongs to the
main kernel that ran just before it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
RANGE = "portbench.traced"


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    start: float        # us
    dur: float          # us

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]                      # device ops inside the window, by start
    host: List[Tuple[float, float, str]]     # host ops (start, end, name), by start
    window: Tuple[float, float]              # the traced range, us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for o in self.ops:
            s, e = max(o.start, self.window[0]), min(o.end, self.window[1])
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, points: Sequence[float]) -> List[str]:
        """For each time in ``points`` (ascending), the innermost host
        operation running then: of those that cover it, the one that started
        last (one sweep over the host operations)."""
        out, stack, i = [], [], 0
        for t in points:
            while i < len(self.host) and self.host[i][0] <= t:
                if self.host[i][2] != RANGE:
                    stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            # an operation lower on the stack may have ended under a live one
            label = next((h[2] for h in reversed(stack) if h[1] > t), None)
            out.append(label or "host: between traced operations")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing at each gap's middle, in seconds."""
        by_op: Dict[str, float] = {}
        for o in self.ops:
            by_op[o.name] = by_op.get(o.name, 0.0) + o.dur / 1e6
        idle: Dict[str, float] = {}
        gaps = self.gaps()
        for (s, e), label in zip(gaps, self.host_at([(s + e) / 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
        def best(d):
            return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(by_op), "idle_gaps": best(idle)}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            ops.append(DeviceOp(e["name"], cat, float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            s = float(e["ts"])
            host.append((s, s + float(e["dur"]), e["name"]))
            if e["name"] == RANGE and cat == "user_annotation":
                window = (s, s + float(e["dur"]))
    if window is None:
        raise RuntimeError(f"the trace {path} holds no range {RANGE!r}")
    ops = sorted((o for o in ops if o.end > window[0] and o.start < window[1]),
                 key=lambda o: o.start)
    if not ops:
        raise RuntimeError("the traced window holds no device operation: the profiler saw "
                           "no CUDA work")
    host.sort()
    return Trace(ops, host, window)


def record(fn: Callable[[], object]) -> Trace:
    """Run ``fn`` once under the profiler and return its records; the
    exported file lives in ``TMPDIR`` only while it is read."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(RANGE):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        return parse(path)
    finally:
        os.unlink(path)


# -- kernel families ----------------------------------------------------------

def csrc_kernels(csrc: pathlib.Path) -> Tuple[str, ...]:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    for path in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(path.read_text()))
    return tuple(sorted(names))


def is_own(name: str, own: Sequence[str]) -> bool:
    return any(k in name for k in own)


def _second_pass(name: str) -> bool:
    return "_reduce_kernel" in name or "_merge_kernel" in name


def family_ms(kernels: Sequence[DeviceOp], main: Callable[[str], bool]) -> float:
    """Device ms of the kernels ``main`` names, with each second pass that
    follows one of them."""
    total, last_main = 0.0, False
    for k in kernels:
        if main(k.name):
            total += k.dur
            last_main = True
        elif _second_pass(k.name):
            if last_main:
                total += k.dur
        else:
            last_main = False
    return total / 1e3


def grouped_flag(name: str) -> Optional[bool]:
    """Whether an ``int4_mma_kernel`` / ``int8_mma_kernel`` instantiation
    uses grouped addressing (template flag true, mangled ``Lb1E``); None
    for other kernels."""
    if "int4_mma_kernel" not in name and "int8_mma_kernel" not in name:
        return None
    if "Lb1E" in name or re.search(r",\s*true\s*>", name):
        return True
    return False

