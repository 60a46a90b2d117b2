"""Trace-based device timing: per-kernel durations from ``torch.profiler``.

Counterpart of ``fused4bit_tpu/utils/device_profile.py``. The profiler
records every kernel, copy and memset the card runs with its device start
and duration (CUPTI), immune to the host's dispatch jitter; this module
parses the Chrome trace it exports:

* ``by_op``: the device's own events (categories ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``), by name, ``dur`` in µs;
* ``by_module``: the ``record_function`` ranges as the card saw them
  (category ``gpu_user_annotation``: from the first to the last kernel the
  range launched), by name. They take the place of XLA's modules: wrap the
  work under test in ``utils.profiling.annotate("name")`` and read it with
  ``main_module_ms("name")``; without a name the longest range, the
  outermost, is taken.

Usage::

    prof = device_op_times(lambda: step())
    prof.total_ms                        # sum of all device op durations
    prof.by_op                           # {kernel name: OpTime(total_ms, count)}
    prof.matching_count("int4_mma_kernel")  # names as the profiler gives them
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import tempfile
from typing import Callable, Dict, Optional

from .profiling import trace

__all__ = ["OpTime", "DeviceProfile", "device_op_times"]

_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_DEVICE_RANGES = "gpu_user_annotation"


@dataclasses.dataclass
class OpTime:
    total_ms: float
    count: int

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclasses.dataclass
class DeviceProfile:
    """Per-op device durations from one traced run."""

    by_op: Dict[str, OpTime]
    #: ``record_function`` ranges on the card's timeline, by name: device
    #: time per range, gaps between its kernels included.
    by_module: Dict[str, OpTime]

    @property
    def total_ms(self) -> float:
        return sum(t.total_ms for t in self.by_op.values())

    def matching_ms(self, *substrings: str) -> float:
        """Total device ms over ops whose name contains any substring."""
        return sum(t.total_ms for name, t in self.by_op.items()
                   if any(s in name for s in substrings))

    def matching_count(self, *substrings: str) -> int:
        return sum(t.count for name, t in self.by_op.items()
                   if any(s in name for s in substrings))

    def main_module_ms(self, name_substring: Optional[str] = None) -> float:
        """Device ms of the main annotated range: the range whose name holds
        ``name_substring``, else the longest (the outermost)."""
        if not self.by_module:
            raise RuntimeError("trace contains no record_function range on the device")
        if name_substring is not None:
            hits = {k: v for k, v in self.by_module.items() if name_substring in k}
            if not hits:
                raise KeyError(f"no range matching {name_substring!r}; "
                               f"have {sorted(self.by_module)}")
            return max(v.total_ms for v in hits.values())
        return max(v.total_ms for v in self.by_module.values())


def _parse_trace(trace_dir: str) -> DeviceProfile:
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json*")), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no trace produced under {trace_dir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        tr = json.load(f)
    by_op: Dict[str, OpTime] = {}
    by_module: Dict[str, OpTime] = {}
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        bucket = by_op if cat in _DEVICE_OPS else by_module if cat == _DEVICE_RANGES else None
        if bucket is None:
            continue
        t = bucket.setdefault(e["name"], OpTime(0.0, 0))
        t.total_ms += float(e["dur"]) / 1e3   # dur is in µs
        t.count += 1
    if not by_op and not by_module:
        raise RuntimeError(f"the trace under {trace_dir} holds no device event (no kernel, "
                           "copy or device range): the profiler saw no CUDA work")
    return DeviceProfile(by_op=by_op, by_module=by_module)


def device_op_times(run: Callable[[], object], *,
                    trace_dir: Optional[str] = None) -> DeviceProfile:
    """Run ``run()`` under the profiler and return per-op device durations.

    Call ``run`` once before, so the trace holds no build or warm-up; the
    card is synchronized before the trace stops. Raises when the trace holds
    no device event.
    """
    d = trace_dir or tempfile.mkdtemp(prefix="f4b_trace_")
    with trace(d):
        run()
    return _parse_trace(d)
