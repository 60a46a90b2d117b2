"""Persistence and measurement: checkpoints and the elastic step loop, the
roofline model, profiler traces, layer spans and per-kernel device times,
and timers."""
from .benchmark import (
    BenchmarkResult,
    print_table,
    time_chain_slope,
    time_fn,
    time_fn_scan,
    time_fn_slope,
)
from .checkpoint import load, save
from .device_profile import DeviceProfile, OpTime, device_op_times
from .elastic import elastic_loop, latest_step, prune_checkpoints
from .profiling import SpanMap, annotate, replay_span_ms, span_maps, trace
from .roofline import H100_SXM, ChipSpec, RooflineReport, linear_roofline

__all__ = [
    "BenchmarkResult",
    "ChipSpec",
    "DeviceProfile",
    "H100_SXM",
    "OpTime",
    "RooflineReport",
    "SpanMap",
    "annotate",
    "device_op_times",
    "elastic_loop",
    "latest_step",
    "linear_roofline",
    "load",
    "print_table",
    "prune_checkpoints",
    "replay_span_ms",
    "save",
    "span_maps",
    "time_chain_slope",
    "time_fn",
    "time_fn_scan",
    "time_fn_slope",
    "trace",
]
