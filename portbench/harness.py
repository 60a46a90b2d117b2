"""One run of one cell: the driver of its traffic mix, the metrics, the
check and the result line.

A driver (``drivers/<driver>.py``) builds the program from the seed, warms
every shape its traffic uses, measures its window, reads what the traced
run needs, frees the program and runs the plain reference; it returns an
:class:`Outcome`. This module turns that into the line the benchmark
prints: the end-to-end metrics (``--trace 0``) or the per-layer metrics
that the readers of ``metrics/`` find (``--trace 1``), the device, the
breakdown, the card's clocks through the window and the compared numbers
beside their limits, last.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import pathlib
import sys
from typing import Callable, Dict, List, Optional

import torch

from . import correct, registry
from .inputs import ModelSpec
from .roofline import Work
from .trace import Trace

# Top-level module names that must not be loaded in a run (compared whole:
# the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "fused4bit_tpu")


@dataclasses.dataclass
class Context:
    cell: registry.Cell
    spec: ModelSpec
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                  # host clock at process start
    # name -> fn(model, caches, tokens, start): the tokens another path of
    # the program puts first at each position and the experts it chose,
    # [layers, B, T, k] (calibration only: the control and its witnesses)
    controls: Dict[str, Callable] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Observations:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    driver: str
    trace: Optional[Trace] = None
    own_kernels: tuple = ()
    work: Optional[Dict[str, Work]] = None      # per step, by kernel family
    steps_traced: int = 0                       # decode steps the trace holds
    device_ms_per_step: Optional[float] = None


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    obs: Observations
    attempted: int
    failed: int
    checks: Dict[str, float]                    # the compared numbers, by name
    memory_peak_bytes: int
    gaps: Optional[torch.Tensor] = None          # every compared token's gap
    # name -> the compared numbers of each of ``Context.controls`` and its gaps
    controls: Dict[str, dict] = dataclasses.field(default_factory=dict)
    card: Optional[dict] = None                 # the card sampled through the window
    reference_s: Optional[float] = None         # the plain reference's seconds, after it


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference(ctx: Context):
    """The configuration's plain reference module (``reference/<name>.py``)
    and its model for this run's seed."""
    mod = importlib.import_module(f"portbench.reference.{ctx.cell.config['reference']}")
    return mod, mod.Reference(ctx.spec, ctx.seed, ctx.device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(ctx: Context, root: pathlib.Path = registry.ROOT):
    """Run the cell once; returns the result line's dict (the compared
    numbers are its last key, ``checks``) and the lines that give them on
    standard error."""
    drv = registry.driver(ctx.cell.traffic["driver"])
    out: Outcome = drv.run(ctx)
    checks = correct.judge(out.checks, ctx.cell.limits)
    if ctx.trace:
        readers = registry.metric_readers(root)
        metrics = {}
        for name in ctx.cell.per_layer:
            value = readers[name].read(out.obs)
            if value is not None:
                metrics[name] = {"value": value, "unit": ctx.cell.units[name]}
    else:
        metrics = {name: {"value": out.end_to_end[name], "unit": ctx.cell.units[name]}
                   for name in ctx.cell.end_to_end}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": ctx.cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct.all_ok(checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.obs.trace is not None:
        device["busy_s"] = out.obs.trace.busy_s
        device["window_s"] = out.obs.trace.window_s
        line["breakdown"] = out.obs.trace.breakdown()
    lines = correct.stderr_lines(checks)
    if out.reference_s is not None:
        line["reference_s"] = out.reference_s
        lines = f"the plain reference took {out.reference_s:.1f} s\n{lines}"
    if out.card is not None:
        line["card"] = out.card
        lines = f"card through the window: {json.dumps(out.card)}\n{lines}"
    line["checks"] = correct.result_checks(checks)
    return line, lines
