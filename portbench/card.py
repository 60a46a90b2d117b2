"""The card as ``nvidia-smi`` reads it: its name and power limit, and its
clocks, power draw and temperature sampled while a window runs.

A window's rate follows the SM clock wherever the card holds it below its
maximum (power, heat or the driver's own choice), so every run records
what the clock did beside what it measured. The sampler is one
``nvidia-smi`` process that the run starts before the window and stops,
and waits for, after it.
"""
from __future__ import annotations

import statistics
import subprocess
from typing import Dict, List, Optional

FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu",
          "clocks_throttle_reasons.active")
NAMES = ("sm_clock_mhz", "mem_clock_mhz", "power_w", "temp_c")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def summary(lines: List[str]) -> Dict[str, object]:
    """Median, least and most of each sampled number, and the throttle
    reasons seen (a bit mask, as nvidia-smi prints it)."""
    cols: Dict[str, List[float]] = {n: [] for n in NAMES}
    reasons = set()
    for line in lines:
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != len(FIELDS):
            continue
        try:
            vals = [float(p) for p in parts[:len(NAMES)]]
        except ValueError:
            continue
        for n, v in zip(NAMES, vals):
            cols[n].append(v)
        reasons.add(parts[-1])
    out: Dict[str, object] = {"samples": len(cols[NAMES[0]])}
    for n, v in cols.items():
        if v:
            out[n] = [min(v), statistics.median(v), max(v)]
    out["throttle_reasons"] = sorted(reasons)
    return out


class Sampler:
    """``with Sampler() as s:`` samples the card every ``period_ms`` until the
    block ends; ``s.result`` is then its :func:`summary` (None where
    nvidia-smi is absent)."""

    def __init__(self, period_ms: int = 250):
        self.period_ms = period_ms
        self.proc: Optional[subprocess.Popen] = None
        self.result: Optional[Dict[str, object]] = None

    def __enter__(self) -> "Sampler":
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--id=0", f"--query-gpu={','.join(FIELDS)}",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate()
        self.result = summary(out.splitlines())
