"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository. ``--workload`` names an entry of
``BENCHMARK.json``'s ``workloads``; its configuration, traffic mix, limits
and metric readers are files of this folder (``registry``). The last line
of standard output is the result as one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error give the same compared numbers.
An earlier line gives the card's name, power limit and most SM clock, and
the line before the compared numbers on standard error (and the result's
``card``) its clocks, power and temperature through the window.

The run exits with another code than 0, and prints no result, when there
is no CUDA card or fewer than the cell asks for, and when ``sys.modules``
holds ``jax``, ``jaxlib``, ``flax`` or ``fused4bit_tpu`` (whole top-level
names) once the window has closed. The program's build and kernel caches
stay inside the checkout, at fixed paths.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import card, registry  # noqa: E402

# Caches a library may keep, at fixed paths inside the checkout; the port's
# nvcc library is built into fused4bit_tpu_torch/_build/ by the port itself.
_CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
           "TORCHINDUCTOR_CACHE_DIR": "inductor"}
CACHE_ROOT = registry.REPO / ".portbench_cache"


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in _CACHES.items():
        os.environ[var] = str(CACHE_ROOT / sub)
    import torch

    from portbench import harness
    from portbench.inputs import ModelSpec

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    print(f"card: {card.card_line()}", flush=True)
    ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0), t_start=T_START)
    line, checks = harness.run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(checks, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
