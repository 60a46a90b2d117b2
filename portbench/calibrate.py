"""The readings a cell's limits are set from: the program's compared numbers
over many seeds (the lower reading), and the control's (the upper).

    python3 -m portbench.calibrate --workload <name> --seconds <s> --seeds 11 12 13 [--control]

runs the cell's driver once per seed in one process, past the result line,
and prints one JSON line per seed: the compared numbers of the run and,
with ``--control``, ``w4a8``: the same numbers for the program's w4a8 path
(``as_turbo``: int8 activations, the nearest precision below the
configuration's bf16; the control), teacher forced on the same tokens at
the same positions over the same cache, a block of rows at a time, and
judged by the reference run on the experts the control chose. Beside the
compared numbers each line gives the gaps' widest, 99th percentile and the
share of tokens that are not the reference's best, for the program and the
control. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import correct, harness, registry, routes  # noqa: E402
from portbench.inputs import ModelSpec  # noqa: E402


def teacher_forced(spec: ModelSpec, convert):
    """fn(model, caches, tokens [B, T], start) -> the first-choice tokens
    [B, T] of ``convert(model)`` (``as_turbo`` shares the weights), teacher
    forced at positions start .. start + T - 1 over ``caches``, a block of
    rows at a time, and the experts it chose [layers, B, T, k]."""
    from portbench.drivers import decode

    def control(model, caches, tokens, start):
        turbo = convert(model)
        t = tokens.shape[1]
        pos = torch.arange(start, start + t, dtype=torch.int32, device=tokens.device)
        firsts, chosen = [], []
        for rows in decode.row_blocks(tokens.shape[0]):
            outs = {}
            tap = routes.Tap(turbo, lambda layer, out: outs.__setitem__(layer, out)).attach()
            try:
                with torch.no_grad():
                    logits, _ = turbo(tokens[rows.start:rows.stop],
                                      decode.cache_rows(caches, rows), pos)
            finally:
                tap.detach()
            firsts.append(logits.argmax(dim=-1).cpu())
            chosen.append(torch.stack([
                routes.choices(outs[layer], spec.top_k).reshape(len(rows), t, -1)
                for layer in range(len(turbo.blocks))]).cpu())
            del logits, outs
        return torch.cat(firsts), torch.cat(chosen, dim=1)
    return control


def readings(cell: registry.Cell, seed: int, seconds: float, device, control: bool,
             t_start: float) -> dict:
    from fused4bit_tpu_torch.models import as_turbo

    spec = ModelSpec.from_config(cell.config)
    controls = {"w4a8": teacher_forced(spec, as_turbo)} if control else {}
    ctx = harness.Context(cell=cell, spec=spec, seed=seed, seconds=seconds, trace=False,
                          device=device, t_start=t_start, controls=controls)
    out = registry.driver(cell.traffic["driver"]).run(ctx)
    harness.free(device)
    r = {"seed": seed, **out.checks, "gaps": correct.gap_stats(out.gaps), **out.end_to_end,
         "memory_peak_bytes": out.memory_peak_bytes, "card": out.card,
         "reference_s": out.reference_s}
    for name, c in out.controls.items():
        r[name] = {**{k: v for k, v in c.items() if k != "gaps"},
                   "gaps": correct.gap_stats(c["gaps"])}
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    t_start = T_START
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0), args.control, t_start)
        print(json.dumps({"workload": cell.name, **r}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
