"""``calibrate``'s readings for the cells of the ``decode_hybrid`` driver:
the program's compared numbers over many seeds (the lower reading) and the
w4a8 control's (the upper).

    python3 -m portbench.calibrate_hybrid --workload <name> --seconds <s> --seeds 11 12 13 [--control] [--witness]

prints one JSON line per seed, as ``calibrate`` does, with each run's mean
gap at every step (``gap_by_step``) and mean route gap at every MoE layer
(``route_gap_by_layer``). The control is the program's w4a8 path
(``as_turbo``: int8 activations, the nearest precision below the
configuration's bf16), teacher forced on the served tokens one decode step
at a time over every sequence, from caches seeded again (a window layer's
ring holds one step's position beyond its window, so the control cannot
take the 32 positions in one forward), and judged by the reference on the
experts the control chose. The witness (``bf16_plain``) is the plain
reference itself with bf16 activations, teacher forced on the same tokens
(``decode_hybrid.PlainWitness``): what bf16 alone costs, without the
program. The benchmark's own runs run neither.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import correct, harness, registry  # noqa: E402
from portbench.drivers import decode, decode_hybrid  # noqa: E402
from portbench.inputs import ModelSpec  # noqa: E402


def stepwise_control(model, caches, tokens, start):
    """The first-choice tokens [B, T] of ``as_turbo(model)``, teacher forced
    one position at a time from ``start`` over ``caches``, and the experts
    it chose [MoE layers, B, T, k]."""
    from fused4bit_tpu_torch.models import MoEBlock, as_turbo

    turbo = as_turbo(model)
    b, t = tokens.shape
    kept = decode._Kept()
    tap = decode_hybrid.Tap(turbo, kept).attach()
    firsts = []
    try:
        with torch.no_grad():
            for i in range(t):
                pos = torch.full((b, 1), start + i, dtype=torch.int32, device=tokens.device)
                logits, caches = turbo(tokens[:, i:i + 1], caches, pos)
                firsts.append(logits[:, 0].argmax(dim=-1).cpu())
                del logits
    finally:
        tap.detach()
    moe = [i for i, blk in enumerate(turbo.blocks) if isinstance(blk.moe, MoEBlock)]
    chosen = torch.stack([torch.stack([turbo.blocks[layer].moe.route(out).expert_indices
                                       for layer, out in kept.outs[s * len(moe):(s + 1) * len(moe)]])
                          for s in range(t)])                           # [T, MoE layers, B, k]
    return torch.stack(firsts, dim=1), chosen.permute(1, 2, 0, 3).cpu()


def by_step(gaps: torch.Tensor) -> list:
    """The mean gap of each step over the sequences, gaps [B, steps]."""
    return [round(float(g), 5) for g in gaps.float().mean(dim=0)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate_hybrid")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_hybrid: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    device = torch.device("cuda", 0)
    t_start = T_START
    for seed in args.seeds:
        controls = {"w4a8": stepwise_control} if args.control else {}
        if args.witness:
            controls["bf16_plain"] = decode_hybrid.PlainWitness(torch.bfloat16)
        ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=seed,
                              seconds=args.seconds, trace=False, device=device,
                              t_start=t_start, controls=controls)
        out = decode_hybrid.run(ctx)
        harness.free(device)
        by_layer = out.route_gaps_by_layer
        r = {"seed": seed, **out.checks, "gaps": correct.gap_stats(out.gaps),
             "gap_by_step": by_step(out.gaps), "route_gap_by_layer": by_layer["program"],
             **out.end_to_end, "memory_peak_bytes": out.memory_peak_bytes, "card": out.card,
             "reference_s": out.reference_s}
        for name, c in out.controls.items():
            r[name] = {**{k: v for k, v in c.items() if k != "gaps"},
                       "gaps": correct.gap_stats(c["gaps"]), "gap_by_step": by_step(c["gaps"]),
                       "route_gap_by_layer": by_layer[name]}
        print(json.dumps({"workload": cell.name, **r}), flush=True)
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
