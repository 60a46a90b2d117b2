"""``calibrate``'s readings for the cells of the ``decode_mla`` driver: the
program's compared numbers over many seeds (the lower reading), the w4a8
control's (the upper), and two witnesses that each must fail a limit.

    python3 -m portbench.calibrate_mla --workload <name> --seconds <s> \
        --seeds 11 12 13 [--controls w4a8 no_mscale no_groups]

prints one JSON line per seed, as ``calibrate`` does, with each run's mean
gap at every step (``gap_by_step``) and mean route gap at every MoE layer
(``route_gap_by_layer``). Every control is a path of the program, teacher
forced on the served tokens one decode step at a time over every sequence,
from caches seeded again, and judged by the reference on the experts it
chose:

* ``w4a8``: ``as_turbo`` (int8 activations, the nearest precision below
  the configuration's bf16) on every linear, expert and shared expert; the
  absorption's W_UK^T and W_UV keep bf16 activations, as ``as_turbo``
  converts an attention's ``LINEARS`` only;
* ``no_mscale``: the program with YaRN's mscale^2 left out of the latent
  attention's softmax scale;
* ``no_groups``: the program routing by the plain biased top-8, the groups
  ignored.

The benchmark's own runs run none of them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import correct, harness, registry  # noqa: E402
from portbench.calibrate_hybrid import by_step  # noqa: E402
from portbench.drivers import decode, decode_hybrid, decode_mla  # noqa: E402
from portbench.inputs import ModelSpec  # noqa: E402


def _no_mscale(model):
    from fused4bit_tpu_torch.models.transformer import MLAttention, _converted_copy

    out = _converted_copy(model)
    for blk in out.blocks:
        if isinstance(blk.attn, MLAttention):
            blk.attn.softmax_scale = (blk.attn.qk_nope_dim + blk.attn.qk_rope_dim) ** -0.5
    return out


def _no_groups(model):
    from fused4bit_tpu_torch.models.transformer import MoEBlock, _converted_copy

    out = _converted_copy(model)
    for blk in out.blocks:
        if isinstance(blk.moe, MoEBlock):
            blk.moe.n_group = blk.moe.topk_group = 1
    return out


def _w4a8(model):
    from fused4bit_tpu_torch.models import as_turbo

    return as_turbo(model)


CONVERTERS = {"w4a8": _w4a8, "no_mscale": _no_mscale, "no_groups": _no_groups}


def stepwise(convert):
    """fn(model, caches, tokens [B, T], start) -> the first-choice tokens
    [B, T] of ``convert(model)``, teacher forced one position at a time from
    ``start`` over ``caches``, and the experts it chose [MoE layers, B, T,
    k]."""
    def control(model, caches, tokens, start):
        from fused4bit_tpu_torch.models import MoEBlock

        path = convert(model)
        b, t = tokens.shape
        kept = decode._Kept()
        tap = decode_hybrid.Tap(path, kept).attach()
        firsts = []
        try:
            with torch.no_grad():
                for i in range(t):
                    pos = torch.full((b, 1), start + i, dtype=torch.int32, device=tokens.device)
                    logits, caches = path(tokens[:, i:i + 1], caches, pos)
                    firsts.append(logits[:, 0].argmax(dim=-1).cpu())
                    del logits
        finally:
            tap.detach()
        moe = [i for i, blk in enumerate(path.blocks) if isinstance(blk.moe, MoEBlock)]
        chosen = torch.stack([
            torch.stack([path.blocks[layer].moe.route(out).expert_indices
                         for layer, out in kept.outs[s * len(moe):(s + 1) * len(moe)]])
            for s in range(t)])                                          # [T, MoE layers, B, k]
        return torch.stack(firsts, dim=1), chosen.permute(1, 2, 0, 3).cpu()
    return control


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate_mla")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=[], choices=sorted(CONVERTERS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate_mla: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    device = torch.device("cuda", 0)
    t_start = T_START
    for seed in args.seeds:
        controls = {name: stepwise(CONVERTERS[name]) for name in args.controls}
        ctx = harness.Context(cell=cell, spec=ModelSpec.from_config(cell.config), seed=seed,
                              seconds=args.seconds, trace=False, device=device,
                              t_start=t_start, controls=controls)
        out = decode_mla.run(ctx)
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
