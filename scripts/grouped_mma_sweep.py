#!/usr/bin/env python3
"""The w4a16 grouped expert kernels K2, K12 and K13 on one GPU: where their
time goes, and the launch shapes of the tensor-core body they run in bf16.

Run from the repository root:

    env PYTHONPATH=. python3 scripts/grouped_mma_sweep.py [--profile] [--sweep] [--crossover]

At the `layer2` expert shapes (8 experts, gate/up N=14336 K=4096 and down
N=4096 K=14336, random weights from a seed), bf16 activations, under two
routings: the decode check's skewed top-2 (``chip_smoke._skewed_plan``: 3
experts hit at T=8) and a spread one that hits all 8 experts (each token's
pair (2i, 2i + 1) mod 8, as a serving step's routing does).

``--profile`` (the default when neither is given) times K2
``grouped_int4_matmul``, K13 ``grouped_int4_matmul_per_group`` (per group of
128, planar_groups) and K12 (the same wrapper on planar weights per group of
128, what ``convert_checkpoint`` gives) at decode (T=8) at tile_m 16, 32 and 64 and at
the prefill (T=600) at tile_m 128: each wrapper call with CUDA events, the
L2 cache flushed before each call (``chip_smoke.Timer``), and under
``torch.profiler`` its device time split into the first pass over x (the
rows in use), the main kernel and the second pass that adds a K split's
partials. At decode it records whether the tokens' rows are the same bits
at every tile_m. It calls only the public wrappers, so the same script times
a parent tree (``cd <parent checkout> && env PYTHONPATH=. python3 <this
script> --profile``).

``--sweep`` launches the tensor-core body at decode (T=8, tile_m 16) at the
launch rule's shape (``ops._mma._grouped_mma_launch``), at the
linear rule's (K1's and K6's ``_mma_launch``, K7's ``_fold_mma_launch``) and at other
candidate shapes (ws k steps per warp, kw warps along K per CTA, splits CTAs
along K), each held bit for bit against the linear body at the same shape
on each expert's weights (``chip_smoke.same_as_linear``), and times each
cold and under the profiler.

``--crossover`` times K2 and K13 on both bodies, ``csrc/int4_mma.cuh``'s
(``ops._mma._launch``) and the warpgroup body of
``csrc/grouped_wgmma.cu`` (``ops._wg._launch``), under random routing:
at 8 experts top-2 at the benchmark cells' widths (K2: Mixtral-8x7B's
gate/up N=14336 K=4096 and down N=4096 K=14336; K13 per group of 128:
Mixtral-8x22B's N=16384 K=6144 and N=6144 K=16384), T tokens at tile_m 16
(T_pad 144 to 4096) and a prefill of 2048 tokens at tile_m 128; then K2 at
16 experts top-2 (Mixtral-8x7B's widths) and K2 and K13 at 64 experts top-8
(``models/config.py``'s DEEPSEEK_V3: N=11008 K=4096, N=4096 K=11008) at
tile_m 16, decode (T=8) and the self-draft verify (T=40) among them. Each
call is timed with CUDA events, the L2 flushed before it; the two bodies'
outputs are held to each other within the bf16 bar, and each line gives
the routed rows an expert (``(T_pad - E * tile_m) / E``) and names the body
``ops.grouped_matmul._body`` chooses (``WG_MIN_EXPERT_ROWS`` there comes from
this sweep).

One JSON line per measurement; the card's name and power limit lead the
output. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.ops import _mma, _wg
from fused4bit_tpu_torch.layers import dispatch, make_dispatch_plan, topk_route
from fused4bit_tpu_torch.quant import quantize

E, FFN, HIDDEN = 8, 14336, 4096
PROJECTIONS = {"gate_up": (FFN, HIDDEN), "down": (HIDDEN, FFN)}
DECODE_TILES = (16, 32, 64)
# K/2 cut into this many slices of whole chunks, with this many warps along
# K per CTA (the rest are CTAs along K).
SLICES = ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (8, 1), (8, 4), (8, 8), (16, 8))


def _spread_routing(t, device):
    """Top-2 routing that hits every expert: token i to experts 2i and
    2i + 1 (mod E)."""
    i = torch.arange(t, device=device)
    logits = torch.zeros((t, E), device=device)
    logits[i, (2 * i) % E] = 10.0
    logits[i, (2 * i + 1) % E] = 9.0
    return topk_route(logits, 2, E)


ROUTINGS = {"skewed": lambda gen, t: cs._skewed_plan(t, E, 2, 16, gen, "cuda")[0],
            "spread": lambda gen, t: _spread_routing(t, "cuda")}


def _part(name: str) -> str:
    """Which part of a grouped call a device kernel belongs to."""
    if "bitwise_not" in name:
        return "flush"
    if "rows_used" in name or "rows_in_use" in name:
        return "first_pass"
    if "reduce" in name:
        return "second_pass"
    return "main"


def device_parts(fn, flush, calls=10) -> dict:
    """Device ms per call of each part (see :func:`_part`), the L2 flushed
    before each call by a kernel of its own (left out of the sums)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    out, main = {}, []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        part = _part(e.key)
        out[part] = out.get(part, 0.0) + (e.cuda_time_total if t is None else t) / calls / 1e3
        if part == "main":
            main.append(e.key[:80])
    out.pop("flush", None)
    out["total"] = sum(out.values())
    out["main_kernels"] = main
    return out


def _weights(gen, n, k):
    w = torch.randn((E, n, k), generator=gen, device="cuda") * k ** -0.5
    return {"K2": quantize(w), "K13": cs._pg_quantize(w), "K12": cs._planar_pg_quantize(w)}


def _op(kernel):
    return ops.grouped_int4_matmul if kernel == "K2" else ops.grouped_int4_matmul_per_group


def profile_wrappers(gen, card) -> None:
    timer = cs.Timer("cuda")
    for proj, (n, k) in PROJECTIONS.items():
        weights = _weights(gen, n, k)
        for routing_name, routing_of in ROUTINGS.items():
            for t, tiles in ((8, DECODE_TILES), (600, (128,))):
                x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
                routing = routing_of(gen, t)  # one routing for every tile_m
                for kernel, qt in weights.items():
                    op = _op(kernel)
                    token_rows = []
                    for tile_m in tiles:
                        plan = make_dispatch_plan(routing, E, tile_m=tile_m)
                        xs, gids = dispatch(x, routing, plan), plan.tile_group_ids
                        fn = lambda: op(xs, gids, qt, tile_m=tile_m)  # noqa: E731
                        token_rows.append(fn()[plan.rows])
                        line = dict(kernel=kernel, projection=proj, routing=routing_name, t=t,
                                    tile_m=tile_m, n=n, k=k, t_pad=plan.t_pad,
                                    tokens_per_expert=routing.tokens_per_expert.tolist(),
                                    wrapper_cold_ms=timer(fn, iters=20 if t == 8 else 5),
                                    device_ms=device_parts(fn, timer.flush),
                                    **cs.grouped_bound(xs, gids, qt, 2 * t), card=card)
                        print(json.dumps(line), flush=True)
                    if t == 8:
                        same = all(torch.equal(token_rows[0], r) for r in token_rows[1:])
                        print(json.dumps(dict(kernel=kernel, projection=proj, routing=routing_name,
                                              t=t, tile_m=list(tiles),
                                              token_rows_same_bits_at_every_tile_m=same)),
                              flush=True)
        del weights
        torch.cuda.empty_cache()


def candidates(n, k, sms, fold) -> list:
    """The rule's shape, the linear rule's (``fold``: K7's), and K/2 cut into
    the slices of :data:`SLICES`, in whole chunks."""
    chunks = -(-(k // 2) // 64)
    linear = cs._fold_mma_launch if fold else cs._mma_launch
    out = [_mma._grouped_mma_launch(n, k, sms), linear(n, k, sms)]
    for slices, kw in SLICES:
        if slices <= chunks:
            ws = 8 * -(-chunks // slices)
            out.append((ws, kw, -(-8 * chunks // (kw * ws))))
    return list(dict.fromkeys(out))


def sweep_shapes(gen, card) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = cs.Timer("cuda")
    tile_m = 16
    for proj, (n, k) in PROJECTIONS.items():
        weights = _weights(gen, n, k)
        for routing_name, routing_of in ROUTINGS.items():
            routing = routing_of(gen, 8)
            plan = make_dispatch_plan(routing, E, tile_m=tile_m)
            xs = dispatch(torch.randn((8, k), generator=gen, device="cuda").bfloat16(), routing,
                          plan)
            gids = plan.tile_group_ids
            for kernel, qt in weights.items():
                rule = _mma._grouped_mma_launch(n, k, sms)
                line = dict(kernel=kernel, projection=proj, routing=routing_name, n=n, k=k,
                            tokens_per_expert=routing.tokens_per_expert.tolist(),
                            rule=list(rule), card=card)
                for cand in candidates(n, k, sms, kernel == "K13"):
                    fn = lambda: _mma._launch(xs, qt, kernel, gids=gids,  # noqa: E731
                                              tile_m=tile_m, launch=cand)
                    cs.same_as_linear(f"{kernel} {cand}", xs, gids, qt, tile_m, fn(), cand)
                    line[str(list(cand))] = dict(cold_ms=timer(fn),
                                                 device_ms=device_parts(fn, timer.flush))
                print(json.dumps(line), flush=True)
        del weights
        torch.cuda.empty_cache()


# The crossover sweep: (experts, top-k, kernel, {projection: (N, K)},
# tokens at tile_m 16). At 8 experts the cells' widths (T_pad 144 to 4096 at
# top-2), then the prefill's 2048 tokens at tile_m 128; at 16 and 64
# experts decode, the verify and the rows an expert around the crossover.
MIXTRAL_8X7B = {"gate_up": (14336, 4096), "down": (4096, 14336)}
MIXTRAL_8X22B = {"gate_up": (16384, 6144), "down": (6144, 16384)}
DEEPSEEK_V3 = {"gate_up": (11008, 4096), "down": (4096, 11008)}
CELL_T = (8, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256, 384, 512, 1024, 1984)
CROSSOVER = ((8, 2, "K2", MIXTRAL_8X7B, CELL_T), (8, 2, "K13", MIXTRAL_8X22B, CELL_T),
             (16, 2, "K2", MIXTRAL_8X7B, (8, 40, 64, 96, 128, 160, 192, 256)),
             (64, 8, "K2", DEEPSEEK_V3, (8, 40, 64, 96, 128, 160, 192, 256, 384, 512)),
             (64, 8, "K13", DEEPSEEK_V3, (8, 40, 64, 96, 128, 160, 192, 256, 384, 512)))


def crossover(gen, card) -> None:
    gm = ops.grouped_matmul
    timer = cs.Timer("cuda")
    for e, top_k, kernel, projections, tokens in CROSSOVER:
        for proj, (n, k) in projections.items():
            w = torch.randn((e, n, k), generator=gen, device="cuda") * k ** -0.5
            qt = quantize(w) if kernel == "K2" else cs._pg_quantize(w)
            del w
            runs = [(t, 16) for t in tokens] + ([(2048, 128)] if e == 8 else [])
            for t, tile_m in runs:
                routing = topk_route(torch.randn((t, e), generator=gen, device="cuda"), top_k, e)
                plan = make_dispatch_plan(routing, e, tile_m=tile_m)
                x = torch.randn((t, k), generator=gen, device="cuda").bfloat16()
                xs, gids = dispatch(x, routing, plan), plan.tile_group_ids
                old = lambda: _mma._launch(xs, qt, kernel, gids=gids, tile_m=tile_m)  # noqa: E731
                new = lambda: _wg._launch(xs, qt, kernel, gids=gids, tile_m=tile_m)  # noqa: E731
                y_old, y_new = old(), new()
                tol = cs.BF16_REL_TOL * y_old.float().abs().max().item()
                diff = (y_old.float() - y_new.float()).abs().max().item()
                if diff > 2 * tol:
                    raise AssertionError(f"{kernel} {proj} E={e} T={t}: the bodies differ by "
                                         f"{diff}")
                chosen = gm._body(kernel, True, torch.bfloat16, qt.group_size, plan.t_pad, e,
                                  tile_m, n, k) == "wg"
                line = dict(kernel=kernel, projection=proj, experts=e, top_k=top_k, n=n, k=k,
                            t=t, tile_m=tile_m, t_pad=plan.t_pad,
                            rows_an_expert=(plan.t_pad - e * tile_m) / e,
                            tokens_per_expert=routing.tokens_per_expert.tolist(),
                            old_ms=timer(old, iters=10), wg_ms=timer(new, iters=10),
                            chosen="wg" if chosen else "old", max_diff=diff,
                            **cs.grouped_bound(xs, gids, qt, top_k * t), card=card)
                print(json.dumps(line), flush=True)
            del qt
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grouped_mma_sweep: no CUDA device")
    card = cs.card()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        if args.profile or not (args.sweep or args.crossover):
            profile_wrappers(gen, card)
        if args.sweep:
            sweep_shapes(gen, card)
        if args.crossover:
            crossover(gen, card)


if __name__ == "__main__":
    main()
