"""Driver ``decode``: offline batched generation from a long KV cache,
replayed from one CUDA graph.

The mix gives the prompt length (``context``), the generation's length
(``output_tokens``), the steps the window decodes from the generation's
first (``steps``) and how the batch is sized (``batch_fill``, see
:func:`batch`): every sequence's cache holds ``context + output_tokens``
positions, as a deployment reserves them.

Set-up builds the model from the seed, writes each layer's cache a block
of rows at a time with the seeded keys and values of ``context`` positions
(``inputs.prefix_kv``, through the cache's own ``append``), draws the first
token of every sequence, runs the port's ``bench.decode_loop`` (``steps``
greedy steps from position ``context``) once eagerly on a side stream,
captures it in one CUDA graph and replays it once. The window replays the
graph and fetches each replay's tokens to the host, for ``--seconds``:
every replay decodes the same positions. ``decode_tok_s`` is batch x steps
of the replays completed over the window's seconds. The card's clocks,
power and temperature are sampled through the window (``card.Sampler``).

The graph holds no work of the benchmark's. While it is captured, a hook
on each router keeps a reference to the router's output: the graph's pool
then keeps that buffer to itself, and each replay leaves in it the logits
the program routed by. A loop in which the hooks saw other than one router
call a layer and step stops the run with an error. The roofline metrics
count the experts each step hit from those logits, and the reference
follows them. A traced run times the replay by CUDA events (the card held
in a spin kernel while the host enqueues it) and records
``traced_replays`` replays under the profiler.

Then the program is freed and the plain reference runs the same positions
of every sequence, teacher forced on the replay's tokens and experts, from
the same seeded cache, a block of rows at a time. Compared (``correct``):
``mean_logit_gap``, the mean gap of a served token; ``worst_seq_logit_gap``,
the largest mean gap of one sequence; ``mean_route_gap``, the mean margin
of the chosen experts below the reference's top-k; and
``replays_differing``, the replays whose tokens differ from the first's.
"""
from __future__ import annotations

import statistics
import time

import torch

from fused4bit_tpu_torch.bench import decode_loop
from fused4bit_tpu_torch.layers.kv_cache import QuantizedKVCache

from portbench import card, correct, harness, inputs, program, roofline, routes, trace

# Spin cycles that keep the card busy while the host enqueues a timed
# replay (about 55 ms at the H100's clock).
_HOLD_CYCLES = 100_000_000


def batch(spec: inputs.ModelSpec, mix: dict) -> int:
    """The sequences of the mix for ``spec``: the most, in multiples of
    ``batch_fill.multiple``, whose caches fit ``utilization`` of a card of
    ``card_bytes`` once the served weights (``roofline.model_bytes``) and
    ``reserve_bytes`` for activations are taken out."""
    fill = mix["batch_fill"]
    per_seq = roofline.kv_bytes_per_position(spec) * (mix["context"] + mix["output_tokens"])
    room = fill["utilization"] * fill["card_bytes"] - roofline.model_bytes(spec) \
        - fill["reserve_bytes"]
    b = int(room // per_seq) // fill["multiple"] * fill["multiple"]
    if b < 1:
        raise ValueError(f"no sequence of the mix {mix['name']} fits beside the weights")
    return b


def row_blocks(b: int):
    """The batch's rows in the blocks that ``inputs.prefix_kv`` draws."""
    return [range(r0, min(r0 + inputs.KV_BLOCK, b)) for r0 in range(0, b, inputs.KV_BLOCK)]


def cache_rows(caches, rows: range):
    """Views of rows ``rows`` of each layer's cache: writes land in it."""
    return tuple(QuantizedKVCache(*(getattr(c, f)[rows.start:rows.stop]
                                    for f in QuantizedKVCache._FIELDS)) for c in caches)


class _Kept:
    """The router outputs of one loop, in call order: a reference to each
    (no copy), so that a captured graph refreshes them at each replay."""

    def __init__(self):
        self.outs = []

    def reset(self) -> None:
        self.outs = []

    def __call__(self, layer: int, out: torch.Tensor) -> None:
        self.outs.append((layer, out))

    def logits(self, layers: int, steps: int) -> torch.Tensor:
        """[layers, steps, B, E]; raises unless every layer's router was
        called once at each step, in order."""
        seen = [layer for layer, _ in self.outs]
        if seen != list(range(layers)) * steps:
            raise RuntimeError(
                f"the router hooks saw {len(seen)} calls in a loop of {steps} steps over "
                f"{layers} layers, not one a layer and step: the program no longer routes "
                "through each block's moe.router, so the benchmark cannot read the experts "
                "it chose")
        out = torch.stack([o for _, o in self.outs])
        return out.reshape(steps, layers, *out.shape[1:]).transpose(0, 1)


class _Graph:
    """``decode_loop`` from fixed tokens and positions, captured whole: the
    copy of ``fused4bit_tpu_torch.bench.CapturedLoop`` with a start
    position (that class starts at position 0). The router hooks are on
    while it captures."""

    def __init__(self, model, caches, tok0, pos0, steps: int, tap: routes.Tap):
        dev = tok0.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            decode_loop(model, caches, tok0, pos0, steps)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        tap.sink.reset()
        tap.attach()
        try:
            with torch.cuda.graph(self.graph):
                self.toks = decode_loop(model, caches, tok0, pos0, steps)
        finally:
            tap.detach()
        self.graph.replay()
        torch.cuda.synchronize(dev)

    def __call__(self):
        self.graph.replay()
        return self.toks.cpu()

    def device_ms(self) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


class _Eager:
    """The same loop without a graph, on a device that has none (the CPU
    tests drive the rest of a run through it); the hooks stay on."""

    def __init__(self, model, caches, tok0, pos0, steps: int, tap: routes.Tap):
        self.args, self.tap = (model, caches, tok0, pos0, steps), tap.attach()

    def __call__(self):
        self.tap.sink.reset()
        return decode_loop(*self.args).cpu()

    def device_ms(self):
        return None


def run(ctx: harness.Context) -> harness.Outcome:
    mix, spec, dev = ctx.cell.traffic, ctx.spec, ctx.device
    b, ctxlen, steps = batch(spec, mix), mix["context"], mix["steps"]
    max_seq = ctxlen + mix["output_tokens"]
    max_seq += max_seq % 2
    blocks = row_blocks(b)
    model = program.build(spec, ctx.seed, dev)
    mcfg = program.model_config(spec, ctx.cell.config["name"], max_seq)
    caches = model.init_cache(mcfg, b, max_seq)
    for rows in blocks:
        zeros = torch.zeros((len(rows),), dtype=torch.int32, device=dev)
        for layer, cache in enumerate(cache_rows(caches, rows)):
            k, v = inputs.prefix_kv(spec, ctx.seed, layer, rows, ctxlen, mix["kv_std"], dev)
            cache.append(k, v, start=zeros)
            del k, v
    g = inputs.generator(ctx.seed, "tok0", device=dev)
    tok0 = torch.randint(1, spec.vocab, (b, 1), generator=g, device=dev, dtype=torch.int32)
    pos0 = torch.full((b, 1), ctxlen, dtype=torch.int32, device=dev)

    tap = routes.Tap(model, _Kept())
    loop = (_Graph if dev.type == "cuda" else _Eager)(model, caches, tok0, pos0, steps, tap)

    with card.Sampler() as sampled:
        t0 = time.perf_counter()
        first = loop()
        replays, differing = 1, 0
        while time.perf_counter() < t0 + ctx.seconds:
            differing += int(not torch.equal(loop(), first))
            replays += 1
        window = time.perf_counter() - t0
    end_to_end = {"decode_tok_s": b * steps * replays / window, "setup_s": t0 - ctx.t_start}

    # the program's expert choices at each step of the replays: [layers, steps, B, k]
    kept = tap.sink.logits(spec.layers, steps)
    chosen = torch.stack([torch.stack([routes.choices(kept[layer, s], spec.top_k)
                                       for s in range(steps)]) for layer in range(spec.layers)])
    obs = harness.Observations(driver="decode")
    if ctx.trace:
        per_step = [roofline.decode_step(spec, b, [ctxlen + s + 1] * b, [
            torch.bincount(chosen[layer, s].flatten().long(), minlength=spec.experts).tolist()
            for layer in range(spec.layers)]) for s in range(steps)]
        obs.work = {k: roofline.Work(sum(w[k].flops for w in per_step) / steps,
                                     sum(w[k].bytes for w in per_step) / steps)
                    for k in per_step[0]}
        times = [loop.device_ms() for _ in range(3)]
        if times[0] is not None:
            obs.device_ms_per_step = statistics.median(times) / steps
        reps = mix["traced_replays"]
        obs.trace = trace.record(lambda: [loop() for _ in range(reps)])
        obs.steps_traced = reps * steps
        obs.own_kernels = trace.csrc_kernels(program.csrc())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tap.detach()
    chosen = chosen.transpose(1, 2).cpu()                                # [layers, B, steps, k]
    del kept

    served = first[:, :, 0].t()                                         # [B, steps]
    fed = torch.cat([tok0.cpu(), served[:, :-1]], dim=1).long()
    ctrl = {name: fn(model, caches, fed.to(dev), ctxlen) for name, fn in ctx.controls.items()}
    del loop, caches, model, tap
    harness.free(dev)
    t_ref = time.perf_counter()

    mod, ref = harness.reference(ctx)

    def jobs(routes_of):
        return [mod.Job(fed[rows.start:rows.stop], start=ctxlen,
                        routes=routes_of[:, rows.start:rows.stop],
                        prefix=lambda layer, rows=rows: inputs.prefix_kv(
                            spec, ctx.seed, layer, rows, ctxlen, mix["kv_std"], dev))
                for rows in blocks]

    runs = {"program": (served, chosen), **ctrl}
    done = ref.run([j for r in runs.values() for j in jobs(r[1])])
    judged = {}
    for i, (name, r) in enumerate(runs.items()):
        part = done[i * len(blocks):(i + 1) * len(blocks)]
        gaps = torch.cat([correct.token_gaps(j.logits, r[0][rows.start:rows.stop])
                          for j, rows in zip(part, blocks)])                # [B, steps]
        route_gaps = torch.cat([g for j in part for g in j.route_gaps])
        judged[name] = {**correct.compared(gaps, float(route_gaps.mean())), "gaps": gaps}
    prog = judged.pop("program")
    gaps = prog.pop("gaps")
    return harness.Outcome(end_to_end=end_to_end, obs=obs, attempted=b * steps * replays,
                           failed=0, checks={**prog, "replays_differing": differing},
                           memory_peak_bytes=peak, gaps=gaps, controls=judged,
                           card=sampled.result, reference_s=time.perf_counter() - t_ref)
