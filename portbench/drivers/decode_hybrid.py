"""Driver ``decode_hybrid``: the ``decode`` driver's offline batched
generation, replayed from one CUDA graph, for models whose layers hold
caches of two sizes: window layers on rings beside full layers, leading
dense layers, and MoE layers with a sigmoid router, a shared expert and a
share of the experts (``hybrid.HybridSpec``).

The port's model is the registry's entry (``configuration["registry"]`` in
``fused4bit_tpu_torch.models.MODEL_CONFIGS``), checked against the
configuration's published sizes and cut to the experts held here, built
through the port's own constructors from the seeded weights of
``hybrid``. Each layer's cache comes from ``QuantizedTransformer.
init_cache``: ``context + output_tokens`` positions on a full layer, its
ring on a window layer: its window plus the one position a decode step
appends, as a deployment holds it. The batch is the most sequences, in
multiples of ``batch_fill.multiple``, whose caches fit ``utilization`` of
the card beside the weights and ``reserve_bytes``.

Set-up first runs the plain reference (``reference/k_exaone.py``) over the
first decode position of every sequence, which balances each router's
correction bias from its own forward as training leaves it (DeepSeek-V3's
``noaux_tc`` update, ``hybrid.balanced_bias``); the program is built with
those biases, as with the seeded weights. It then writes every layer's
cache through its own ``append``, a block of rows at a time, with the
seeded keys and values of the ``context`` prompt positions (a ring keeps
the last of them), and captures and replays ``bench.decode_loop`` as
``decode`` does, with hooks on the MoE layers' routers. A replay's steps
overwrite the ring slots that held the oldest positions of its first
steps' windows; before each replay the driver puts those slots back from
a copy taken after seeding (:class:`RingRestore`, one copy a tensor), so
that every replay finds the keys the first found. The window,
``decode_tok_s`` and the traced run are ``decode``'s. The work a step needs
is counted here (:func:`step_work`) under ``decode``'s family keys and
three of its own: ``window_attention`` (the window layers' K3 calls over
the positions their windows see), ``shared_expert`` and ``dense_mlp``; the
readers of ``metrics/`` see a decode run (``Observations.driver`` is
``decode``).

The standard error gets what the capture counted a step: the warpgroup
body's share of the experts' launches and the K3 launches over a window;
and the share of the routed pairs that land on the held experts, from the
routes tapped in the replays (a host counter cannot see a replay).

Then the program is freed and the plain reference runs the replay's
positions of every sequence, teacher forced on the served tokens and the
program's experts, from the same seeded prompt cache. Compared:
``decode``'s four numbers, the route gap taken on the biased selection
scores, and ``early_route_gap``, the route gap of the first
``EARLY_MOE_LAYERS`` MoE layers alone. Deeper, the INT4 KV codes that
bf16's rounding flips (a flip moves a key by a fifteenth of its range)
compound through the post-norm blocks, so that the program's gaps there
are bf16's own (the plain reference run in bf16 reads them too) and a
control in a lower precision parts from it by barely twice; at the first
MoE layers the program parts from the reference by bf16's rounding
alone, and the w4a8 control by 4.5 times as much (``PERF.md``). Controls (``calibrate_hybrid``): a path of the program runs before
it is freed, one decode step at a time from re-seeded caches; a
:class:`PlainWitness` runs the plain reference in another precision after
it, on the program's fed tokens.
"""
from __future__ import annotations

import dataclasses
import importlib
import statistics
import sys
import time
from typing import Dict, List

import torch

from fused4bit_tpu_torch.layers.linear import DenseLinear, QuantizedLinear
from fused4bit_tpu_torch.layers.moe import MoEINT4
from fused4bit_tpu_torch.models import MODEL_CONFIGS, ModelConfig, QuantizedTransformer
from fused4bit_tpu_torch.models.transformer import Attention, DenseMLP, MoEBlock, TransformerBlock
from fused4bit_tpu_torch.ops import launch_counts

from portbench import card, correct, harness, hybrid, inputs, program, roofline, spans, trace
from portbench.drivers import decode
from portbench.hybrid import HybridSpec
from portbench.roofline import Work

# MoE layers whose route gap ``early_route_gap`` averages: layers 1-4 of 48
EARLY_MOE_LAYERS = 4

def model_config(spec: HybridSpec, cfg: dict) -> ModelConfig:
    """The registry's entry for the configuration, with the experts held
    here; raises where the registry's published sizes are not the file's."""
    base = MODEL_CONFIGS[cfg["registry"]]
    have = (base.hidden, base.num_heads, base.num_kv_heads, base.head_dim, base.vocab_size,
            tuple(base.window(i) for i in range(base.num_layers)), base.dense_layers,
            base.dense_ffn, base.moe.ffn_dim, base.shared_ffn, base.moe.num_experts,
            base.moe.top_k, base.routed_scale, base.rope_theta, base.rms_eps)
    want = (spec.hidden, spec.heads, spec.kv_heads, spec.head_dim, spec.vocab, spec.windows,
            spec.dense_layers, spec.dense_ffn, spec.moe_ffn, spec.shared_ffn,
            spec.router_experts, spec.top_k, spec.routed_scale, spec.rope_theta, spec.rms_eps)
    if have != want:
        raise ValueError(f"the registry's {base.name} is {have}, the configuration {want}")
    return dataclasses.replace(base, first_expert=spec.first_expert,
                               held_experts=spec.experts)


def build(spec: HybridSpec, mcfg: ModelConfig, seed: int, device,
          biases: List[torch.Tensor]) -> QuantizedTransformer:
    """The model from the seeded weights, one tensor at a time: every
    projection, expert stack, shared expert, dense layer and the lm_head
    quantized in the configuration's granularity; the routers bf16
    ``DenseLinear``s with the float32 correction biases ``biases``, one a
    MoE layer in order; norms 1."""
    kw = {} if spec.granularity == "per_row" else dict(granularity=spec.granularity,
                                                       group_size=spec.group_size)

    def linear(w):
        return QuantizedLinear.from_dense(w, **kw)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    blocks = []
    for layer in range(spec.layers):
        def w(name):
            return hybrid.layer_weight(spec, seed, layer, name, device)

        def mlp(prefix, span_name):
            return DenseMLP(linear(w(f"{prefix}_gate")), linear(w(f"{prefix}_up")),
                            linear(w(f"{prefix}_down")), span_name=span_name)

        window = mcfg.window(layer)
        attn = Attention(linear(w("wq")), linear(w("wk")), linear(w("wv")), linear(w("wo")),
                         num_heads=mcfg.num_heads, num_kv_heads=mcfg.num_kv_heads,
                         head_dim=mcfg.head_dim, rope_theta=mcfg.rope_theta, window=window,
                         q_norm=ones(mcfg.head_dim), k_norm=ones(mcfg.head_dim),
                         rope=bool(window), rms_eps=mcfg.rms_eps)
        if layer < mcfg.dense_layers:
            ffn = mlp("dense", "mlp.dense")
        else:
            ffn = MoEBlock(DenseLinear(w("router").to(torch.bfloat16)),
                           *(MoEINT4.from_dense(w(n), **kw) for n in ("w_gate", "w_up", "w_down")),
                           num_experts=mcfg.moe.num_experts, top_k=mcfg.moe.top_k,
                           router_bias=biases[layer - mcfg.dense_layers].to(
                               device=device, dtype=torch.float32),
                           routed_scale=mcfg.routed_scale, first_expert=mcfg.first_expert,
                           shared=mlp("shared", "moe.shared"))
        blocks.append(TransformerBlock(ones(spec.hidden), attn, ones(spec.hidden), ffn,
                                       rms_eps=mcfg.rms_eps, post_norm=mcfg.block == "exaone4"))
    return QuantizedTransformer(inputs.embedding(spec, seed, device), blocks, ones(spec.hidden),
                                linear(inputs.lm_head(spec, seed, device)), rms_eps=mcfg.rms_eps)


def batch(spec: HybridSpec, mix: dict) -> int:
    """``decode.batch``'s rule with each layer's cache at its own size."""
    fill = mix["batch_fill"]
    per_seq = hybrid.kv_bytes_per_sequence(spec, mix["context"] + mix["output_tokens"], 1)
    room = fill["utilization"] * fill["card_bytes"] - hybrid.model_bytes(spec) \
        - fill["reserve_bytes"]
    b = int(room // per_seq) // fill["multiple"] * fill["multiple"]
    if b < 1:
        raise ValueError(f"no sequence of the mix {mix['name']} fits beside the weights")
    return b


def cache_rows(caches, rows: range):
    """Views of rows ``rows`` of each layer's cache (a ring stays a ring)."""
    return tuple(dataclasses.replace(c, **{f: getattr(c, f)[rows.start:rows.stop]
                                          for f in c._FIELDS}) for c in caches)


def seed_caches(spec: HybridSpec, caches, seed: int, context: int, std: float, device) -> None:
    """Write the ``context`` prompt positions' seeded keys and values into
    every layer's cache through its ``append``, a block of rows at a time."""
    for rows in decode.row_blocks(caches[0].lengths.shape[0]):
        zeros = torch.zeros((len(rows),), dtype=torch.int32, device=device)
        for layer, cache in enumerate(cache_rows(caches, rows)):
            k, v = inputs.prefix_kv(spec, seed, layer, rows, context, std, device)
            cache.append(k, v, start=zeros)
            del k, v


class RingRestore:
    """The window layers' ring slots that a replay of ``steps`` decode steps
    from ``pos0`` writes, copied when made; :meth:`__call__` puts them back
    (one copy a tensor, or two where the slots wrap round the ring's end)."""

    def __init__(self, caches, pos0: int, steps: int):
        self.parts = []
        for c in caches:
            if not c.ring:
                continue
            r = c.max_seq
            a, n = (pos0 // 2 * 2) % r, min(r, (pos0 % 2 + steps + 1) // 2 * 2)
            for lo, hi in ((a, min(r, a + n)), (0, max(0, a + n - r))):
                if hi > lo:
                    for f in c._FIELDS[:6]:
                        t = getattr(c, f)
                        view = t[:, :, lo // 2:hi // 2] if f.endswith("packed") else t[:, :, lo:hi]
                        self.parts.append((view, view.clone()))

    def nbytes(self) -> int:
        return sum(saved.numel() * saved.element_size() for _, saved in self.parts)

    def __call__(self) -> None:
        for view, saved in self.parts:
            view.copy_(saved)


class Restored:
    """A loop (``decode._Graph`` or ``decode._Eager``) whose every run first
    puts back the ring slots that the previous run overwrote."""

    def __init__(self, loop, restore: RingRestore):
        self.loop, self.restore = loop, restore

    def __call__(self):
        self.restore()
        return self.loop()

    def device_ms(self):
        self.restore()
        return self.loop.device_ms()


class PlainWitness:
    """A control that is no path of the program: the plain reference in
    ``dtype``, teacher forced on the program's fed tokens, its own first
    choices served and its own experts chosen; the driver runs it after the
    program is freed."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def run(self, mod, spec: HybridSpec, seed: int, device, biases, fed: torch.Tensor,
            start: int, prefix, blocks) -> tuple:
        ref = mod.Reference(spec, seed, device, biases, dtype=self.dtype)
        jobs = ref.run([mod.Job(fed[rows.start:rows.stop], start=start, served=None,
                                routes=None, prefix=lambda layer, rows=rows: prefix(layer, rows))
                        for rows in blocks])
        return (torch.cat([j.firsts for j in jobs]),
                torch.cat([j.chosen for j in jobs], dim=1))       # [B, T], [MoE layers, B, T, k]


def reference_biases(mod, spec: HybridSpec, seed: int, device, tok0: torch.Tensor, start: int,
                     prefix, blocks) -> List[torch.Tensor]:
    """Each MoE layer's correction bias, balanced by the plain reference's
    own forward of ``tok0`` at position ``start`` over every sequence."""
    ref = mod.Reference(spec, seed, device)
    ref.run([mod.Job(tok0[rows.start:rows.stop].cpu(), start=start, served=None, routes=None,
                     prefix=lambda layer, rows=rows: prefix(layer, rows)) for rows in blocks])
    return [b.cpu() for b in ref.router_biases]


class Tap:
    """``routes.Tap`` over the MoE layers' routers alone (a dense layer has
    none): each call hands ``sink(layer, logits)`` the router's output."""

    def __init__(self, model, sink):
        self.model, self.sink, self.handles = model, sink, []

    def attach(self) -> "Tap":
        def hook(layer):
            return lambda mod, args, out: self.sink(layer, out)
        self.handles = [blk.moe.router.register_forward_hook(hook(i))
                        for i, blk in enumerate(self.model.blocks)
                        if isinstance(blk.moe, MoEBlock)]
        return self

    def detach(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def router_outputs(kept: decode._Kept, moe_layers: range, steps: int) -> torch.Tensor:
    """[MoE layers, steps, B, E]; raises unless each MoE layer's router was
    called once a step, in order."""
    seen = [layer for layer, _ in kept.outs]
    if seen != list(moe_layers) * steps:
        raise RuntimeError(f"the router hooks saw {len(seen)} calls in a loop of {steps} steps "
                           f"over {len(moe_layers)} MoE layers, not one a layer and step")
    out = torch.stack([o for _, o in kept.outs])
    return out.reshape(steps, len(moe_layers), *out.shape[1:]).transpose(0, 1)


def choices(model, spec: HybridSpec, logits: torch.Tensor) -> torch.Tensor:
    """The program's experts [MoE layers, steps, B, k] from its router
    outputs, by each block's own rule (the biased sigmoid top-k)."""
    return torch.stack([torch.stack([model.blocks[layer].moe.route(logits[i, s]).expert_indices
                                     for s in range(logits.shape[1])])
                        for i, layer in enumerate(spec.moe_layers())])


def held_counts(spec: HybridSpec, chosen: torch.Tensor) -> torch.Tensor:
    """Routed pairs per held expert [..., E_held] of the experts ``chosen``
    [..., rows, k]."""
    lo = spec.first_expert
    flat = chosen.reshape(*chosen.shape[:-2], -1).long()
    counts = torch.zeros((*flat.shape[:-1], spec.router_experts), dtype=torch.long,
                         device=flat.device)
    counts.scatter_add_(-1, flat, torch.ones_like(flat))
    return counts[..., lo:lo + spec.experts]


def step_work(spec: HybridSpec, b: int, position: int, tpe: List[List[int]]) -> Dict[str, Work]:
    """One decode step of ``b`` sequences at ``position``, by family:
    ``int4_matmul`` (attention projections, routers in bf16, shared experts,
    dense layers, lm_head), ``grouped_matmul`` (gate, up and down of the
    held experts the routing hit, ``tpe[i]`` for the i-th MoE layer),
    ``decode_attention`` (full layers up to ``position + 1``, window layers
    over the ``window`` positions a query there sees),
    the subsets ``window_attention``, ``shared_expert``
    and ``dense_mlp``, and ``step``: their sum with the new K/V written and
    the embedding rows read."""
    g, gs, h = spec.granularity, spec.group_size, spec.hidden
    qd, kvd = spec.heads * spec.head_dim, spec.kv_heads * spec.head_dim
    fam = {k: Work() for k in ("int4_matmul", "grouped_matmul", "decode_attention",
                               "window_attention", "shared_expert", "dense_mlp")}

    def swiglu(f):
        return [roofline.linear(b, f, h, g, gs), roofline.linear(b, f, h, g, gs),
                roofline.linear(b, h, f, g, gs)]

    for layer in range(spec.layers):
        for n, k in ((qd, h), (kvd, h), (kvd, h), (h, qd)):
            fam["int4_matmul"] += roofline.linear(b, n, k, g, gs)
        window = spec.windows[layer]
        seen = min(window, position + 1) if window else position + 1
        att = roofline.attention([seen] * b, spec.heads, spec.kv_heads, spec.head_dim)
        fam["decode_attention"] += att
        if window:
            fam["window_attention"] += att
        if layer < spec.dense_layers:
            parts, key = swiglu(spec.dense_ffn), "dense_mlp"
        else:
            e = spec.router_experts
            fam["int4_matmul"] += Work(flops=2.0 * b * e * h,
                                       bytes=e * h * roofline.ACT_BYTES + 4 * e
                                       + roofline.ACT_BYTES * b * (h + e))
            t = tpe[layer - spec.dense_layers]
            for n, k in ((spec.moe_ffn, h), (spec.moe_ffn, h), (h, spec.moe_ffn)):
                fam["grouped_matmul"] += roofline.grouped(t, n, k, g, gs)
            parts, key = swiglu(spec.shared_ffn), "shared_expert"
        for w in parts:
            fam[key] += w
            fam["int4_matmul"] += w
    fam["int4_matmul"] += roofline.linear(b, spec.vocab, h, g, gs)
    step = Work()
    for k in ("int4_matmul", "grouped_matmul", "decode_attention"):
        step += fam[k]
    step += Work(bytes=spec.layers * b * 2 * spec.kv_heads * (spec.head_dim // 2 + 8)
                 + b * h * roofline.ACT_BYTES)
    return {**fam, "step": step}


def _counted(before: dict, after: dict, steps: int) -> dict:
    return {k: (after[k] - before[k]) / steps for k in after}


def run(ctx: harness.Context) -> harness.Outcome:
    mix, dev, seed = ctx.cell.traffic, ctx.device, ctx.seed
    spec = HybridSpec.from_config(ctx.cell.config)
    mcfg = model_config(spec, ctx.cell.config)
    b, ctxlen, steps = batch(spec, mix), mix["context"], mix["steps"]
    max_seq = ctxlen + mix["output_tokens"]
    max_seq += max_seq % 2
    blocks = decode.row_blocks(b)
    mod = importlib.import_module(f"portbench.reference.{ctx.cell.config['reference']}")

    def prefix(layer, rows):
        return inputs.prefix_kv(spec, seed, layer, rows, ctxlen, mix["kv_std"], dev)

    g = inputs.generator(seed, "tok0", device=dev)
    tok0 = torch.randint(1, spec.vocab, (b, 1), generator=g, device=dev, dtype=torch.int32)
    pos0 = torch.full((b, 1), ctxlen, dtype=torch.int32, device=dev)
    biases = reference_biases(mod, spec, seed, dev, tok0, ctxlen, prefix, blocks)
    harness.free(dev)
    model = build(spec, mcfg, seed, dev, biases)
    caches = model.init_cache(mcfg, b, max_seq, max_tokens=1)
    seed_caches(spec, caches, seed, ctxlen, mix["kv_std"], dev)
    restore = RingRestore(caches, ctxlen, steps)

    tap = Tap(model, decode._Kept())
    before = launch_counts()
    loop = Restored((decode._Graph if dev.type == "cuda" else decode._Eager)(
        model, caches, tok0, pos0, steps, tap), restore)

    with card.Sampler() as sampled:
        t0 = time.perf_counter()
        first = loop()
        # the warm loop and the capture ran the loop's Python on the card (a
        # replay runs none); on the CPU the first eager loop did
        counted = _counted(before, launch_counts(), steps * (2 if dev.type == "cuda" else 1))
        replays, differing = 1, 0
        while time.perf_counter() < t0 + ctx.seconds:
            differing += int(not torch.equal(loop(), first))
            replays += 1
        window = time.perf_counter() - t0
    end_to_end = {"decode_tok_s": b * steps * replays / window, "setup_s": t0 - ctx.t_start}

    chosen = choices(model, spec, router_outputs(tap.sink, spec.moe_layers(), steps))
    held = held_counts(spec, chosen)                                   # [MoE layers, steps, E]
    share = float(held.sum()) / chosen.numel()
    print(f"decode_hybrid: batch {b}; held experts get {100 * share:.2f} % of the routed "
          f"pairs ({float(held.float().mean()):.1f} rows an expert a step); a step launched "
          f"{counted['grouped_int4_matmul_per_group_wg']:g} of "
          f"{counted['grouped_int4_matmul_per_group']:g} K13 calls on the warpgroup body, "
          f"{counted['int4_attention_window']:g} of {counted['int4_attention']:g} K3 calls over "
          f"a window; {restore.nbytes() / 1e9:.3f} GB of ring slots put back before each "
          f"replay", file=sys.stderr, flush=True)
    obs = harness.Observations(driver="decode")
    if ctx.trace:
        per_step = [step_work(spec, b, ctxlen + s, held[:, s].tolist()) for s in range(steps)]
        obs.work = {k: Work(sum(w[k].flops for w in per_step) / steps,
                            sum(w[k].bytes for w in per_step) / steps) for k in per_step[0]}
        times = [loop.device_ms() for _ in range(3)]
        if times[0] is not None:
            obs.device_ms_per_step = statistics.median(times) / steps
        reps = mix["traced_replays"]
        obs.trace = trace.record(lambda: [loop() for _ in range(reps)])
        obs.steps_traced = reps * steps
        obs.own_kernels = trace.csrc_kernels(program.csrc())
        by_span = spans.ms_per_step(obs.trace, obs.steps_traced) or {}
        print("decode_hybrid: device ms a step by span (own nodes): " + ", ".join(
            f"{k or 'all'} {v:.3f}" for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])),
            file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tap.detach()
    chosen = chosen.transpose(1, 2).cpu()                              # [MoE layers, B, steps, k]

    served = first[:, :, 0].t()                                        # [B, steps]
    fed = torch.cat([tok0.cpu(), served[:, :-1]], dim=1).long()
    ctrl, witnesses = {}, {n: fn for n, fn in ctx.controls.items() if isinstance(fn, PlainWitness)}
    for name, fn in ctx.controls.items():
        if name not in witnesses:
            seed_caches(spec, caches, seed, ctxlen, mix["kv_std"], dev)
            ctrl[name] = fn(model, caches, fed.to(dev), ctxlen)
    del loop, caches, model, tap, restore
    harness.free(dev)
    for name, fn in witnesses.items():
        ctrl[name] = fn.run(mod, spec, seed, dev, biases, fed, ctxlen, prefix, blocks)
    t_ref = time.perf_counter()

    ref = mod.Reference(spec, seed, dev, biases)
    runs = {"program": (served, chosen), **ctrl}
    jobs = [mod.Job(fed[rows.start:rows.stop], start=ctxlen, served=r[0][rows.start:rows.stop],
                    routes=r[1][:, rows.start:rows.stop],
                    prefix=lambda layer, rows=rows: prefix(layer, rows))
            for r in runs.values() for rows in blocks]
    done = ref.run(jobs)
    judged, by_layer = {}, {}
    for i, name in enumerate(runs):
        part = done[i * len(blocks):(i + 1) * len(blocks)]
        gaps = torch.cat([j.gaps for j in part])                       # [B, steps]
        per_layer = [torch.cat([j.route_gaps[m] for j in part])
                     for m in range(len(part[0].route_gaps))]
        route_gaps = torch.cat(per_layer)
        early = float(torch.cat(per_layer[:EARLY_MOE_LAYERS]).mean())
        judged[name] = {**correct.compared(gaps, float(route_gaps.mean())),
                        "early_route_gap": early, "gaps": gaps}
        by_layer[name] = [float(g.mean()) for g in per_layer]
    prog = judged.pop("program")
    gaps = prog.pop("gaps")
    out = harness.Outcome(end_to_end=end_to_end, obs=obs, attempted=b * steps * replays,
                          failed=0, checks={**prog, "replays_differing": differing},
                          memory_peak_bytes=peak, gaps=gaps, controls=judged,
                          card=sampled.result, reference_s=time.perf_counter() - t_ref)
    out.route_gaps_by_layer = by_layer       # for the calibration's record
    return out
