"""Port vs JAX package: checkpoints (``utils.checkpoint``) and the elastic
step loop (``utils.elastic``).

Round trips are exact (the same bytes back, the same logits bit for bit);
a port model carried from JAX and reloaded by the port is held to JAX's
model restored by JAX's own ``checkpoint.load`` at the tiny model's
tolerance (2e-2 * max|logits|, ``tests/test_torch_model.py``). The elastic
loop's trajectories, resume steps and directory listings equal JAX's
``elastic_loop`` on the same step functions exactly."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu.utils import checkpoint as jax_checkpoint
from fused4bit_tpu.utils import elastic as jax_elastic
from fused4bit_tpu_torch.layers import PagedKVCache, QuantizedKVCache
from fused4bit_tpu_torch.models import (
    QuantizedTransformer,
    as_per_group,
    as_xla_turbo,
    model_from_jax,
)
from fused4bit_tpu_torch.quant import quantize
from fused4bit_tpu_torch.utils import checkpoint, elastic_loop, latest_step
from fused4bit_tpu_torch.utils import elastic as port_elastic


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.array(leaf) for path, leaf in leaves}


def _logits(model, cfg, tokens):
    out, _ = model(torch.from_numpy(tokens), model.init_cache(cfg, tokens.shape[0], 16),
                   torch.arange(tokens.shape[1]))
    return out.float()


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


# --- checkpoints ---------------------------------------------------------------


def test_quantized_tensor_roundtrip(rng, tmp_path):
    w = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32))
    for kw in (dict(), dict(granularity="per_group", group_size=16, layout="planar_groups")):
        qt = quantize(w, **kw)
        path = str(tmp_path / f"qt_{len(kw)}")
        checkpoint.save(path, qt)
        template = quantize(torch.zeros_like(w) + 1.0, **kw)
        qt2 = checkpoint.load(path, template)
        for f in ("packed", "scales", "zero_points"):
            assert torch.equal(getattr(qt2, f), getattr(qt, f))
        assert (qt2.shape, qt2.layout, qt2.group_size) == (qt.shape, qt.layout, qt.group_size)
        assert not torch.equal(template.packed, qt.packed)   # the template is untouched


@pytest.mark.parametrize("mode", ["per_row", "per_group", "xla_turbo"])
def test_tiny_model_roundtrip(tmp_path, mode):
    cfg = flagship_model_config("tiny")
    convert = {"per_row": lambda m: m, "per_group": as_per_group, "xla_turbo": as_xla_turbo}[mode]

    def build(seed):
        return convert(QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(seed),
                                                 device="cpu"))

    model = build(0)
    path = str(tmp_path / mode)
    checkpoint.save(path, model)
    assert not os.path.exists(path + ".tmp") and os.listdir(tmp_path) == [mode]
    template = build(1)
    loaded = checkpoint.load(path, template)
    assert loaded is template   # a module loads in place
    want, got = model.state_dict(), loaded.state_dict()
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 5))
    assert torch.equal(_logits(loaded, cfg, tokens), _logits(model, cfg, tokens))
    with pytest.raises(FileExistsError):
        checkpoint.save(path, model)


def test_kv_caches_roundtrip(rng, tmp_path):
    """Contiguous and paged caches inside a dict, with a Python scalar and a
    tensor beside them; new tensors come back, the template stays."""
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 3, 8)).astype(np.float32))
            for _ in range(2))
    cache = QuantizedKVCache.init(2, 2, 16, 8, device="cpu").append(k, v)
    paged = PagedKVCache.init(2, 2, 8, num_pages=4, page_size=8, max_pages_per_slot=2,
                              device="cpu").assign_pages(0, [2]).assign_pages(1, [3])
    paged.append(k, v)
    state = {"caches": (cache, paged), "step": 7, "tokens": torch.arange(4)}
    checkpoint.save(str(tmp_path / "kv"), state)
    template = {"caches": (QuantizedKVCache.init(2, 2, 16, 8, device="cpu"),
                           PagedKVCache.init(2, 2, 8, num_pages=4, page_size=8,
                                             max_pages_per_slot=2, device="cpu")),
                "step": 0, "tokens": torch.zeros(4, dtype=torch.int64)}
    got = checkpoint.load(str(tmp_path / "kv"), template)
    assert got["step"] == 7 and torch.equal(got["tokens"], torch.arange(4))
    for a, b, t in zip(got["caches"], state["caches"], template["caches"]):
        assert type(a) is type(b)
        for f in type(b)._FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f))
        assert getattr(a, type(b)._FIELDS[0]) is not getattr(t, type(b)._FIELDS[0])
        assert not t.lengths.any()


def test_mode_mismatch_raises_and_loads_nothing(tmp_path):
    cfg = flagship_model_config("tiny")

    def build(seed):
        return QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(seed),
                                         device="cpu")

    base = build(0)
    checkpoint.save(str(tmp_path / "xla"), as_xla_turbo(base))
    checkpoint.save(str(tmp_path / "pg"), as_per_group(base))
    for name in ("xla", "pg"):
        template = build(1)
        before = _state(template)
        with pytest.raises(ValueError, match="differs from the template"):
            checkpoint.load(str(tmp_path / name), template)
        after = template.state_dict()
        assert all(torch.equal(before[k], after[k]) for k in before)
    # the same mode, one i8 copy short in the template: the tensors decide
    template = as_xla_turbo(build(1))
    template.lm_head.w8_q8 = template.lm_head.w8_scales = None
    with pytest.raises(ValueError, match="only in the checkpoint"):
        checkpoint.load(str(tmp_path / "xla"), template)


def test_model_from_jax_reloaded_gives_jax_restored_logits(tmp_path):
    """JAX saves and restores its model with Orbax; the port carries the same
    model across (``model_from_jax``), saves and reloads it into a template
    carried from another JAX model: the port's logits, bit for bit those of
    the model before the save, stand within the tiny model's tolerance of
    the restored JAX model's."""
    cfg = flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    jtemplate = JaxTransformer.init(jax.random.PRNGKey(1), cfg)
    jax_checkpoint.save(str(tmp_path / "jax"), jmodel)
    jrestored = jax_checkpoint.load(str(tmp_path / "jax"), jtemplate)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 3), dtype=np.int32)
    jl, _ = jrestored(jnp.asarray(tokens), jrestored.init_cache(cfg, 1, 16),
                      jnp.arange(3, dtype=jnp.int32))
    ref = np.asarray(jl.astype(jnp.float32))

    model = model_from_jax(_params(jmodel), cfg, device="cpu")
    checkpoint.save(str(tmp_path / "port"), model)
    template = model_from_jax(_params(jtemplate), cfg, device="cpu")
    loaded = checkpoint.load(str(tmp_path / "port"), template)
    got = _logits(loaded, cfg, tokens)
    assert torch.equal(got, _logits(model, cfg, tokens))
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-2 * np.max(np.abs(ref))
    assert (got.numpy()[0, -1].argmax() in np.argsort(ref[0, -1])[-2:])


# --- the elastic loop ------------------------------------------------------------


class Boom(RuntimeError):
    pass


def _jax_step(state, i):
    return {"w": state["w"] + jnp.float32(i + 1), "n": state["n"] + 1}


def _port_step(state, i):
    return {"w": state["w"] + float(i + 1), "n": state["n"] + 1}


def _port_step_in_place(state, i):
    state["w"].add_(float(i + 1))
    state["n"].add_(1)
    return state


def _faulty(step, fault, *, once):
    """``step`` raising Boom at step ``fault`` (the first time only with ``once``)."""
    seen = []

    def f(state, i):
        if i == fault and not (once and seen):
            seen.append(i)
            raise Boom(f"fault at step {i}")
        return step(state, i)

    return f


def _run(loop, step, init, ckdir, trace, **kw):
    """Run ``loop``; the trajectory is every (steps done, w) that ``on_step`` saw."""
    def on_step(i, state):
        trace.append((i, np.array(state["w"]).tolist()))

    return loop(step, init, ckpt_dir=ckdir, on_step=on_step, **kw)


def _listing(ckdir):
    return sorted(d for d in os.listdir(ckdir) if d.startswith("step_"))


# (fault step or None, once, num_steps, save_every, keep, max_retries) -> then a relaunch
SCENARIOS = {
    "uninterrupted": (None, True, 7, 3, 2, 3),
    "crash_and_resume": (5, False, 8, 2, 2, 0),
    "transient_retry": (5, True, 8, 2, 2, 2),
    "transient_before_first_save": (1, True, 6, 3, 2, 2),
    "prune": (None, True, 10, 2, 2, 3),
}


def _jax_init():
    return {"w": jnp.zeros((4,), jnp.float32), "n": jnp.int32(0)}


def _port_init():
    return {"w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)}


def _both(tmp_path, name, port_step):
    fault, once, num_steps, save_every, keep, retries = SCENARIOS[name]
    kw = dict(num_steps=num_steps, save_every=save_every, keep=keep, max_retries=retries)
    results = []
    for side, loop, step, init in (("jax", jax_elastic.elastic_loop, _jax_step, _jax_init),
                                   ("port", elastic_loop, port_step, _port_init)):
        ckdir = str(tmp_path / side)
        trace, out = [], {}
        first = step if fault is None else _faulty(step, fault, once=once)
        try:
            state, out["resumed"] = _run(loop, first, init(), ckdir, trace, **kw)
        except Boom:
            # the crash: relaunch with the same command line (a healthy step)
            out["latest_after_crash"] = latest_step(ckdir)
            state, out["resumed"] = _run(loop, step, init(), ckdir, trace, **kw)
        out.update(trace=trace, latest=latest_step(ckdir), listing=_listing(ckdir),
                   w=np.array(state["w"]).tolist(), n=int(state["n"]))
        results.append(out)
    return results


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_elastic_loop_matches_jax(tmp_path, name):
    jax_out, port_out = _both(tmp_path, name, _port_step)
    assert port_out == jax_out
    # and the trajectory of a plain loop
    w = np.zeros(4, np.float32)
    for i in range(SCENARIOS[name][2]):
        w = w + np.float32(i + 1)
    assert port_out["w"] == w.tolist() and port_out["n"] == SCENARIOS[name][2]


@pytest.mark.parametrize("name", ["transient_before_first_save", "transient_retry",
                                  "crash_and_resume"])
def test_state_mutating_step_keeps_jax_trajectory(tmp_path, name):
    """A step that updates its state in place (as the port's KV caches are
    updated): the rollback to the start, or to a checkpoint, still gives
    JAX's trajectory with its immutable arrays."""
    jax_out, port_out = _both(tmp_path, name, _port_step_in_place)
    assert port_out == jax_out


def test_kv_cache_appending_step_resumes_to_the_uninterrupted_cache(rng, tmp_path):
    """The trouble spot itself: each step appends to a KV cache in place; a
    fault before the first save and a crash after it give the cache of an
    uninterrupted run, byte for byte."""
    kv = torch.from_numpy(rng.standard_normal((8, 2, 2, 1, 8)).astype(np.float32))

    def init():
        c = QuantizedKVCache.init(2, 2, 16, 8, device="cpu")
        return {"cache": c.append(kv[0], kv[0] * 0.5)}

    def step(state, i):
        state["cache"].append(kv[i], kv[i] * 0.5)
        return state

    want = init()
    for i in range(8):
        want = step(want, i)
    for fault, once, retries in ((1, True, 2), (5, False, 0)):
        ckdir = str(tmp_path / f"ck{fault}")
        try:
            got, resumed = elastic_loop(_faulty(step, fault, once=once), init(), ckpt_dir=ckdir,
                                        num_steps=8, save_every=3, max_retries=retries)
        except Boom:
            got, resumed = elastic_loop(step, init(), ckpt_dir=ckdir, num_steps=8,
                                        save_every=3, max_retries=retries)
            assert resumed == 3
        for f in QuantizedKVCache._FIELDS:
            assert torch.equal(getattr(got["cache"], f), getattr(want["cache"], f)), f


@pytest.mark.parametrize("rank", [0, 1])
def test_world_size_two_disables_retry(tmp_path, monkeypatch, rank):
    """The fault a single process retries re-raises at a torch.distributed
    world size of 2 (JAX's rule at process_count 2, whose Orbax cannot run
    under a faked process count here); only rank 0 writes checkpoints."""
    state, _ = elastic_loop(_faulty(_port_step, 5, once=True), _port_init(),
                            ckpt_dir=str(tmp_path / "single"), num_steps=8, save_every=2,
                            max_retries=3)
    assert int(state["n"]) == 8
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    assert port_elastic._world() == (2, rank)
    ckdir = str(tmp_path / "port")
    with pytest.raises(Boom):
        elastic_loop(_faulty(_port_step, 5, once=True), _port_init(), ckpt_dir=ckdir,
                     num_steps=8, save_every=2, max_retries=3)
    assert latest_step(ckdir) == (4 if rank == 0 else None)
    assert _listing(ckdir) == (["step_2", "step_4"] if rank == 0 else [])
