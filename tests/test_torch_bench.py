"""Port vs JAX package: the decode benchmark (``fused4bit_tpu_torch.bench``
against the repository root's ``bench.py``).

``decode_loop`` on the JAX `tiny` model's bytes (carried with
``model_from_jax`` in each execution mode; the dense twins built by the
port's ``dense_from_quantized`` from the carried model) against
``bench.py``'s ``lax.scan`` body, rebuilt here as ``bench.py:62-71`` writes
it, run eagerly (``jax.disable_jit``) and jitted with
``xla_allow_excess_precision`` off: the greedy tokens must be equal. Batch
2, 4 steps, caches of 32. ``bench.py`` is read with ``ast``, never imported
(it sets a JAX compile cache and JAX config).
"""
import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.dense_baseline import dense_from_quantized as jax_dense_from_quantized
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu.models.transformer import as_u4_turbo as jax_as_u4_turbo
from fused4bit_tpu.models.transformer import as_xla_turbo as jax_as_xla_turbo
from fused4bit_tpu_torch import bench
from fused4bit_tpu_torch.bench import CapturedLoop, decode_loop, run
from fused4bit_tpu_torch.models import dense_from_quantized, model_from_jax

BENCH_PY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
B, STEPS, MAX_SEQ = 2, 4, 32
MODELS = ("kernel", "u4_turbo", "xla_turbo", "dense_all", "gather")
_JAX_MODES = {"kernel": lambda m: m, "u4_turbo": jax_as_u4_turbo, "xla_turbo": jax_as_xla_turbo}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


@pytest.fixture(scope="module")
def tiny():
    cfg = flagship_model_config("tiny")
    return cfg, JaxTransformer.init(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def models(tiny):
    """(JAX model, the port's model on the same bytes) for each of MODELS,
    built once for the module's tests."""
    cfg, jmodel = tiny
    port = model_from_jax(_params(jmodel), cfg, device="cpu")
    out = {}
    for name in MODELS:
        if name in _JAX_MODES:
            jm = _JAX_MODES[name](jmodel)
            out[name] = jm, model_from_jax(_params(jm), cfg, device="cpu", mode=name)
        else:
            impl = "gather" if name == "gather" else "dense_all"
            out[name] = (jax_dense_from_quantized(jmodel, moe_impl=impl),
                         dense_from_quantized(port, moe_impl=impl))
    return out


def _jax_loop(m, caches, tok0, pos0, steps):
    """``bench.py:62-71``: the scan body, greedy tokens [steps, B, 1]."""
    def body(carry, _):
        tok, caches, pos = carry
        logits, caches = m(tok, caches, pos)
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        return (nxt, caches, pos + 1), nxt

    _, toks = jax.lax.scan(body, (tok0, caches, pos0), None, length=steps)
    return toks


def _jit_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("how", ["eager", "jit_exact"])
@pytest.mark.parametrize("name", MODELS)
def test_decode_loop_matches_jax_scan(tiny, models, name, how):
    cfg, _ = tiny
    jm, model = models[name]
    tok0 = np.full((B, 1), 3, np.int32)
    pos0 = np.zeros((B, 1), np.int32)
    args = (jm, jm.init_cache(cfg, B, MAX_SEQ), jnp.asarray(tok0), jnp.asarray(pos0))
    fn = functools.partial(_jax_loop, steps=STEPS)
    if how == "eager":
        with jax.disable_jit():
            want = np.asarray(fn(*args))
    else:
        want = np.asarray(_jit_exact(fn, *args))
    got = decode_loop(model, model.init_cache(cfg, B, MAX_SEQ), torch.from_numpy(tok0),
                      torch.from_numpy(pos0), STEPS)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (STEPS, B, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _cache_tensors(caches):
    return [getattr(c, f) for c in caches for f in getattr(c, "_FIELDS", ("k", "v", "lengths"))]


@pytest.mark.parametrize("name", MODELS)
def test_decode_loop_from_position_0_repeats(tiny, models, name):
    """The caches update in place; every step writes its own positions and
    the lengths follow from them, so a second loop from position 0 gives the
    first one's tokens and leaves the same cache bytes."""
    cfg, _ = tiny
    _, model = models[name]
    caches = model.init_cache(cfg, B, MAX_SEQ)
    tok0 = torch.full((B, 1), 5, dtype=torch.int32)
    pos0 = torch.zeros((B, 1), dtype=torch.int32)
    first = decode_loop(model, caches, tok0, pos0, STEPS)
    after_first = [t.clone() for t in _cache_tensors(caches)]
    assert int(caches[0].lengths[0]) == STEPS
    second = decode_loop(model, caches, tok0, pos0, STEPS)
    assert torch.equal(first, second)
    for a, b in zip(after_first, _cache_tensors(caches)):
        assert torch.equal(a, b)


def _bench_py_keys():
    """The keys of the JSON dict ``bench.py`` prints (nested keys of
    ``small_scale`` as ``small_scale.<key>``) and its metric string."""
    tree = ast.parse(open(BENCH_PY).read())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    assert len(dumps) == 1
    out, metric = set(), None
    for k, v in zip(dumps[0].args[0].keys, dumps[0].args[0].values):
        out.add(k.value)
        if isinstance(v, ast.Dict):
            out |= {f"{k.value}.{kk.value}" for kk in v.keys}
        if k.value == "metric":
            metric = v.value
    return out, metric


def test_run_on_the_cpu_has_bench_py_keys():
    got = run(device="cpu", scale="tiny", small_scale="tiny", batch=2, steps=2, repeats=1)
    keys, metric = _bench_py_keys()
    flat = set(got) | {f"small_scale.{k}" for k in got["small_scale"]}
    assert flat == keys | {"device"}
    assert got["metric"] == metric == bench.METRIC
    assert got["backend"] == "cpu" and got["unit"] == "ms"
    for k in ("value", "int4_kernel_ms", "int4_u4_turbo_ms", "int4_xla_turbo_ms",
              "bf16_strong_ms", "vs_baseline", "vs_strong_dense"):
        assert got[k] > 0, k
    assert all(v > 0 for v in got["small_scale"].values())
    assert got["value"] == min(got["int4_kernel_ms"], got["int4_u4_turbo_ms"],
                               got["int4_xla_turbo_ms"])
    for k in ("int4_kernel_device_ms", "int4_u4_turbo_device_ms", "bf16_strong_device_ms",
              "vs_strong_dense_device"):
        assert got[k] is None, k


@pytest.mark.parametrize("call", ["run", "CapturedLoop"])
def test_no_cpu_fallback(tiny, models, call):
    """With no device run() builds on the card and raises without one;
    CapturedLoop refuses a model on the CPU. Both name device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default runs there")
    cfg, _ = tiny
    _, model = models["kernel"]
    fn = {"run": run,
          "CapturedLoop": lambda: CapturedLoop(model, model.init_cache(cfg, B, MAX_SEQ), B)}[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


def test_bench_imports_no_jax():
    names = []
    for node in ast.walk(ast.parse(open(bench.__file__).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "fused4bit_tpu", "flax", "bench")]
