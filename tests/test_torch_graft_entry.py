"""Port vs JAX package: the graft entry points (``fused4bit_tpu_torch.graft_entry``
against the repository root's ``__graft_entry__.py``).

``entry()``'s decode step on the JAX model's bytes (carried with
``model_from_jax``) against JAX's own ``entry()`` fn three ways: eager
(``jax.disable_jit``), jitted with XLA's default flags, and jitted with
``xla_allow_excess_precision`` off. ``dryrun_multichip`` runs on 2 and 4
gloo ranks of the CPU, both spawned once for the module; at 2 ranks the
gathered outputs of parts 1, 4, 6 and 9 are held to the JAX functions on
the same numpy inputs, on a mesh cut from the 8 virtual CPU devices, with
the kernels in interpret mode. Tolerances: JAX's bars (1e-2 for EP, 1e-3
for SP).
"""
import ast
import concurrent.futures
import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from fused4bit_tpu.parallel import expert_parallel as jep
from fused4bit_tpu.parallel import sequence as jseq
from fused4bit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fused4bit_tpu.parallel.sharding import shard_qt_experts
from fused4bit_tpu.quant import quantize as jax_quantize
from fused4bit_tpu_torch import graft_entry
from fused4bit_tpu_torch.graft_entry import decode_step, dryrun_multichip, entry
from fused4bit_tpu_torch.models import flagship_model_config, model_from_jax

# the JAX model's logits span about +-3.6; a bf16 step there is 0.0156
EXACT_REL_TOL = 1e-2   # eager and jit_exact: measured max|d| 0, bit for bit
MODEL_REL_TOL = 2e-2   # jitted with XLA's default flags: the port's model bar


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def dryruns():
    """dryrun_multichip at 2 and 4 gloo ranks, started with the module; the
    JAX side runs meanwhile."""
    pool = concurrent.futures.ThreadPoolExecutor(2)
    runs = {n: pool.submit(dryrun_multichip, n, device="cpu") for n in (2, 4)}
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_entry():
    return jax_graft.entry()


def test_entry_has_jax_shapes_and_dtypes(jax_entry):
    jfn, (jtokens, jcaches, jpositions) = jax_entry
    fn, (tokens, caches, positions) = entry(device="cpu")
    for got, want in ((tokens, jtokens), (positions, jpositions)):
        assert tuple(got.shape) == want.shape == (2, 1)
        assert got.dtype == torch.int32 and want.dtype == jnp.int32
        assert not got.any()
    assert len(caches) == len(jcaches) == flagship_model_config("tiny").num_layers
    for c, jc in zip(caches, jcaches):
        for f in c._FIELDS:
            g, w = getattr(c, f), getattr(jc, f)
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[1] == w.dtype.name, f
    logits = fn(tokens, caches, positions)
    assert logits.shape == (2, 1, flagship_model_config("tiny").vocab_size)
    assert torch.isfinite(logits.float()).all()
    # the caches update in place at the step's positions: a second call repeats it
    assert torch.equal(fn(tokens, caches, positions), logits)


def _jit_exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.mark.parametrize("how", ["eager", "jit_default", "jit_exact"])
def test_decode_step_matches_jax_entry(jax_entry, how):
    """The port's step on JAX's bytes: eager and jit_exact within
    EXACT_REL_TOL of the max (bit for bit when measured); XLA's default
    keeps bf16 intermediates in f32 and parts by 0.0625 (0.0173 of the
    max), within the model bar."""
    jfn, jargs = jax_entry
    cfg = flagship_model_config("tiny")
    jmodel = inspect.getclosurevars(jfn).nonlocals["model"]
    leaves, _ = jax.tree_util.tree_flatten_with_path(jmodel)
    model = model_from_jax({jax.tree_util.keystr(p): np.asarray(a) for p, a in leaves}, cfg,
                           device="cpu")
    _, (tokens, _, positions) = entry(device="cpu")
    got = decode_step(model, tokens, model.init_cache(cfg, 2, 32), positions).float().numpy()
    if how == "eager":
        with jax.disable_jit():
            want = jfn(*jargs)
    elif how == "jit_default":
        want = jax.jit(jfn)(*jargs)
    else:
        want = _jit_exact(jfn, *jargs)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape == (2, 1, cfg.vocab_size)
    tol = (MODEL_REL_TOL if how == "jit_default" else EXACT_REL_TOL) * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    if how != "jit_default":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_entry_points_default_to_the_card(call):
    """With no device they run on CUDA; without a card they raise and name
    device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default runs there")
    fn = {"entry": entry, "dryrun_multichip": lambda: dryrun_multichip(1)}[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()


def test_dryrun_rejects_a_world_that_does_not_split_the_tokens():
    with pytest.raises(ValueError, match="must divide 16"):
        dryrun_multichip(3, device="cpu")


PARTS = {1: 2, 2: 1, 3: 2, 4: 1, 5: 1, 6: 1, 7: 1, 8: 1, 9: 2}   # checks per part


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_passes_every_part_on_gloo_ranks(dryruns, n):
    reports = dryruns[n].result(timeout=600)
    assert [r["rank"] for r in reports] == list(range(n))
    for rep in reports:
        assert rep["world"] == n and rep["backend"] == "gloo" and rep["device"] == "cpu"
        parts = [c["part"] for c in rep["checks"]]
        assert {p: parts.count(p) for p in PARTS} == PARTS
        for c in rep["checks"]:
            if c["part"] in (5, 7):   # the engines: every request, its budget
                assert c["max_abs_diff"] is None and c["requests"] == (3 if c["part"] == 5 else 2)
            elif c["bar"] is None:    # the sharded step against the forward, bit for bit
                assert c["max_abs_diff"] == 0.0
            else:
                assert c["max_abs_diff"] < c["bar"] <= 5e-2
        assert len(rep["seconds"]) == 9
        # CPU tensors run the plain versions: no kernel launches
        assert not any(rep["launches"].values()) and rep["plain_calls"] > 0
        assert rep["tokens"] == reports[0]["tokens"]
        for name, out in rep["outputs"].items():
            assert torch.equal(out, reports[0]["outputs"][name])


def _jax_inputs(n=2):
    """The dryrun's numpy inputs, drawn in JAX's order."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n, 128, 128)).astype(np.float32)
    x = rng.standard_normal((16, 128)).astype(np.float32)
    logits = rng.standard_normal((16, n)).astype(np.float32)
    rng.standard_normal((128 * n // 2, 128))   # part 2's weight
    qkv = [rng.standard_normal(s).astype(np.float32)
           for s in ((2, 4, 8 * n, 16), (2, 2, 8 * n, 16), (2, 2, 8 * n, 16))]
    return w, x, logits, qkv


def _jax_output(name):
    w, x, logits, (q, k, v) = _jax_inputs()
    devs = jax.devices()[:2]
    if name.startswith("ep_"):
        mesh = jax_make_mesh(("expert",), (2,), devices=devs)
        qt = shard_qt_experts(jax_quantize(jnp.asarray(w), layout="planar"), mesh, "expert")
        fn, kw = {"ep_replicated": (jep.moe_ep_replicated, {}),
                  "ep_a2a": (jep.moe_ep_a2a, {"capacity_factor": 8.0}),
                  "ep_dropless": (jep.moe_ep_a2a_dropless, {}),
                  "ep_ring": (jep.moe_ep_ring, {})}[name]
        run = jax.jit(functools.partial(fn, mesh=mesh, top_k=2, tile_m=8, interpret=True, **kw))
        return np.asarray(run(jnp.asarray(x), jnp.asarray(logits), qt))
    mesh = jax_make_mesh(("seq",), (2,), devices=devs)
    if name == "sp_ulysses":
        q, k, v = (a[:, :, :a.shape[2] // 4] for a in (q, k, v))
    fn = {"sp_ring": jseq.ring_attention, "sp_ulysses": jseq.ulysses_attention}[name]
    return np.asarray(jax.jit(functools.partial(fn, mesh=mesh))(q, k, v))


@pytest.mark.parametrize("name", ["ep_replicated", "ep_a2a", "ep_dropless", "ep_ring",
                                  "sp_ring", "sp_ulysses"])
def test_dryrun_outputs_match_jax(dryruns, name):
    """Parts 1, 4, 6 and 9 at 2 ranks: the gathered outputs against the JAX
    functions on the same inputs, at JAX's bars."""
    want = _jax_output(name)
    got = dryruns[2].result(timeout=600)[0]["outputs"][name].numpy()
    assert got.shape == want.shape
    bar = graft_entry.EP_BAR if name.startswith("ep_") else graft_entry.SP_BAR
    assert np.abs(got - want).max() < bar


def test_graft_entry_imports_no_jax():
    path = os.path.join(os.path.dirname(graft_entry.__file__), "graft_entry.py")
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "fused4bit_tpu", "flax")]
