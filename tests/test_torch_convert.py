"""Port vs JAX package: checkpoint IO and dense -> INT4 conversion.

The port's safetensors reader and writer against the JAX package's, its
``quantize_dense_2d`` and ``convert_checkpoint`` / ``convert_safetensors``
against JAX's (every leaf byte for byte: per row, per group of 64 and 128,
on a random dense dict and on the trained h128 fixture), ``model_from_jax``
on JAX's converted models, the converted models' logits against JAX's, and
the trained h256 fixture's quality gates (``tests/test_convert.py``)
through the port on the CPU.

Tolerances: leaves are compared exactly. Logits: the bf16 ladder of the
other model tests, max|d| <= 2e-2 * max|logits| and the port's next token in
JAX's top-2 (``test_torch_model._prefill_and_decode_match``). The quality
gates are the JAX package's own, unchanged.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

from fused4bit_tpu.models.config import ModelConfig as JaxModelConfig
from fused4bit_tpu.models.config import MoEConfig as JaxMoEConfig
from fused4bit_tpu.models.convert import convert_checkpoint as jax_convert_checkpoint
from fused4bit_tpu.models.convert import convert_safetensors as jax_convert_safetensors
from fused4bit_tpu.models.convert import quantize_dense_2d as jax_quantize_dense_2d
from fused4bit_tpu.models.safetensors_io import load_safetensors as jax_load
from fused4bit_tpu.models.safetensors_io import save_safetensors as jax_save
from fused4bit_tpu_torch.layers import DenseLinear, QuantizedLinear
from fused4bit_tpu_torch.models import (
    checkpoint_shapes,
    convert_checkpoint,
    convert_safetensors,
    dense_from_params,
    load_safetensors,
    model_from_jax,
    quantize_dense_2d,
    save_safetensors,
    transformer,
)
from chip_smoke import (
    QUALITY_POLICIES,
    evaluate,
    fixture_config,
    heldout_tokens,
    policy_kwargs,
    policy_metrics,
    quality_gates,
)
from test_torch_model import _params, _prefill_and_decode_match

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
H128 = os.path.join(FIXTURES, "tiny_trained.safetensors")
H256 = os.path.join(FIXTURES, "tiny_trained_h256_s1400.safetensors")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(path):
    """The fixture's geometry as each package's ModelConfig (the JAX
    quality evaluation's, ``benchmark/run_quality_eval.py``)."""
    cfg = fixture_config(path)
    moe = cfg.moe
    return JaxModelConfig(
        name=cfg.name, moe=JaxMoEConfig(moe.name, moe.num_experts, moe.hidden_dim, moe.ffn_dim,
                                        moe.top_k),
        num_layers=cfg.num_layers, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, vocab_size=cfg.vocab_size, max_seq_len=cfg.max_seq_len), cfg


def _random_checkpoint(cfg, seed=0):
    """A dense f32 checkpoint in the converter's key schema, numpy: N(0, 1/K)
    weights, norms near one, and a constant row (the scale guard)."""
    rng = np.random.default_rng(seed)
    p = {}
    for key, shape in checkpoint_shapes(cfg).items():
        if key.endswith("norm.weight"):
            p[key] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            p[key] = (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(np.float32)
    p["layers.0.attn.q_proj.weight"][3] = 0.25
    return p


def _assert_same_module(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


# --- safetensors ----------------------------------------------------------------

DTYPES = ["float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_safetensors_round_trip_matches_jax(rng, tmp_path, dtype):
    """The port writes the JAX package's bytes and reads them back exactly."""
    tensors = {"w": (rng.standard_normal((6, 10)) * 50).astype(dtype),
               "s": (rng.standard_normal((7,)) * 50).astype(dtype)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_safetensors(ours, tensors, metadata={"format": "np"})
    jax_save(theirs, tensors, metadata={"format": "np"})
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        raw = f.read()
        assert raw == g.read()
    (hlen,) = struct.unpack("<Q", raw[:8])
    assert hlen % 8 == 0                                  # header padded to 8 bytes
    back = load_safetensors(ours)
    assert back.keys() == tensors.keys()
    for key, a in tensors.items():
        assert back[key].dtype == a.dtype
        np.testing.assert_array_equal(back[key], a)


def test_safetensors_bf16_upcast(tmp_path):
    """BF16 tensors read as f32 (the bits shifted up), or as raw u16 with
    ``upcast_bf16=False``, as the JAX reader does."""
    vals = np.asarray([[1.5, -2.25, 3.0, 0.0078125, -0.0, 65280.0]], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype(np.uint16)
    header = json.dumps({"x": {"dtype": "BF16", "shape": [1, 6],
                               "data_offsets": [0, raw.nbytes]}}).encode()
    path = str(tmp_path / "bf.safetensors")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + raw.tobytes())
    got = load_safetensors(path)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(got, jax_load(path)["x"])
    np.testing.assert_array_equal(load_safetensors(path, upcast_bf16=False)["x"], raw)
    with pytest.raises(ValueError, match="unsupported dtype"):
        save_safetensors(str(tmp_path / "c.safetensors"), {"c": np.zeros(2, np.complex64)})


def test_safetensors_reads_the_h256_fixture_as_jax_does():
    got, want = load_safetensors(H256), jax_load(H256)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# --- quantize_dense_2d ------------------------------------------------------------


def test_quantize_dense_2d_bytes_equal_jax(rng):
    """The port's per-row quantizer against the JAX converter's native
    packer: codes, scales and zero points equal, a constant row included."""
    w = rng.standard_normal((64, 256)).astype(np.float32)
    w[5] = -1.75                                           # constant row
    w[9, :128] = 0.0
    ref = jax_quantize_dense_2d(w)
    qt = quantize_dense_2d(w, device="cpu")
    for field in ("packed", "scales", "zero_points"):
        np.testing.assert_array_equal(getattr(qt, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert (qt.shape, qt.granularity, qt.layout) == (tuple(ref.shape), "per_row", "planar")


# --- convert_checkpoint -------------------------------------------------------------

POLICIES = {
    "per_row": {},
    "per_row_all_quantized": dict(quantize_router=True, quantize_lm_head=False),
    "per_group64": dict(granularity="per_group", group_size=64),
    "per_group128": dict(granularity="per_group", group_size=128),
}


def _jax_mode(kw):
    return "per_group" if kw.get("granularity") == "per_group" else "kernel"


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_convert_checkpoint_matches_jax(policy):
    """Every leaf of the port's conversion equals JAX's byte for byte:
    ``model_from_jax`` on JAX's converted model gives the same module
    (buffers, types and dtypes) as the port's own conversion."""
    jcfg, cfg = _configs(H256)
    params = _random_checkpoint(cfg)
    kw = POLICIES[policy]
    model = convert_checkpoint(params, cfg, device="cpu", **kw)
    jmodel = jax_convert_checkpoint(params, jcfg, **kw)
    _assert_same_module(model, model_from_jax(_params(jmodel), cfg, mode=_jax_mode(kw),
                                              device="cpu"))
    blk = model.blocks[0]
    router = QuantizedLinear if kw.get("quantize_router") else DenseLinear
    head = DenseLinear if kw.get("quantize_lm_head") is False else QuantizedLinear
    assert isinstance(blk.moe.router, router) and isinstance(model.lm_head, head)
    if kw.get("granularity") == "per_group":
        assert (blk.attn.wq.layout, blk.moe.w_down.layout, blk.moe.w_down.group_size) == (
            "planar", "planar", kw["group_size"])
    assert model.embed.dtype == blk.attn_norm.dtype == torch.bfloat16


@pytest.mark.parametrize("policy", ["per_row", "per_group64"])
def test_convert_safetensors_h128_fixture_matches_jax(policy):
    jcfg, cfg = _configs(H128)
    kw = POLICIES[policy]
    model = convert_safetensors(H128, cfg, device="cpu", **kw)
    jmodel = jax_convert_safetensors(H128, jcfg, **kw)
    _assert_same_module(model, model_from_jax(_params(jmodel), cfg, mode=_jax_mode(kw),
                                              device="cpu"))


@pytest.mark.parametrize("policy", ["per_row", "per_group128"])
def test_converted_model_logits_match_jax(policy):
    """The port's own conversion against JAX's converted model: a 5-token
    prefill and three decode steps. per_group128 runs the plain versions of
    K6 and K12 against the TPU kernels in interpret mode."""
    jcfg, cfg = _configs(H256)
    params = _random_checkpoint(cfg, seed=1)
    kw = POLICIES[policy]
    _prefill_and_decode_match(jax_convert_checkpoint(params, jcfg, **kw),
                              convert_checkpoint(params, cfg, device="cpu", **kw), cfg)


@pytest.mark.parametrize("mode", ["as_turbo", "as_u4_turbo", "as_xla_turbo", "as_per_group"])
def test_mode_converters_pass_dense_linears_through(mode):
    """A converted model's dense router and dense lm_head stay the same
    ``DenseLinear`` under every mode converter, as in JAX, and the converted
    copy runs."""
    _, cfg = _configs(H256)
    model = convert_checkpoint(_random_checkpoint(cfg, seed=3), cfg, device="cpu",
                               quantize_lm_head=False)
    converted = getattr(transformer, mode)(model)
    for got, want in ((converted.blocks[1].moe.router, model.blocks[1].moe.router),
                      (converted.lm_head, model.lm_head)):
        assert isinstance(got, DenseLinear) and got.weight is want.weight
    tokens = torch.tensor([[1, 2, 3, 4]])
    with torch.no_grad():
        logits, _ = converted(tokens, converted.init_cache(cfg, 1, 8), torch.arange(4))
    assert logits.shape == (1, 4, cfg.vocab_size) and torch.isfinite(logits).all()


def test_convert_takes_per_tensor_and_awq():
    """The two calls once refused build their models: per_tensor weights
    (one scale per linear, one per expert), and an AWQ conversion whose
    ``awq_alphas`` names the five sites of a two-layer model."""
    _, cfg = _configs(H256)
    params = _random_checkpoint(cfg)
    model = convert_checkpoint(params, cfg, granularity="per_tensor", device="cpu")
    blk = model.blocks[0]
    assert (blk.attn.wq.granularity, blk.attn.wq.scales.shape) == ("per_tensor", ())
    assert (blk.moe.w_up.granularity, blk.moe.w_up.scales.shape) == (
        "per_tensor", (cfg.moe.num_experts,))
    assert model.awq_alphas is None
    model = convert_checkpoint(params, cfg, awq_tokens=np.zeros((1, 4), np.int32), device="cpu")
    assert sorted(model.awq_alphas) == ["layers.0.attn", "layers.0.moe", "layers.1.attn",
                                        "layers.1.moe", "lm_head"]


@pytest.mark.parametrize("entry", ["convert_checkpoint", "quantize_dense_2d",
                                   "dense_from_params"])
def test_conversion_entry_points_default_to_the_card(entry):
    """With no device, the conversion builds on the CUDA card; on a machine
    without one it raises and names ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default builds there")
    _, cfg = _configs(H256)
    call = {"convert_checkpoint": lambda: convert_checkpoint({}, cfg),
            "quantize_dense_2d": lambda: quantize_dense_2d(np.zeros((2, 32), np.float32)),
            "dense_from_params": lambda: dense_from_params({}, cfg)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


# --- the trained fixture's quality through the port -----------------------------------


def test_h256_fixture_quality_gates_through_the_port():
    """``tests/test_convert.py``'s h256 gates (``chip_smoke.quality_gates``,
    with the AWQ policies' cosine property of ``tests/test_equalize.py``),
    on the port's CPU path (the plain versions of K1, K2, K6, K12 and K3, and
    the golden path at gs = 64 and per tensor) in the seven policies of the
    JAX quality record, evaluated as ``chip_smoke`` does on the card."""
    cfg = fixture_config(H256)
    raw = load_safetensors(H256)
    tokens = heldout_tokens(H256)
    ref, nll_ref = evaluate(dense_from_params(raw, cfg, device="cpu"), cfg, tokens, "cpu")
    res = {label: policy_metrics(*evaluate(
        convert_checkpoint(raw, cfg, device="cpu", **policy_kwargs(label, H256)),
        cfg, tokens, "cpu"), ref, nll_ref) for label in QUALITY_POLICIES}
    gates = quality_gates(res, nll_ref, cfg.vocab_size)
    assert all(gates.values()), gates
    for label in QUALITY_POLICIES:
        assert np.isfinite(res[label]["heldout_nll"]), label


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and ``chip_smoke.py``, import nothing of JAX
    and nothing of the JAX package (a fresh interpreter's modules)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import fused4bit_tpu_torch\n"
        "for m in pkgutil.walk_packages(fused4bit_tpu_torch.__path__, 'fused4bit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', "
        "'fused4bit_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
