"""Port vs JAX package: activation-aware equalization (``quant.equalize``)
and ``convert_checkpoint(awq_tokens=...)``.

The outlier checkpoint is JAX's own (``tests/test_equalize._tiny_params``,
hot embedding channels): on it the grid search adopts a rescaling. On the
trained h256 fixture the identity wins at every site, as in the JAX quality
record. Tolerances: alpha choices exactly; site scales rtol 1e-5 and the
equalized weights rtol 1e-6 (the two libraries' float32 sums of the
calibration activations differ in the last bits); the equalized twin keeps
its function to rel 5e-5 (JAX's bar); logits as the other model tests
(``test_torch_model._prefill_and_decode_match``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.models.config import flagship_model_config as jax_flagship
from fused4bit_tpu.models.convert import convert_checkpoint as jax_convert_checkpoint
from fused4bit_tpu.quant.equalize import awq_equalize_params as jax_awq_equalize_params
from fused4bit_tpu.quant.equalize import awq_site_scale as jax_awq_site_scale
from fused4bit_tpu_torch.models import (
    convert_checkpoint,
    convert_safetensors,
    dense_from_params,
    flagship_model_config,
    load_safetensors,
)
from fused4bit_tpu_torch.quant import awq_equalize_params, awq_site_scale, dequantize, quantize
from fused4bit_tpu_torch.quant.equalize import _ALPHAS, _calibrate, _site_choice
from chip_smoke import calibration_tokens, fixture_config
from test_equalize import _tiny_params
from test_torch_convert import H256, _assert_same_module
from test_torch_model import _prefill_and_decode_match

TOKENS = (np.arange(32, dtype=np.int32) * 7).reshape(2, 16) % 512   # test_equalize's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return jax_flagship("tiny"), flagship_model_config("tiny")


def _jax_alpha(x, weights, **kw):
    """The alpha JAX's grid search picks on these inputs (None: the identity),
    found by matching its result against its scale at each pinned alpha."""
    x, ws = jnp.asarray(np.asarray(x)), [jnp.asarray(np.asarray(w)) for w in weights]
    best = np.asarray(jax_awq_site_scale(x, ws, **kw))
    for a in _ALPHAS:
        if np.array_equal(best, np.asarray(jax_awq_site_scale(x, ws, alpha=a, **kw))):
            return a
    np.testing.assert_array_equal(best, np.ones_like(best))
    return None


def test_site_scale_on_salient_channels_matches_jax():
    """JAX's salient-channel case (tests/test_equalize.py): the same alpha,
    the same scales to rtol 1e-5, and the defining property, a reconstruction
    error below 0.8 of the plain quantization's."""
    rng = np.random.default_rng(1)
    k, n, t = 256, 384, 512
    x = rng.standard_normal((t, k)).astype(np.float32)
    x[:, :8] *= 20.0
    w = (rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    alpha, s = _site_choice(xt, [wt])
    assert alpha is not None and alpha == _jax_alpha(x, [w])
    want = np.asarray(jax_awq_site_scale(jnp.asarray(x), [jnp.asarray(w)]))
    np.testing.assert_allclose(awq_site_scale(xt, [wt]).numpy(), want, rtol=1e-5)

    def err(scale):
        wd = dequantize(quantize(wt * scale[None, :])) / scale[None, :]
        return float(((xt @ wd.t() - xt @ wt.t()) ** 2).sum())

    assert err(s) < 0.8 * err(torch.ones(k))


def _sites(params, cfg, capture):
    """(site, calibration activations, quantized consumers) of every site."""
    per_block = [h for tap, h in capture if tap != "final_in"]
    for layer in range(cfg.num_layers):
        pre = f"layers.{layer}"
        yield (f"{pre}.attn", per_block[2 * layer],
               [params[f"{pre}.attn.{p}_proj.weight"] for p in "qkv"])
        yield (f"{pre}.moe", per_block[2 * layer + 1],
               [params[f"{pre}.moe.experts.{i}.{w}.weight"]
                for w in ("w1", "w3") for i in range(cfg.moe.num_experts)])
    yield "lm_head", capture[-1][1], [params["lm_head.weight"]]


def _checkpoint(name, tiny):
    """(params, port config, calibration tokens) of a named checkpoint."""
    if name == "outlier":
        return _tiny_params(tiny[0], seed=2, outlier=6), tiny[1], TOKENS
    return load_safetensors(H256), fixture_config(H256), calibration_tokens(H256)


@pytest.mark.parametrize("granularity,gs", [("per_row", 128), ("per_group", 64)])
@pytest.mark.parametrize("name", ["outlier", "h256"])
def test_site_choices_equal_jax(tiny, name, granularity, gs):
    """On the same captured activations, every site's alpha equals the one
    JAX's grid search picks: a rescaling on the outlier checkpoint, the
    identity at every site of the trained h256 fixture (as the JAX quality
    record shows)."""
    params, cfg, tokens = _checkpoint(name, tiny)
    _, capture = _calibrate(params, cfg, tokens, "cpu")
    kw = dict(granularity=granularity, group_size=gs)
    for site, x, weights in _sites(params, cfg, capture):
        alpha, _ = _site_choice(x, [torch.from_numpy(np.array(w)) for w in weights], **kw)
        assert alpha == _jax_alpha(x, weights, **kw), site
        assert (alpha is None) == (name == "h256"), site


@pytest.mark.parametrize("granularity,gs", [("per_row", 128), ("per_group", 64)])
def test_equalized_checkpoint_matches_jax(tiny, granularity, gs):
    """Every weight of the equalized checkpoint, read through the scales,
    equals JAX's equalized dict to rtol 1e-6; keys no site scales read as
    given."""
    jcfg, cfg = tiny
    params = _tiny_params(jcfg, seed=2, outlier=6)
    kw = dict(granularity=granularity, group_size=gs)
    want = jax_awq_equalize_params(dict(params), jcfg, TOKENS, **kw)
    eq = awq_equalize_params(params, cfg, TOKENS, device="cpu", **kw)
    assert sorted(eq) == sorted(want) and all(a is not None for a in eq.alphas.values())
    for key in params:
        got = eq[key]
        if key in eq.scales or key in eq.divisors:
            np.testing.assert_allclose(got.numpy(), want[key], rtol=1e-6, atol=0, err_msg=key)
        else:
            assert got is params[key] and np.array_equal(want[key], params[key]), key


def test_equalization_keeps_the_function(tiny):
    """Scaled weights and divided norms are the same dense function (JAX's
    bar: rel < 5e-5, the float32 rounding of the fold)."""
    jcfg, cfg = tiny
    params = _tiny_params(jcfg)
    toks = np.arange(24, dtype=np.int64).reshape(2, 12) % cfg.vocab_size
    eq = awq_equalize_params(params, cfg, toks, alpha=0.5, device="cpu")

    def logits(p):
        dense = dense_from_params(p, cfg, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            out, _ = dense(torch.from_numpy(toks), dense.init_cache(cfg, 2, 12, torch.float32),
                           torch.arange(12))
        return out

    l0, l1 = logits(params), logits(eq)
    assert float(torch.linalg.norm(l1 - l0) / torch.linalg.norm(l0)) < 5e-5


@pytest.mark.parametrize("name", ["outlier", "h256"])
def test_dense_all_and_gather_calibrations_agree(tiny, name):
    """The twin the port calibrates through (``dense_all``) and JAX's
    (``gather``) capture the same activations to f32 rounding, and every
    site chooses the same alpha on either."""
    params, cfg, tokens = _checkpoint(name, tiny)
    _, dense_all = _calibrate(params, cfg, tokens, "cpu")
    _, gather = _calibrate(params, cfg, tokens, "cpu", moe_impl="gather")
    assert [tap for tap, _ in dense_all] == [tap for tap, _ in gather]
    for (tap, a), (_, b) in zip(dense_all, gather):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()), msg=tap)
    for (site, x, weights), (_, y, _) in zip(_sites(params, cfg, dense_all),
                                             _sites(params, cfg, gather)):
        ws = [torch.from_numpy(np.array(w)) for w in weights]
        assert _site_choice(x, ws)[0] == _site_choice(y, ws)[0], site


def test_convert_with_awq_matches_jax(tiny):
    """``convert_checkpoint(awq_tokens=...)`` on the outlier checkpoint: the
    port's logits match JAX's AWQ model over a prefill and three decode
    steps, and the AWQ model tracks the dense reference at least as well as
    the plain conversion (tests/test_equalize.py's property)."""
    jcfg, cfg = tiny
    params = _tiny_params(jcfg, seed=2, outlier=6)
    awq = convert_checkpoint(params, cfg, awq_tokens=TOKENS, device="cpu")
    assert all(a is not None for a in awq.awq_alphas.values())
    _prefill_and_decode_match(jax_convert_checkpoint(dict(params), jcfg, awq_tokens=TOKENS),
                              awq, cfg)
    dense = dense_from_params(params, cfg, dtype=torch.float32, device="cpu")
    toks, pos = torch.from_numpy(TOKENS.astype(np.int64)), torch.arange(16)
    with torch.no_grad():
        ref, _ = dense(toks, dense.init_cache(cfg, 2, 16, torch.float32), pos)

        def cos(model):
            out, _ = model(toks, model.init_cache(cfg, 2, 16), pos)
            return float(torch.nn.functional.cosine_similarity(
                out.float().reshape(-1), ref.reshape(-1), dim=0))

        plain = convert_checkpoint(params, cfg, device="cpu")
        assert cos(awq) >= cos(plain) - 1e-3 and cos(awq) > 0.95


@pytest.mark.parametrize("kw", [{}, dict(granularity="per_group", group_size=64)])
def test_identity_awq_conversion_equals_the_plain_one(kw):
    """On the trained h256 fixture every site keeps the identity, so the AWQ
    conversion holds the plain conversion's bytes, scales and norms."""
    cfg = fixture_config(H256)
    awq = convert_safetensors(H256, cfg, device="cpu", awq_tokens=calibration_tokens(H256), **kw)
    assert set(awq.awq_alphas.values()) == {None}
    _assert_same_module(awq, convert_safetensors(H256, cfg, device="cpu", **kw))
