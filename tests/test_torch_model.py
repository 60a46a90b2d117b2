"""Port vs JAX package: the whole `tiny` model on the same bytes (converted
with ``model_from_jax``), one prefill then three decode steps, in the
default execution mode and after each of the JAX converters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fused4bit_tpu.models import transformer as jax_transformer
from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu_torch.models import model_from_jax
from fused4bit_tpu_torch.models.transformer import rms_norm, rotary_embedding
from fused4bit_tpu_torch.ops import int4_grouped_transient, to_int8_resident


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


def _prefill_and_decode_match(jmodel, model, cfg):
    b, prompt_len, max_seq = 2, 5, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, prompt_len), dtype=np.int32)
    jcaches = jmodel.init_cache(cfg, b, max_seq)
    caches = model.init_cache(cfg, b, max_seq)
    positions = np.arange(prompt_len, dtype=np.int32)
    for step in range(4):  # prefill, then 3 decode steps fed JAX's greedy token
        jlogits, jcaches = jmodel(jnp.asarray(tokens), jcaches, jnp.asarray(positions))
        logits, caches = model(torch.from_numpy(tokens), caches, torch.from_numpy(positions))
        ref = np.asarray(jlogits.astype(jnp.float32))
        got = logits.float().numpy()
        assert got.shape == ref.shape == (b, len(positions), cfg.vocab_size)
        assert np.max(np.abs(got - ref)) <= 2e-2 * np.max(np.abs(ref)), f"step {step}"
        # the port's next token is in JAX's top-2 at every row
        top2 = np.argsort(ref[:, -1], axis=-1)[:, -2:]
        nxt = got[:, -1].argmax(axis=-1)
        assert all(nxt[i] in top2[i] for i in range(b)), f"step {step}"
        tokens = ref[:, -1].argmax(axis=-1).astype(np.int32)[:, None]
        positions = np.asarray([prompt_len + step], np.int32)
    for c, jc in zip(caches, jcaches):
        np.testing.assert_array_equal(c.lengths.numpy(), np.asarray(jc.lengths))


def test_tiny_model_prefill_and_decode_match_jax():
    cfg = flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    _prefill_and_decode_match(jmodel, model_from_jax(_params(jmodel), cfg, device="cpu"), cfg)


@pytest.fixture(scope="module")
def tiny_jax_model():
    cfg = flagship_model_config("tiny")
    return cfg, JaxTransformer.init(jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("mode", ["u4_turbo", "turbo", "xla_turbo"])
def test_tiny_model_modes_match_jax(tiny_jax_model, mode):
    cfg, jmodel = tiny_jax_model
    jmodel = getattr(jax_transformer, f"as_{mode}")(jmodel)
    model = model_from_jax(_params(jmodel), cfg, mode=mode, device="cpu")
    blk = model.blocks[0]
    want = {"u4_turbo": ("int8_auto", "int8", "u4_turbo", 32),
            "turbo": ("int8", "int8", "kernel", 32),
            "xla_turbo": ("int8_xla", "bf16", "xla_turbo", 16)}[mode]
    assert (blk.attn.wq.activation, blk.moe.w_gate.activation, blk.moe.moe_impl,
            blk.moe.tile_m) == want
    _prefill_and_decode_match(jmodel, model, cfg)


def test_tiny_model_u4_turbo_capacity_prefill_matches_jax(tiny_jax_model):
    """prefill_threshold lowered to 2 on both sides: an 8-token forward takes
    the capacity layout on transient i8 expert weights."""
    cfg, jmodel = tiny_jax_model
    jmodel = jax_transformer.as_u4_turbo(jmodel)
    model = model_from_jax(_params(jmodel), cfg, mode="u4_turbo", device="cpu")
    jmodel = dataclasses.replace(jmodel, blocks=tuple(
        dataclasses.replace(b, moe=dataclasses.replace(b.moe, prefill_threshold=2))
        for b in jmodel.blocks))
    for blk in model.blocks:
        blk.moe.prefill_threshold = 2
    tokens = np.arange(5, 13, dtype=np.int32)[None, :]
    positions = np.arange(8, dtype=np.int32)
    jlogits, _ = jmodel(jnp.asarray(tokens), jmodel.init_cache(cfg, 1, 16), jnp.asarray(positions))
    before = int4_grouped_transient.calls
    logits, _ = model(torch.from_numpy(tokens), model.init_cache(cfg, 1, 16),
                      torch.from_numpy(positions))
    assert int4_grouped_transient.calls - before == 3 * cfg.num_layers
    ref = np.asarray(jlogits.astype(jnp.float32))
    got = logits.float().numpy()
    assert np.max(np.abs(got - ref)) <= 2e-2 * np.max(np.abs(ref))


def test_wide_w4a8_prefill_departs_from_default_as_in_jax():
    """At the residual and attention width of `layer2` (hidden 4096, 32 query
    and 8 KV heads of 128, 8 experts top-2, vocab 8192; expert FFN narrowed
    from 14336 to 1024), random weights and a 2 x 320-token prefill, the
    u4_turbo logits depart from the default mode's at a third of the
    positions in the JAX package itself: the router flips the expert pair of
    those tokens. The two w4a8 modes depart from each other too (their
    epilogues round in another order). The port, on the same bytes, departs
    the same way."""
    from fused4bit_tpu.models.config import ModelConfig, MoEConfig

    cfg = ModelConfig(name="wide", moe=MoEConfig("wide", 8, 4096, 1024, 2), num_layers=2,
                      num_heads=32, num_kv_heads=8, head_dim=128, vocab_size=8192,
                      max_seq_len=1024)
    b, t = 2, 320
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (b, t)).astype(np.int32)
    positions = np.arange(t, dtype=np.int32)
    jbase = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    logits = {}
    for mode in ("kernel", "u4_turbo", "turbo"):
        jmodel = jbase if mode == "kernel" else getattr(jax_transformer, f"as_{mode}")(jbase)
        jl, _ = jmodel(jnp.asarray(tokens), jmodel.init_cache(cfg, b, t), jnp.asarray(positions))
        model = model_from_jax(_params(jmodel), cfg, mode=mode, device="cpu")
        with torch.no_grad():
            tl, _ = model(torch.from_numpy(tokens), model.init_cache(cfg, b, t),
                          torch.from_numpy(positions))
        logits[mode] = (torch.from_numpy(np.array(jl.astype(jnp.float32))), tl.float())
        # the port follows JAX within one mode
        last = F.cosine_similarity(tl.float()[:, -1], logits[mode][0][:, -1], dim=-1)
        assert last.min().item() > 0.995, (mode, last.tolist())

    def departure(mode, base, side):
        got, ref = logits[mode][side], logits[base][side]
        per_pos = F.cosine_similarity(got, ref, dim=-1)
        rows = F.cosine_similarity(got.reshape(b, -1), ref.reshape(b, -1), dim=-1)
        return (per_pos < 0.98).float().mean().item(), rows

    # share of positions below cos 0.98: JAX reads 0.33 and 0.16
    for mode, base, least in (("u4_turbo", "kernel", 0.2), ("turbo", "u4_turbo", 0.08)):
        jax_share, jax_rows = departure(mode, base, 0)
        port_share, port_rows = departure(mode, base, 1)
        assert jax_share > least, (mode, jax_share)
        assert abs(port_share - jax_share) <= 0.05, (mode, port_share, jax_share)
        assert (port_rows - jax_rows).abs().max().item() <= 0.01, (mode, port_rows, jax_rows)


def test_model_from_jax_refuses_unconsumed_leaves(tiny_jax_model):
    cfg, jmodel = tiny_jax_model
    params = _params(jax_transformer.as_xla_turbo(jmodel))
    with pytest.raises(ValueError, match=r"\.w8\.q8"):
        model_from_jax(params, cfg, device="cpu")        # mode="kernel" drops the .w8 leaves
    with pytest.raises(ValueError, match="unconsumed"):
        model_from_jax({**_params(jmodel), ".extra": np.zeros(1)}, cfg, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        model_from_jax(_params(jmodel), cfg, mode="fp4", device="cpu")
    model = model_from_jax(params, cfg, mode="xla_turbo", device="cpu")
    for lin, key in ((model.blocks[0].attn.wq, ".blocks[0].attn.wq"),
                     (model.lm_head, ".lm_head"),
                     (model.blocks[1].moe.w_down, ".blocks[1].moe.w_down")):
        np.testing.assert_array_equal(lin.w8.q8.numpy(), params[f"{key}.w8.q8"])
        np.testing.assert_array_equal(lin.w8.q8.numpy(), to_int8_resident(lin.weight).q8.numpy())


def test_rms_norm_and_rope_match_jax(rng):
    from fused4bit_tpu.models.transformer import rms_norm as jax_rms_norm
    from fused4bit_tpu.models.transformer import rotary_embedding as jax_rope

    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)), rtol=1e-5, atol=1e-6)
    for pos in (np.arange(4, dtype=np.int32), np.asarray([[0, 1, 2, 3], [7, 8, 9, 10]], np.int32)):
        np.testing.assert_allclose(
            rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
            np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
