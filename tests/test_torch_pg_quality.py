"""The per-group and w4a8 paths on trained weights: the h256 fixture,
converted per row and then ``as_per_group`` (K7, K13, K3 on the card) or
``as_u4_turbo`` (K5, K10, K3), through the port's plain versions on the CPU
against the JAX package's kernels in interpret mode.
``chip_smoke.trained_checkpoint`` measures the same models' quality on the
card against their bf16 twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import QUALITY_POLICIES, heldout_tokens
from fused4bit_tpu.models import transformer as jax_transformer
from fused4bit_tpu.models.convert import convert_safetensors as jax_convert_safetensors
from fused4bit_tpu_torch import ops
from fused4bit_tpu_torch.models import as_per_group, as_u4_turbo, convert_safetensors
from test_torch_convert import H256, _configs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prefill_and_decode(jmodel, jcfg, model, cfg):
    """``_prefill_and_decode_match``'s procedure and bar on 2 rows of the
    fixture's held-out tail: a 5-token prefill, then 3 decode steps fed
    JAX's greedy token; logits within 2e-2 of the largest, the port's next
    token in JAX's top-2."""
    tokens = heldout_tokens(H256, seq=5, rows=2).astype(np.int32)
    positions = np.arange(5, dtype=np.int32)
    jcaches, caches = jmodel.init_cache(jcfg, 2, 16), model.init_cache(cfg, 2, 16)
    for step in range(4):
        jlogits, jcaches = jmodel(jnp.asarray(tokens), jcaches, jnp.asarray(positions))
        with torch.no_grad():
            logits, caches = model(torch.from_numpy(tokens), caches, torch.from_numpy(positions))
        ref = np.asarray(jlogits.astype(jnp.float32))
        got = logits.float().numpy()
        assert got.shape == ref.shape == (2, len(positions), cfg.vocab_size)
        assert np.max(np.abs(got - ref)) <= 2e-2 * np.max(np.abs(ref)), f"step {step}"
        top2 = np.argsort(ref[:, -1], axis=-1)[:, -2:]
        nxt = got[:, -1].argmax(axis=-1)
        assert all(nxt[i] in top2[i] for i in range(2)), f"step {step}"
        tokens = ref[:, -1].argmax(axis=-1).astype(np.int32)[:, None]
        positions = np.asarray([5 + step], np.int32)


def test_h256_as_per_group_logits_match_jax():
    """The trained h256 fixture converted per row (router dense), then
    ``as_per_group`` (K7 for the projections and the LM head, K13 for the
    experts, K3): :func:`_prefill_and_decode`'s procedure and bar, then one
    2 x 32-token prefill of the held-out tail at the same bar (where the
    port's plain attention, before it applied the cache's affine after the
    dots as JAX does, parted from JAX at one position), the port's plain
    versions on the CPU against JAX's kernels in interpret mode."""
    jcfg, cfg = _configs(H256)
    kw = QUALITY_POLICIES["int4_router_dense"]
    jmodel = jax_transformer.as_per_group(jax_convert_safetensors(H256, jcfg, **kw))
    model = as_per_group(convert_safetensors(H256, cfg, device="cpu", **kw))
    assert (model.blocks[0].attn.wq.weight.layout, model.lm_head.weight.layout,
            model.blocks[0].moe.w_up.weight.layout) == ("planar_groups",) * 3
    calls = ops.int4_matmul_per_group_reference.calls
    _prefill_and_decode(jmodel, jcfg, model, cfg)
    assert ops.int4_matmul_per_group_reference.calls > calls
    tokens = heldout_tokens(H256, seq=32, rows=2).astype(np.int32)
    positions = np.arange(32, dtype=np.int32)
    jlogits, _ = jmodel(jnp.asarray(tokens), jmodel.init_cache(jcfg, 2, 64),
                        jnp.asarray(positions))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(tokens), model.init_cache(cfg, 2, 64),
                          torch.from_numpy(positions))
    ref = np.asarray(jlogits.astype(jnp.float32))
    assert np.max(np.abs(logits.float().numpy() - ref)) <= 2e-2 * np.max(np.abs(ref))


def test_h256_as_u4_turbo_logits_match_jax():
    """The same fixture under ``as_u4_turbo`` (K5 for the projections and
    the LM head, K10 for the experts, K3 at these sizes): the port's plain
    versions on the CPU against JAX's ``as_u4_turbo`` (kernels in interpret
    mode), :func:`_prefill_and_decode`'s procedure and bar.
    ``chip_smoke.trained_checkpoint`` measures its quality on the card."""
    jcfg, cfg = _configs(H256)
    kw = QUALITY_POLICIES["int4_router_dense"]
    jmodel = jax_transformer.as_u4_turbo(jax_convert_safetensors(H256, jcfg, **kw))
    model = as_u4_turbo(convert_safetensors(H256, cfg, device="cpu", **kw))
    calls = (ops.int4_matmul_a8_reference.calls, ops.grouped_int4_matmul_a8_reference.calls)
    _prefill_and_decode(jmodel, jcfg, model, cfg)
    assert ops.int4_matmul_a8_reference.calls > calls[0]
    assert ops.grouped_int4_matmul_a8_reference.calls > calls[1]
