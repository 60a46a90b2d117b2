"""Port vs JAX package: the whole `tiny` model on the same bytes (converted
with ``model_from_jax``), one prefill then three decode steps."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fused4bit_tpu.models.config import flagship_model_config
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer
from fused4bit_tpu_torch.models import model_from_jax
from fused4bit_tpu_torch.models.transformer import rms_norm, rotary_embedding


def _params(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in leaves}


def test_tiny_model_prefill_and_decode_match_jax():
    cfg = flagship_model_config("tiny")
    jmodel = JaxTransformer.init(jax.random.PRNGKey(0), cfg)
    model = model_from_jax(_params(jmodel), cfg)
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
