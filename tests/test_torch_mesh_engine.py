"""Port vs JAX package: the serving engine's mesh mode, and checkpoints and
the elastic loop over a mesh (``shardings=``).

Ranks are spawned as in ``tests/test_torch_parallel.py`` (this file runs as
a rank: ``python test_torch_mesh_engine.py GROUP WORLD RANK PORT DIR``), on
the `tiny` model's bytes carried from JAX. The mesh engine's first tokens,
after a one-chunk and a chunked prefill, equal the JAX mesh engine's on the
same mesh shape (``tests/test_serving.py``'s sharded-engine checks), and
every rank serves the same tokens. Checkpoint slices are exact: a whole save
restored onto 2 ranks gives each rank JAX's shard of the same tensor (Orbax
with ``shardings``), and a state saved under one `data` size restores under
another to the same bytes.
"""
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import Spawn, rank_main, same_on_every_rank

PROMPTS = {"first": [5, 7, 9], "chunked": list(range(3, 14))}   # chunks of 4: 4/4/3
CACHE_B, CACHE_S = 4, 16


def _tiny(outdir, seed=None):
    """The `tiny` model: the bytes saved in ``outdir`` (seed None), or a
    template from another seed."""
    from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config
    from fused4bit_tpu_torch.utils import checkpoint

    cfg = flagship_model_config("tiny")
    model = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(seed or 5),
                                      device="cpu")
    if seed is None:
        model = checkpoint.load(os.path.join(outdir, "tiny"), model)
    return cfg, model


def _kv(step, b, cfg):
    """Deterministic K/V [b, Hkv, 1, D] for decode step ``step``."""
    g = torch.Generator().manual_seed(100 + step)
    return tuple(torch.randn((b, cfg.num_kv_heads, 1, cfg.head_dim), generator=g)
                 for _ in range(2))


def _fields(caches):
    """Caches as plain dicts of their tensors (what a test process loads)."""
    return [{f: getattr(c, f).clone() for f in c._FIELDS} for c in caches]


def _port_engine(world, outdir):
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.serving import GenerationRequest, ServingEngine

    cfg, model = _tiny(outdir)
    mesh = par.make_mesh(("data", "expert"), (2, world // 2), device_type="cpu")
    sm = par.place_model(model, mesh)
    out = {}
    with torch.no_grad():
        for name, prompt in PROMPTS.items():
            eng = ServingEngine(sm, cfg, num_slots=2, max_seq=64, prefill_bucket=4, mesh=mesh)
            eng.submit(GenerationRequest(uid=0, prompt=prompt, max_new_tokens=1))
            out[name] = eng.run()[0][0]
        eng = ServingEngine(sm, cfg, num_slots=2, max_seq=64, prefill_bucket=8, mesh=mesh)
        for uid in range(3):
            eng.submit(GenerationRequest(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=3))
        out["recycle"] = torch.tensor([eng.run()[uid] for uid in range(3)])
        # the budget keeps the reserved prefill tail clear: max_seq - prompt - bucket tokens
        eng.submit(GenerationRequest(uid=9, prompt=[4, 5, 6], max_new_tokens=100))
        out["budget"] = len(eng.run()[9])

    def raises(**kw):
        try:
            ServingEngine(sm, cfg, **{**dict(num_slots=2, max_seq=64, prefill_bucket=8,
                                             mesh=mesh), **kw})
        except ValueError:
            return True
        return False

    out["raises"] = (raises(num_slots=3), raises(paged=True, page_size=32),
                     raises(draft_model=sm, draft_cfg=cfg))
    return out


def _port_checkpoint(world, outdir):
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.utils import checkpoint, elastic_loop

    cfg, _ = _tiny(outdir)
    by_expert = par.make_mesh(("data", "expert"), (1, world), device_type="cpu")
    by_data = par.make_mesh(("data", "expert"), (world, 1), device_type="cpu")
    out = {}
    # a whole save onto 2 ranks: the experts split, into a template of another seed
    tmpl = par.place_model(_tiny(outdir, seed=7)[1], by_expert)
    got = checkpoint.load(os.path.join(outdir, "tiny"), tmpl, par.model_pspecs(tmpl), by_expert)
    out["model"] = dict(got.state_dict())
    # whole caches onto the data split, then saved from it and restored at data size 1
    def caches(b):
        return tuple(_tiny(outdir, seed=7)[1].init_cache(cfg, b, CACHE_S))

    split = par.Shard("data", 0)
    local = checkpoint.load(os.path.join(outdir, "caches"), caches(CACHE_B // world), split,
                            by_data)
    out["caches_split"] = _fields(local)
    checkpoint.save(os.path.join(outdir, "resharded"), local, split, by_data)
    out["caches_whole"] = _fields(checkpoint.load(os.path.join(outdir, "resharded"),
                                                  caches(CACHE_B), split, by_expert))

    # the elastic loop over the data split, relaunched at data size 1
    def step(state, i):
        k, v = _kv(i, CACHE_B, cfg)   # the whole batch's, cut to this rank's rows
        rows = slice(state["first"], state["first"] + state["caches"][0].lengths.shape[0])
        for c in state["caches"]:
            c.append(k[rows], v[rows])
        return state

    ckdir = os.path.join(outdir, "elastic")
    first = par.mesh.axis_index(by_data, "data") * (CACHE_B // world)
    state, resumed = elastic_loop(step, {"caches": local, "first": first}, ckpt_dir=ckdir,
                                  num_steps=4, save_every=2,
                                  shardings={"caches": split}, mesh=by_data)
    out["elastic_split"], out["elastic_resumed_split"] = _fields(state["caches"]), resumed
    torch.distributed.barrier()
    state, resumed = elastic_loop(step, {"caches": caches(CACHE_B), "first": 0}, ckpt_dir=ckdir,
                                  num_steps=4, save_every=2,
                                  shardings={"caches": split}, mesh=by_expert)
    out["elastic_whole"], out["elastic_resumed_whole"] = _fields(state["caches"]), resumed

    # shardings naming no split: every rank holds the whole state, rank 0 alone writes
    whole = {"caches": checkpoint.load(os.path.join(outdir, "caches"), caches(CACHE_B)),
             "step": 3}
    checkpoint.save(os.path.join(outdir, "unsplit"), whole, {"caches": None, "step": None},
                    by_data)
    got = checkpoint.load(os.path.join(outdir, "unsplit"), {"caches": caches(CACHE_B), "step": 0},
                          {"caches": None, "step": None}, by_data)
    out["unsplit"] = (_fields(got["caches"]), got["step"])
    # rank 0 cannot write (the parent is a file): every rank raises, none waits on
    blocker = os.path.join(outdir, "a_file")
    open(blocker, "a").close()
    try:
        checkpoint.save(os.path.join(blocker, "ckpt"), local, split, by_data)
        out["failed_write"] = None
    except (OSError, RuntimeError) as e:
        out["failed_write"] = type(e).__name__
    return out


GROUPS = {"e4": (_port_engine,), "c2": (_port_checkpoint,)}

if __name__ == "__main__":
    rank_main(GROUPS, sys.argv)
    sys.exit(0)

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from fused4bit_tpu.models.config import flagship_model_config  # noqa: E402
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer  # noqa: E402
from fused4bit_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from fused4bit_tpu.parallel.sharded_model import model_pspecs, place_model  # noqa: E402
from fused4bit_tpu.serving.engine import GenerationRequest, ServingEngine  # noqa: E402
from fused4bit_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from fused4bit_tpu_torch.layers import QuantizedKVCache  # noqa: E402
from fused4bit_tpu_torch.models import model_from_jax  # noqa: E402
from fused4bit_tpu_torch.utils import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = flagship_model_config("tiny")
    jmodel = jax.jit(lambda key: JaxTransformer.init(key, cfg))(jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jmodel)
    params = {jax.tree_util.keystr(p): np.asarray(a) for p, a in leaves}
    outdir = tmp_path_factory.mktemp("mesh_engine")
    model = model_from_jax(params, cfg, device="cpu")
    checkpoint.save(str(outdir / "tiny"), model)
    caches = model.init_cache(cfg, CACHE_B, CACHE_S)
    g = torch.Generator().manual_seed(3)
    for c in caches:
        c.append(*(torch.randn((CACHE_B, cfg.num_kv_heads, 5, cfg.head_dim), generator=g)
                   for _ in range(2)))
    checkpoint.save(str(outdir / "caches"), caches)
    return cfg, jmodel, model, caches, outdir


@pytest.fixture(scope="module")
def ranks(tiny):
    script = os.path.abspath(__file__)
    return {"e4": Spawn(script, "e4", 4, tiny[4]), "c2": Spawn(script, "c2", 2, tiny[4])}


@pytest.fixture(scope="module")
def jax_first_tokens(tiny):
    """The JAX mesh engine's first token of each prompt, both served by one
    engine (a prefill's rows do not see each other)."""
    cfg, jmodel = tiny[:2]
    mesh = jax_make_mesh(("data", "expert"), (2, 2), devices=jax.devices()[:4])
    eng = ServingEngine(place_model(jmodel, mesh), cfg, num_slots=2, max_seq=64,
                        prefill_bucket=4, mesh=mesh, interpret=True)
    for uid, prompt in enumerate(PROMPTS.values()):
        eng.submit(GenerationRequest(uid=uid, prompt=prompt, max_new_tokens=1))
    done = eng.run()
    return {name: done[uid][0] for uid, name in enumerate(PROMPTS)}


@pytest.mark.parametrize("name", list(PROMPTS))
def test_mesh_engine_first_token_matches_jax_mesh_engine(ranks, jax_first_tokens, name):
    assert ranks["e4"].all("_port_engine", name) == [jax_first_tokens[name]] * 4


def test_mesh_engine_serves_recycles_and_raises(ranks):
    tokens = same_on_every_rank(ranks["e4"].all("_port_engine", "recycle"))
    assert tokens.shape == (3, 3)
    assert ranks["e4"].all("_port_engine", "budget") == [64 - 3 - 8] * 4
    # num_slots not divisible by the data size, paged, speculative
    assert ranks["e4"].all("_port_engine", "raises") == [(True, True, True)] * 4


def test_checkpoint_load_shardings_gives_jax_shards(ranks, tiny, tmp_path):
    cfg, jmodel, model = tiny[:3]
    mesh = jax_make_mesh(("data", "expert"), (1, 2), devices=jax.devices()[:2])
    jax_checkpoint.save(str(tmp_path / "jax"), jmodel)
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), model_pspecs(jmodel))
    jgot = jax_checkpoint.load(str(tmp_path / "jax"), jmodel, shardings)
    whole = model.state_dict()
    for r in range(2):
        got = ranks["c2"].rank(r)["_port_checkpoint"]["model"]
        assert got.keys() == whole.keys()
        for k, v in got.items():
            e = v.shape[0]
            want = whole[k][r * e:(r + 1) * e] if ".moe.w_" in k else whole[k]
            assert torch.equal(v, want), k
        for blk, jblk in enumerate(jgot.blocks):
            for name in ("w_gate", "w_up", "w_down"):
                arr = getattr(jblk.moe, name).weight.packed
                shard = next(s.data for s in arr.addressable_shards
                             if s.device == mesh.devices.flat[r])
                np.testing.assert_array_equal(got[f"blocks.{blk}.moe.{name}.packed"].numpy(),
                                              np.asarray(shard))


def test_checkpoint_restores_under_another_data_size(ranks, tiny):
    caches = tiny[3]
    for r in range(2):
        res = ranks["c2"].rank(r)["_port_checkpoint"]
        rows = slice(r * CACHE_B // 2, (r + 1) * CACHE_B // 2)
        for split, whole, want in zip(res["caches_split"], res["caches_whole"], caches):
            for f in QuantizedKVCache._FIELDS:
                assert torch.equal(split[f], getattr(want, f)[rows]), f
                assert torch.equal(whole[f], getattr(want, f)), f


def test_checkpoint_save_with_no_split_writes_once_and_restores(ranks, tiny):
    caches = tiny[3]
    for r in range(2):
        fields, step = ranks["c2"].rank(r)["_port_checkpoint"]["unsplit"]
        assert step == 3
        for got, want in zip(fields, caches):
            for f in QuantizedKVCache._FIELDS:
                assert torch.equal(got[f], getattr(want, f)), f


def test_checkpoint_save_fails_on_every_rank_when_rank_0_cannot_write(ranks):
    failed = [ranks["c2"].rank(r)["_port_checkpoint"]["failed_write"] for r in range(2)]
    assert failed[0] in ("FileExistsError", "NotADirectoryError") and failed[1] == "RuntimeError"


def test_elastic_loop_shardings_resumes_under_another_data_size(ranks):
    res = [ranks["c2"].rank(r)["_port_checkpoint"] for r in range(2)]
    assert [r["elastic_resumed_split"] for r in res] == [0, 0]
    assert [r["elastic_resumed_whole"] for r in res] == [4, 4]
    for layer in range(len(res[0]["elastic_whole"])):
        for f in QuantizedKVCache._FIELDS:
            split = torch.cat([r["elastic_split"][layer][f] for r in res])
            for r in res:
                assert torch.equal(r["elastic_whole"][layer][f], split), f
    assert res[0]["elastic_whole"][0]["lengths"].tolist() == [5 + 4] * CACHE_B
