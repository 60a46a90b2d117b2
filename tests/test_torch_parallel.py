"""Port vs JAX package: the parallel layer (``fused4bit_tpu_torch.parallel``).

The port runs SPMD, one process per rank, over gloo: each group of checks
spawns 2 or 4 ranks of this file (``python test_torch_parallel.py GROUP
WORLD RANK PORT DIR``), which join on 127.0.0.1, run the group's scenarios
on inputs made from numpy seeds, and save their results. The JAX function
runs on the same inputs in this process, on a mesh of the same size cut
from the 8 virtual CPU devices, jitted, with its kernels in interpret mode
as ``tests/test_parallel.py`` runs them. Tolerances are the JAX package's
own bars for the same functions against their goldens
(``tests/test_parallel.py``); byte slices and routing drops are exact, and
every replicated output is the same bits on every rank.
"""
import dataclasses
import datetime
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

# --- the ranks -----------------------------------------------------------------

E, K, N, T, TOPK, TILE_M = 4, 128, 64, 16, 2, 8


def _ep_case(seed, k=K, skewed=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((E, N, k)).astype(np.float32)
    x = rng.standard_normal((T, k)).astype(np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if skewed:   # every token picks experts 0 and 1: all pairs to rank 0
        logits = np.zeros((T, E), np.float32)
        logits[:, 0], logits[:, 1] = 50.0, 49.0
    return w, x, logits


def _linear_case(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((256, 128)).astype(np.float32),
            rng.standard_normal((4, 128)).astype(np.float32))


def _attn_case(seed, b, hq, hkv, t, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d)))


PIPE_M, PIPE_MB, PIPE_H = 3, 8, 128


def _pipe_case(stages, seed=2):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((PIPE_H, PIPE_H)) * PIPE_H ** -0.5).astype(np.float32)
          for _ in range(stages)]
    x = rng.standard_normal((PIPE_M, PIPE_MB, PIPE_H)).astype(np.float32)
    return ws, x


def _port_quantize(w, per_group=False):
    from fused4bit_tpu_torch.quant import quantize

    w = torch.from_numpy(w)
    if per_group:
        return quantize(w, granularity="per_group", group_size=128, layout="planar_groups")
    return quantize(w, layout="planar")


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _rows(a, mesh, axis):
    """This rank's rows of a numpy array split over ``axis``."""
    from fused4bit_tpu_torch.parallel import Shard, shard_tensor

    return shard_tensor(torch.from_numpy(a), mesh, Shard(axis, 0))


def _port_mesh_and_sharding(world, outdir):
    from fused4bit_tpu_torch import parallel as par

    rank = torch.distributed.get_rank()
    out = {"multihost": (par.multihost.initialize(), par.multihost.is_multihost(),
                         par.multihost.local_device_slice(world) == slice(rank, rank + 1)),
           "default": tuple(par.make_mesh(device_type="cpu").shape),
           "bad_shape": _raises(lambda: par.make_mesh(("data", "expert"), (world, 2),
                                                      device_type="cpu"))}
    mesh = par.make_mesh(("model",), (world,), device_type="cpu")
    w, _ = _linear_case()
    rng = np.random.default_rng(3)
    wg = rng.standard_normal((96, 512)).astype(np.float32)
    from fused4bit_tpu_torch.quant import quantize

    pg_planar = quantize(torch.from_numpy(wg), granularity="per_group", group_size=128,
                         layout="planar")
    for name, qt in (("out_row", _port_quantize(w)), ("out_group", pg_planar)):
        loc = par.shard_qt_out_dim(qt, mesh, "model")
        out[name] = (loc.packed, loc.scales, loc.zero_points, loc.shape)
    emesh = par.make_mesh(("expert",), (world,), device_type="cpu")
    we, _, _ = _ep_case(0, k=512)
    for name, qt in (("exp_row", _port_quantize(we)), ("exp_group", _port_quantize(we, True))):
        loc = par.shard_qt_experts(qt, emesh, "expert")
        out[name] = (loc.packed, loc.scales, loc.zero_points, loc.shape)
    whole = par.replicate({"w": _port_quantize(w), "x": [torch.arange(4)]}, mesh)
    out["replicate"] = (whole["w"].packed, whole["w"].shape, whole["x"][0])
    return out


def _port_tp(world, outdir):
    from fused4bit_tpu_torch import parallel as par

    mesh = par.make_mesh(("model",), (world,), device_type="cpu")
    w, x = _linear_case()
    qt = par.shard_qt_out_dim(_port_quantize(w), mesh, "model")
    x = torch.from_numpy(x)
    return {"gathered": par.tp_int4_matmul(x, qt, mesh, axis="model"),
            "sharded": par.tp_int4_matmul(x, qt, mesh, axis="model", gather_output=False)}


def _port_ep(world, outdir):
    from fused4bit_tpu_torch import parallel as par

    mesh = par.make_mesh(("expert",), (world,), device_type="cpu")
    out = {}
    kw = dict(top_k=TOPK, tile_m=TILE_M)
    for name, (k, pg) in {"replicated": (K, False), "replicated_pg": (512, True)}.items():
        w, x, logits = _ep_case(0, k=k)
        qt = par.shard_qt_experts(_port_quantize(w, pg), mesh)
        out[name] = par.moe_ep_replicated(torch.from_numpy(x), torch.from_numpy(logits), qt,
                                          mesh, **kw)
    for skewed in (False, True):
        w, x, logits = _ep_case(0, skewed=skewed)
        qt = par.shard_qt_experts(_port_quantize(w), mesh)
        xl, ll = _rows(x, mesh, "expert"), _rows(logits, mesh, "expert")
        tag = "_skewed" if skewed else ""
        for cf in (16.0, 0.25):
            out[f"a2a_{cf}{tag}"] = par.moe_ep_a2a(xl, ll, qt, mesh, capacity_factor=cf, **kw)
        out[f"dropless{tag}"] = par.moe_ep_a2a_dropless(xl, ll, qt, mesh, **kw)
        out[f"ring{tag}"] = par.moe_ep_ring(xl, ll, qt, mesh, **kw)
    # JAX's static receive bound: one that holds changes nothing, one too
    # small raises on every rank
    w, x, logits = _ep_case(0, skewed=True)
    qt = par.shard_qt_experts(_port_quantize(w), mesh)
    xl, ll = _rows(x, mesh, "expert"), _rows(logits, mesh, "expert")
    out["dropless_bound"] = par.moe_ep_a2a_dropless(xl, ll, qt, mesh, recv_rows=T * TOPK, **kw)
    out["dropless_short"] = _raises(lambda: par.moe_ep_a2a_dropless(
        xl, ll, qt, mesh, recv_rows=T * TOPK // world - 1, **kw))
    return out


def _port_sequence(world, outdir):
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.layers import QuantizedKVCache

    mesh = par.make_mesh(("seq",), (world,), device_type="cpu")

    def chunks(*arrays):
        return [par.shard_sequence(torch.from_numpy(a), mesh) for a in arrays]

    out = {}
    for hkv in (4, 2, 1):
        out[f"ring_hkv{hkv}"] = par.ring_attention(*chunks(*_attn_case(hkv, 2, 4, hkv, 32, 16)),
                                                   mesh)
    out["ring_noncausal"] = par.ring_attention(*chunks(*_attn_case(5, 1, 2, 2, 32, 8)), mesh,
                                               causal=False)
    bf = [c.bfloat16() for c in chunks(*_attn_case(6, 1, 2, 2, 32, 16))]
    out["ring_bf16"] = par.ring_attention(*bf, mesh)
    out["alias"] = par.sequence_sharded_attention(*chunks(*_attn_case(5, 1, 2, 2, 32, 8)), mesh,
                                                  causal=False)
    q, k, v = _attn_case(7, 2, 4, 2, 32, 16)
    cache = QuantizedKVCache.init(2, 2, 32, 16, device="cpu").append(torch.from_numpy(k),
                                                                       torch.from_numpy(v))
    cache.lengths.copy_(torch.tensor([8, 32], dtype=torch.int32))
    (ql,) = chunks(q)
    out["quantized"] = par.ring_attention_quantized(ql, par.shard_cache_sequence(cache, mesh),
                                                    mesh)
    # poison the scales past slot 0's length: slot 0's output must not move
    cache.v_scale[0, :, 8:] = 1e6
    out["quantized_poisoned"] = par.ring_attention_quantized(
        ql, par.shard_cache_sequence(cache, mesh), mesh)
    hq = 4 * world
    out["ulysses"] = par.ulysses_attention(*chunks(*_attn_case(8, 2, hq, world, 32, 8)), mesh)
    out["ulysses_gqa"] = par.ulysses_attention(*chunks(*_attn_case(9, 1, hq, 2 * world, 32, 8)),
                                               mesh)
    qo, ko, vo = chunks(*_attn_case(10, 1, 3, 2, 32, 8))
    out["raises"] = (
        _raises(lambda: par.shard_sequence(torch.zeros(1, 2, 13, 8), mesh)),
        _raises(lambda: par.shard_cache_sequence(
            QuantizedKVCache.init(1, 1, 3 * world, 8, device="cpu"), mesh)),
        _raises(lambda: par.ring_attention(qo, ko, vo, mesh)),
        _raises(lambda: par.ulysses_attention(*chunks(*_attn_case(11, 1, hq, 1, 32, 8)), mesh)),
    )
    return out


def _port_pipeline(world, outdir):
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.ops import int4_matmul
    from fused4bit_tpu_torch.quant import QuantizedTensor

    mesh = par.make_mesh(("stage",), (world,), device_type="cpu")
    ws, x = _pipe_case(world)
    qts = [_port_quantize(w) for w in ws]
    params = par.stack_stage_params([dict(packed=q.packed, scales=q.scales, zps=q.zero_points)
                                     for q in qts])
    local = {k: par.shard_tensor(v, mesh, par.Shard("stage", 0)) for k, v in params.items()}
    meta = qts[0]

    def stage_fn(p, act):
        q = QuantizedTensor(p["packed"], p["scales"], p["zps"], meta.shape,
                            granularity=meta.granularity, layout=meta.layout,
                            block_k=meta.block_k, group_size=meta.group_size, bits=meta.bits)
        return torch.tanh(int4_matmul(act, q))

    return {"out": par.pipeline_stages(stage_fn, local, torch.from_numpy(x).bfloat16(), mesh)}


def _port_sharded_step(world, outdir):
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.models import QuantizedTransformer, flagship_model_config
    from fused4bit_tpu_torch.utils import checkpoint

    cfg = flagship_model_config("tiny")
    model = checkpoint.load(os.path.join(outdir, "tiny"),
                            QuantizedTransformer.init(cfg, device="cpu"))
    mesh = par.make_mesh(("data", "expert"), (2, world // 2), device_type="cpu")
    sm = par.place_model(model, mesh)
    b, t = 4, 3
    tokens, positions = _step_inputs(cfg, b, t)
    rows = par.shard_tensor(tokens, mesh, par.Shard("data", 0))
    pos = par.shard_tensor(positions, mesh, par.Shard("data", 0))
    caches = sm.init_cache(cfg, b // 2, 8)
    with torch.no_grad():
        logits, caches = par.sharded_decode_step(sm, mesh, rows, caches, pos)
    return {"logits": logits, "lengths": caches[0].lengths,
            "e_local": sm.blocks[0].moe.w_gate.packed.shape[0]}


EP_MODES = ("grouped", "einsum", "u4_turbo", "xla_turbo", "per_group")


def _port_ep_modes(world, outdir):
    """The placed model's forward (each MoE block an EPMoEBlock on the rank's
    experts) against the whole model's, on the same 64 rows, in every path
    of MoEBlock.forward: a prefill threshold of 8 sends the rows to the
    dropless grouped path at prefill_tile_m, the einsum capacity layout, or
    the integer capacity layouts of u4_turbo and xla_turbo, at a capacity
    factor of 0.5, where pairs drop (``_ample``: the whole model at 16, where
    none do)."""
    from fused4bit_tpu_torch import parallel as par
    from fused4bit_tpu_torch.models import (QuantizedTransformer, as_per_group, as_u4_turbo,
                                            as_xla_turbo, flagship_model_config)
    from fused4bit_tpu_torch.utils import checkpoint

    cfg = flagship_model_config("tiny")
    model = checkpoint.load(os.path.join(outdir, "tiny"),
                            QuantizedTransformer.init(cfg, device="cpu"))
    mesh = par.make_mesh(("expert",), (world,), device_type="cpu")
    convert = {"u4_turbo": as_u4_turbo, "xla_turbo": as_xla_turbo, "per_group": as_per_group}
    tokens, positions = _step_inputs(cfg, 4, 16)
    out = {}
    for name in EP_MODES:
        m = convert.get(name, lambda m: m)(model)
        for blk in m.blocks:
            blk.moe.prefill_threshold = 8
            blk.moe.prefill_impl = "einsum" if name == "einsum" else "grouped"
            blk.moe.capacity_factor = 0.5
        placed = par.place_model(m, mesh)
        with torch.no_grad():
            got = par.sharded_decode_step(placed, mesh, tokens, placed.init_cache(cfg, 4, 16),
                                          positions)[0]
            want = m(tokens, m.init_cache(cfg, 4, 16), positions)[0]
            for blk in m.blocks:
                blk.moe.capacity_factor = 16.0
            ample = m(tokens, m.init_cache(cfg, 4, 16), positions)[0]
        out[name] = (got, want, ample)
    return out


def _step_inputs(cfg, b, t):
    tokens = torch.from_numpy((np.arange(b * t).reshape(b, t) % cfg.vocab_size).astype(np.int32))
    positions = torch.arange(t, dtype=torch.int32)[None].expand(b, t).contiguous()
    return tokens, positions


GROUPS = {
    "w2": (_port_mesh_and_sharding, _port_tp, _port_ep, _port_sequence, _port_pipeline,
           _port_ep_modes),
    "w4": (_port_tp, _port_ep, _port_sequence, _port_pipeline, _port_sharded_step),
}


def rank_main(groups, argv) -> None:
    """One rank of a spawned group: join the gloo group, run the group's
    scenarios in order, save their results to DIR/GROUP_RANK.pt."""
    group, world, rank, port, outdir = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from fused4bit_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type="cpu",
                         timeout=datetime.timedelta(seconds=120))
    results = {fn.__name__: fn(world, outdir) for fn in groups[group]}
    torch.save(results, os.path.join(outdir, f"{group}_{rank}.pt"))
    dist.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


# --- the test process ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Spawn:
    """``world`` ranks of ``script`` running ``group``, started now; their
    results are read (and their exit checked) at the first :meth:`rank`."""

    def __init__(self, script, group, world, outdir, timeout=240):
        self.group, self.world, self.outdir, self.timeout = group, world, str(outdir), timeout
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(os.path.abspath(script))), env.get("PYTHONPATH", "")])
        port = str(_free_port())
        self.procs = [subprocess.Popen([sys.executable, script, group, str(world), str(r), port,
                                        self.outdir], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True, env=env)
                      for r in range(world)]
        self._results = None

    def rank(self, r):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=self.timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for i, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"RANK_OK {i}" in out, \
                    f"{self.group} rank {i} failed:\n{out[-4000:]}"
            self._results = [torch.load(os.path.join(self.outdir, f"{self.group}_{i}.pt"))
                             for i in range(self.world)]
        return self._results[r]

    def all(self, scenario, key):
        return [self.rank(r)[scenario][key] for r in range(self.world)]


def same_on_every_rank(values):
    for v in values[1:]:
        assert torch.equal(v, values[0])
    return values[0]


if __name__ == "__main__":
    rank_main(GROUPS, sys.argv)
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fused4bit_tpu.layers.kv_cache import QuantizedKVCache as JaxKVCache  # noqa: E402
from fused4bit_tpu.layers.moe import QuantizedMoE, topk_route  # noqa: E402
from fused4bit_tpu.models.config import flagship_model_config  # noqa: E402
from fused4bit_tpu.models.transformer import QuantizedTransformer as JaxTransformer  # noqa: E402
from fused4bit_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul  # noqa: E402
from fused4bit_tpu.parallel import expert_parallel as jep  # noqa: E402
from fused4bit_tpu.parallel import sequence as jseq  # noqa: E402
from fused4bit_tpu.parallel.mesh import best_mesh_shape as jax_best_mesh_shape  # noqa: E402
from fused4bit_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from fused4bit_tpu.parallel.pipeline import pipeline_stages, stack_stage_params  # noqa: E402
from fused4bit_tpu.parallel.sharded_model import place_model, sharded_decode_step  # noqa: E402
from fused4bit_tpu.parallel.sharding import shard_qt_experts, shard_qt_out_dim  # noqa: E402
from fused4bit_tpu.quant import QuantizedTensor as JaxQT  # noqa: E402
from fused4bit_tpu.quant import quantize as jax_quantize  # noqa: E402
from fused4bit_tpu_torch.models import model_from_jax  # noqa: E402
from fused4bit_tpu_torch.parallel import best_mesh_shape  # noqa: E402
from fused4bit_tpu_torch.utils import checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX `tiny` model and the port's copy of its bytes, saved where the
    ranks read it."""
    cfg = flagship_model_config("tiny")
    jmodel = jax.jit(lambda key: JaxTransformer.init(key, cfg))(jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(jmodel)
    params = {jax.tree_util.keystr(p): np.asarray(a) for p, a in leaves}
    path = tmp_path_factory.mktemp("tiny_model")
    checkpoint.save(str(path / "tiny"), model_from_jax(params, cfg, device="cpu"))
    return cfg, jmodel, path


@pytest.fixture(scope="module")
def ranks(tiny):
    """Both groups' ranks, started at once; the JAX side runs meanwhile."""
    script = os.path.abspath(__file__)
    return {"w2": Spawn(script, "w2", 2, tiny[2]), "w4": Spawn(script, "w4", 4, tiny[2])}


def jmesh(names, shape):
    return jax_make_mesh(names, shape, devices=jax.devices()[:int(np.prod(shape))])


def jit_exact(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision, so that bf16
    rounds after every op, as it does in eager JAX and in the port."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def jqt(w, per_group=False):
    if per_group:
        return jax_quantize(jnp.asarray(w), granularity="per_group", group_size=128,
                            layout="planar_groups")
    return jax_quantize(jnp.asarray(w), layout="planar")


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def cat(results, dim=0):
    return torch.cat(results, dim=dim)


# --- mesh and sharding ---------------------------------------------------------------


def test_best_mesh_shape_matches_jax():
    for n in (2, 3, 4, 6, 7, 8, 12, 13, 16, 24, 32, 64, 128, 256):
        for ax in (1, 2, 3):
            assert best_mesh_shape(n, ax) == jax_best_mesh_shape(n, ax)


def test_initialize_without_configuration_is_single_process(monkeypatch):
    from fused4bit_tpu_torch.parallel import make_mesh, multihost

    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not multihost.is_multihost() and not torch.distributed.is_initialized()
    assert multihost.local_device_slice(1) == slice(0, 1)
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()


def test_replicate_keeps_every_tensor_whole(ranks):
    w, _ = _linear_case()
    want = _port_quantize(w)
    for packed, shape, x in ranks["w2"].all("_port_mesh_and_sharding", "replicate"):
        assert torch.equal(packed, want.packed) and shape == want.shape
        assert torch.equal(x, torch.arange(4))


def test_initialize_is_idempotent_on_every_rank(ranks):
    # a second call on a joined rank: True, the group kept
    assert ranks["w2"].all("_port_mesh_and_sharding", "multihost") == [(True, True, True)] * 2


def test_make_mesh(ranks):
    # with no shape every rank goes to `expert`, as in JAX
    assert ranks["w2"].all("_port_mesh_and_sharding", "default") == [(1, 2, 1)] * 2
    assert ranks["w2"].all("_port_mesh_and_sharding", "bad_shape") == [True] * 2


@pytest.mark.parametrize("name", ["out_row", "out_group", "exp_row", "exp_group"])
def test_sharding_slices_equal_jax_shards_byte_for_byte(ranks, name):
    w, _ = _linear_case()
    rng = np.random.default_rng(3)
    wg = rng.standard_normal((96, 512)).astype(np.float32)
    we, _, _ = _ep_case(0, k=512)
    if name.startswith("out"):
        mesh = jmesh(("model",), (2,))
        qt = jqt(w) if name == "out_row" else jax_quantize(
            jnp.asarray(wg), granularity="per_group", group_size=128, layout="planar")
        placed = shard_qt_out_dim(qt, mesh, "model")
    else:
        mesh = jmesh(("expert",), (2,))
        placed = shard_qt_experts(jqt(we, name == "exp_group"), mesh, "expert")
    for r in range(2):
        packed, scales, zps, shape = ranks["w2"].rank(r)["_port_mesh_and_sharding"][name]
        for got, arr in ((packed, placed.packed), (scales, placed.scales),
                         (zps, placed.zero_points)):
            want = next(s.data for s in arr.addressable_shards if s.device == mesh.devices.flat[r])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want_shape = list(placed.shape)
        want_shape[0] //= 2
        assert list(shape) == want_shape


# --- tensor and expert parallelism ----------------------------------------------------


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_tp_int4_matmul_matches_jax(ranks, group):
    world = int(group[1])
    w, x = _linear_case()
    mesh = jmesh(("model",), (world,))
    qts = shard_qt_out_dim(jqt(w), mesh, "model")
    fn = jax.jit(functools.partial(jep.tp_int4_matmul, mesh=mesh, axis="model", interpret=True))
    want = fn(jnp.asarray(x), qts)
    gathered = same_on_every_rank(ranks[group].all("_port_tp", "gathered"))
    close(gathered, want, atol=1e-3)
    sharded = ranks[group].all("_port_tp", "sharded")
    assert sharded[0].shape == (4, 256 // world)
    assert torch.equal(cat(sharded, dim=1), gathered)


def _jax_ep(fn, world, **kw):
    mesh = jmesh(("expert",), (world,))
    return mesh, jax.jit(functools.partial(fn, mesh=mesh, top_k=TOPK, tile_m=TILE_M,
                                           interpret=True, **kw))


@pytest.mark.parametrize("group", ["w2", "w4"])
@pytest.mark.parametrize("name", ["replicated", "replicated_pg"])
def test_moe_ep_replicated_matches_jax(ranks, group, name):
    world = int(group[1])
    pg = name.endswith("pg")
    w, x, logits = _ep_case(0, k=512 if pg else K)
    mesh, fn = _jax_ep(jep.moe_ep_replicated, world)
    want = fn(jnp.asarray(x), jnp.asarray(logits), shard_qt_experts(jqt(w, pg), mesh))
    got = same_on_every_rank(ranks[group].all("_port_ep", name))
    close(got, want, atol=2e-3 if pg else 1e-3)


@pytest.mark.parametrize("group", ["w2", "w4"])
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("cf", [16.0, 0.25])
def test_moe_ep_a2a_matches_jax_with_the_same_drops(ranks, group, skewed, cf):
    world = int(group[1])
    w, x, logits = _ep_case(0, skewed=skewed)
    mesh, fn = _jax_ep(jep.moe_ep_a2a, world, capacity_factor=cf)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(logits), shard_qt_experts(jqt(w), mesh)))
    got = cat(ranks[group].all("_port_ep", f"a2a_{cf}{'_skewed' if skewed else ''}"))
    # a dropped pair moves its token's row by a whole expert output: the
    # tokens that lose a pair are the same, exactly
    golden = _golden_moe(skewed)
    dropped = np.abs(want - golden).max(axis=1) > 1e-2
    assert np.array_equal(np.abs(got.numpy() - golden).max(axis=1) > 1e-2, dropped)
    if cf > 1.0:
        assert not dropped.any()
    if skewed and cf < 1.0 and world == 2:   # 16 pairs a rank to one destination of 8 slots
        assert dropped.any()
    close(got, want, atol=1e-3)


@functools.lru_cache(maxsize=None)
def _golden_moe(skewed):
    w, x, logits = _ep_case(0, skewed=skewed)
    golden = jax.jit(lambda qt, x, lg: QuantizedMoE(weight=qt)(x, topk_route(lg, TOPK, E)))
    return np.asarray(golden(jqt(w), jnp.asarray(x), jnp.asarray(logits)))


@pytest.mark.parametrize("group", ["w2", "w4"])
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("strategy", ["dropless", "ring"])
def test_dropless_strategies_match_jax(ranks, group, skewed, strategy):
    world = int(group[1])
    w, x, logits = _ep_case(0, skewed=skewed)
    jfn = {"dropless": jep.moe_ep_a2a_dropless, "ring": jep.moe_ep_ring}[strategy]
    mesh, fn = _jax_ep(jfn, world)
    want = fn(jnp.asarray(x), jnp.asarray(logits), shard_qt_experts(jqt(w), mesh))
    got = cat(ranks[group].all("_port_ep", f"{strategy}{'_skewed' if skewed else ''}"))
    close(got, want, atol=1e-3)
    if strategy == "dropless" and skewed:
        assert torch.equal(cat(ranks[group].all("_port_ep", "dropless_bound")), got)
        assert ranks[group].all("_port_ep", "dropless_short") == [True] * world


@pytest.mark.parametrize("mode", EP_MODES)
def test_ep_block_equals_the_whole_block_in_every_moe_path(ranks, mode):
    # top-2 over 2 ranks: each token's two weighted rows meet in one sum
    # either way, so the split changes no bit; the capacity paths keep and
    # drop the same pairs as the whole block
    for got, want, ample in ranks["w2"].all("_port_ep_modes", mode):
        assert torch.equal(got, want)
        assert torch.equal(want, ample) == (mode in ("grouped", "per_group"))


# --- sequence parallelism ------------------------------------------------------------


def _jax_attn(fn, world, *arrays, **kw):
    mesh = jmesh(("seq",), (world,))
    return jax.jit(functools.partial(fn, mesh=mesh, **kw))(*arrays)


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_ring_attention_matches_jax(ranks, group):
    world = int(group[1])
    res = [ranks[group].rank(r)["_port_sequence"] for r in range(world)]
    for hkv in (4, 2, 1):
        q, k, v = _attn_case(hkv, 2, 4, hkv, 32, 16)
        want = _jax_attn(jseq.ring_attention, world, q, k, v)
        close(cat([r[f"ring_hkv{hkv}"] for r in res], 2), want, atol=1e-5, rtol=1e-4)
    q, k, v = _attn_case(5, 1, 2, 2, 32, 8)
    want = _jax_attn(jseq.ring_attention, world, q, k, v, causal=False)
    close(cat([r["ring_noncausal"] for r in res], 2), want, atol=1e-5, rtol=1e-4)
    assert torch.equal(cat([r["alias"] for r in res], 2), cat([r["ring_noncausal"] for r in res], 2))
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _attn_case(6, 1, 2, 2, 32, 16))
    want = np.asarray(_jax_attn(jseq.ring_attention, world, q, k, v).astype(jnp.float32))
    got = cat([r["ring_bf16"] for r in res], 2)
    assert got.dtype == torch.bfloat16
    assert np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want) < 2e-2


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_ring_attention_quantized_matches_jax(ranks, group):
    world = int(group[1])
    res = [ranks[group].rank(r)["_port_sequence"] for r in range(world)]
    q, k, v = _attn_case(7, 2, 4, 2, 32, 16)
    cache = jax.jit(lambda k, v: JaxKVCache.init(2, 2, 32, 16).append(k, v))(jnp.asarray(k),
                                                                             jnp.asarray(v))
    cache = dataclasses.replace(cache, lengths=jnp.asarray([8, 32], jnp.int32))
    want = _jax_attn(jseq.ring_attention_quantized, world, jnp.asarray(q), cache)
    got = cat([r["quantized"] for r in res], 2)
    close(got, want, atol=1e-4, rtol=1e-4)
    poisoned = cat([r["quantized_poisoned"] for r in res], 2)
    np.testing.assert_allclose(poisoned[0, :, :8].numpy(), got[0, :, :8].numpy(), rtol=1e-5)


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_ulysses_attention_matches_jax(ranks, group):
    world = int(group[1])
    res = [ranks[group].rank(r)["_port_sequence"] for r in range(world)]
    hq = 4 * world
    for name, args in (("ulysses", (8, 2, hq, world, 32, 8)),
                       ("ulysses_gqa", (9, 1, hq, 2 * world, 32, 8))):
        want = _jax_attn(jseq.ulysses_attention, world, *_attn_case(*args))
        close(cat([r[name] for r in res], 2), want, atol=1e-5, rtol=1e-4)
    assert all(r["raises"] == (True, True, True, True) for r in res)


# --- pipeline ------------------------------------------------------------------------


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_pipeline_stages_matches_jax(ranks, group):
    world = int(group[1])
    ws, x = _pipe_case(world)
    qts = [jqt(w) for w in ws]
    params = stack_stage_params([dict(packed=q.packed, scales=q.scales, zps=q.zero_points)
                                 for q in qts])
    meta = qts[0]

    def stage_fn(p, act):
        q = JaxQT(packed=p["packed"], scales=p["scales"], zero_points=p["zps"], shape=meta.shape,
                  granularity=meta.granularity, layout=meta.layout, block_k=meta.block_k,
                  group_size=meta.group_size, bits=meta.bits)
        return jnp.tanh(jax_int4_matmul(act, q, interpret=True))

    mesh = jmesh(("stage",), (world,))
    want = jax.jit(lambda p, a: pipeline_stages(stage_fn, p, a, mesh))(
        params, jnp.asarray(x).astype(jnp.bfloat16))
    got = same_on_every_rank(ranks[group].all("_port_pipeline", "out"))
    close(got, want.astype(jnp.float32), atol=2e-2, rtol=2e-2)


# --- the sharded decode step -----------------------------------------------------------


def test_sharded_decode_step_matches_jax(ranks, tiny):
    cfg, jmodel, _ = tiny
    mesh = jmesh(("data", "expert"), (2, 2))
    b, t = 4, 3
    tokens, positions = _step_inputs(cfg, b, t)
    want, jcaches = jit_exact(
        lambda m, tok, c, pos: sharded_decode_step(m, mesh, tok, c, pos, interpret=True),
        place_model(jmodel, mesh), jnp.asarray(tokens.numpy()),
        jmodel.init_cache(cfg, b, max_seq=8), jnp.asarray(positions.numpy()))
    got = same_on_every_rank(ranks["w4"].all("_port_sharded_step", "logits"))
    assert got.shape == want.shape == (b, t, cfg.vocab_size)
    close(got, want.astype(jnp.float32), atol=5e-2, rtol=5e-2)
    assert ranks["w4"].all("_port_sharded_step", "e_local") == [cfg.moe.num_experts // 2] * 4
    for lengths in ranks["w4"].all("_port_sharded_step", "lengths"):
        assert lengths.tolist() == [t, t] == np.asarray(jcaches[0].lengths)[:2].tolist()
