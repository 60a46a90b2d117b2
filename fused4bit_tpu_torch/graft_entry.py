"""The port's graft entry points: the counterpart of ``__graft_entry__.py``
at the repository's root.

* :func:`entry` returns ``(fn, args)``: one decode step of the `tiny`
  flagship model (the INT4 linears on K1, the experts on K2, attention over
  the INT4 KV cache on K3).
* :func:`dryrun_multichip` runs the parallel layer over ``n`` ranks, one
  process each (NCCL on the cards, gloo on the CPU), in the nine parts of
  the JAX function, each against a single-device golden at JAX's own bar,
  and returns each rank's report (:func:`dryrun_parts`).

Where the port parts from JAX:

* The `tiny` model is drawn from a ``torch.Generator`` seeded 0 on the CPU
  and moved to the device, so every device holds the same weights (JAX's
  ``PRNGKey(0)`` draws other numbers).
* Ranks are processes: the a2a, dropless and ring EP functions take the
  rank's ``T / n`` token rows, so the parts slice ``x`` and the router
  logits by rank and gather the outputs in rank order before comparing.
* Part 8 draws its stage weights and input from the numpy generator, after
  the arrays of part 9 (JAX: ``jax.random`` keys 3 and 4), so parts 1, 2,
  4, 6 and 9 see JAX's inputs exactly.
* At ``n = 1`` JAX's EP geometry (E = n experts, top-2) has fewer experts
  than the top-k, and JAX's own function fails in part 1 (``top_k``); the
  port takes E = 2 there, both on the one rank. From ``n = 2`` on E = n.
* Ulysses attention runs on a 2-rank `seq` axis as in JAX; the mesh pairs
  the ranks (0, 1), (2, 3), ..., each pair on the same inputs, so ranks 0
  and 1 form JAX's ``devs[:2]`` group. At ``n = 1`` the group is the one
  rank.
* Part 2 also holds the gathered product to the single-device
  ``int4_matmul`` at the EP bar, and part 3 holds the sharded step to the
  whole model's forward (bit for bit when the batch is not split), where
  JAX checks shapes only.
* :func:`dryrun_multichip` returns the ranks' reports; JAX's returns None.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import ops
from . import parallel as par
from ._device import resolve_device
from .layers import QuantizedMoE, topk_route
from .models import QuantizedTransformer, flagship_model_config
from .ops import _build
from .parallel import multihost
from .quant import QuantizedTensor, quantize
from .quant.reference import full_precision
from .serving import GenerationRequest, ServingEngine

__all__ = ["decode_step", "entry", "dryrun_multichip", "dryrun_parts"]

# JAX's bars (``__graft_entry__.py``): max|d| below them
EP_BAR = 1e-2
PIPELINE_BAR = 5e-2
SP_BAR = 1e-3
# the sharded step against the whole forward when the batch is split over
# `data` (K1 at another row count): the model bar of the port's CPU tests
MODEL_REL_TOL = 2e-2
# how long a rank may run, and a collective wait for its peers
RANK_TIMEOUT = datetime.timedelta(seconds=600)
# the EP parts split T token rows over the ranks
EP_TOKENS = 16


def decode_step(model: QuantizedTransformer, tokens: torch.Tensor, caches,
                positions: torch.Tensor) -> torch.Tensor:
    """The logits [B, T, V] of one forward step, as JAX's ``entry`` fn
    returns them. The caches update in place, as every port forward does;
    a step at the same positions writes the same entries, so a repeated
    call gives the same logits."""
    with torch.no_grad():
        return model(tokens, caches, positions)[0]


def _tiny_model(device: torch.device):
    cfg = flagship_model_config("tiny")
    model = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    return cfg, model.to(device)


def entry(device=None):
    """``(fn, (tokens, caches, positions))``: one decode step of the `tiny`
    flagship model at batch 2, caches of 32 positions, tokens and positions
    ``zeros((2, 1))`` int32; ``fn`` is ``functools.partial(decode_step,
    model)``. ``device``: None for the CUDA card (raises ``RuntimeError``
    without one), ``"cpu"`` for the plain versions."""
    device = resolve_device(device)
    cfg, model = _tiny_model(device)
    caches = model.init_cache(cfg, batch=2, max_seq=32)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device=device)
    positions = torch.zeros((2, 1), dtype=torch.int32, device=device)
    return functools.partial(decode_step, model), (tokens, caches, positions)


# --- one rank -----------------------------------------------------------------


def _dense_causal(q, k, v):
    """Dense causal attention in f32, K/V heads repeated to the query heads."""
    rep = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    t = q.shape[2]
    pos = torch.arange(t, device=q.device)
    with full_precision():
        s = torch.einsum("bhid,bhjd->bhij", q, kr) / (q.shape[-1] ** 0.5)
        s = torch.where((pos[None, :] <= pos[:, None])[None, None], s, -1e30)
        return torch.einsum("bhij,bhjd->bhid", torch.softmax(s, dim=-1), vr)


class _Rank:
    """One rank's report: each check's max|d| beside its bar, each part's
    seconds, and the kernel launches of the path (the goldens' apart)."""

    def __init__(self, device: torch.device):
        self.rank = dist.get_rank()
        self.report = {"rank": self.rank, "world": dist.get_world_size(), "device": str(device),
                       "backend": str(dist.get_backend()), "checks": [], "seconds": {},
                       "tokens": {}, "outputs": {}}
        self._golden = dict.fromkeys(ops.launch_counts(), 0)
        self._golden_plain = 0

    @contextlib.contextmanager
    def part(self, number: int, name: str):
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:
            e.add_note(f"dryrun_multichip: part {number} ({name}) on rank {self.rank}")
            raise
        self.report["seconds"][f"{number} {name}"] = time.perf_counter() - t0

    @contextlib.contextmanager
    def golden(self):
        """Launches inside the block are the goldens', not the path's."""
        before, plain = ops.launch_counts(), ops.plain_calls()
        yield
        for k, v in ops.launch_counts().items():
            self._golden[k] += v - before[k]
        self._golden_plain += ops.plain_calls() - plain

    def check(self, number: int, name: str, got: torch.Tensor, want: torch.Tensor,
              bar: Optional[float]):
        """max|got - want| below ``bar``, or bit for bit where ``bar`` is None."""
        d = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        self.report["checks"].append(dict(part=number, name=name, max_abs_diff=d, bar=bar))
        ok = d is not None and bool(torch.isfinite(got).all()) and (
            torch.equal(got, want) if bar is None else d < bar)
        if not ok:
            raise AssertionError(f"part {number} ({name}) on rank {self.rank}: shape "
                                 f"{tuple(got.shape)} vs {tuple(want.shape)}, max|d| {d} "
                                 f"{'not bit for bit' if bar is None else f'not below {bar}'}")

    def served(self, number: int, name: str, out: dict, uids: int, tokens: int):
        """Every uid served, ``tokens`` tokens each."""
        self.report["checks"].append(dict(part=number, name=name, max_abs_diff=None, bar=None,
                                          requests=uids, tokens_each=tokens))
        self.report["tokens"][name] = {uid: list(v) for uid, v in out.items()}
        if set(out) != set(range(uids)) or any(len(v) != tokens for v in out.values()):
            raise AssertionError(f"part {number} ({name}) on rank {self.rank}: served "
                                 f"{ {uid: len(v) for uid, v in out.items()} }, want uids "
                                 f"0-{uids - 1} with {tokens} tokens each")

    def finish(self, t0: float) -> dict:
        counts = ops.launch_counts()
        self.report["launches"] = {k: v - self._golden[k] for k, v in counts.items()}
        self.report["plain_calls"] = ops.plain_calls() - self._golden_plain
        self.report["total_seconds"] = time.perf_counter() - t0
        return self.report


def _check_world(n: int) -> None:
    if n < 1 or EP_TOKENS % n:
        raise ValueError(f"n_devices={n}: the EP parts split T={EP_TOKENS} token rows over the "
                         f"ranks, so n must divide {EP_TOKENS}")


def dryrun_parts(device_type: str = "cuda") -> dict:
    """This rank's share of :func:`dryrun_multichip`: the nine parts over
    every rank of the process group (:func:`~.parallel.multihost.initialize`
    first; ``device_type`` "cuda" with NCCL or "cpu" with gloo). Raises,
    naming the part and the rank, where a part fails or a check is beyond
    its bar; returns the rank's report: ``checks`` (part, name, max|d|,
    bar), ``seconds`` per part, ``launches`` (the path's kernel launches by
    name, the goldens' apart), ``plain_calls``, the served ``tokens`` and
    the gathered ``outputs`` of parts 1, 4, 6 and 9."""
    t0 = time.perf_counter()
    n = dist.get_world_size()
    _check_world(n)
    rng = np.random.default_rng(0)
    top_k, k, nn, t = 2, 128, 128, EP_TOKENS
    e = max(n, top_k)
    w = rng.standard_normal((e, nn, k)).astype(np.float32)
    x_np = rng.standard_normal((t, k)).astype(np.float32)
    logits_np = rng.standard_normal((t, e)).astype(np.float32)
    wl = rng.standard_normal((nn * n // 2, k)).astype(np.float32)
    bq, hq, hkv, tq, dh = 2, 4, 2, 8 * n, 16
    qkv_np = [rng.standard_normal(s).astype(np.float32)
              for s in ((bq, hq, tq, dh), (bq, hkv, tq, dh), (bq, hkv, tq, dh))]
    h = 128
    w_pp = [(rng.standard_normal((h, h)) * h ** -0.5).astype(np.float32) for _ in range(n)]
    x_pp_np = rng.standard_normal((3, 8, h)).astype(np.float32)

    ops.reset_counts()
    mesh_e = par.make_mesh(("expert",), (n,), device_type=device_type)
    dev = par.mesh.local_device(mesh_e)
    r = _Rank(dev)
    rows = functools.partial(par.shard_tensor, mesh=mesh_e, spec=par.Shard("expert", 0))

    def gathered(y):
        return par.mesh.all_gather_dim(y, mesh_e, "expert", 0)

    x = torch.from_numpy(x_np).to(dev)
    logits = torch.from_numpy(logits_np).to(dev)
    qt_whole = quantize(torch.from_numpy(w), layout="planar")
    qt = par.shard_qt_experts(qt_whole, mesh_e, "expert")
    kw = dict(top_k=top_k, tile_m=8)
    with torch.no_grad():
        with r.part(1, "EP replicated and a2a"):
            with r.golden():
                golden = QuantizedMoE(par.replicate(qt_whole, mesh_e))(
                    x, topk_route(logits, top_k, e))
            rep = par.moe_ep_replicated(x, logits, qt, mesh_e, **kw)
            a2a = gathered(par.moe_ep_a2a(rows(x), rows(logits), qt, mesh_e,
                                          capacity_factor=8.0, **kw))
            r.check(1, "moe_ep_replicated", rep, golden, EP_BAR)
            r.check(1, "moe_ep_a2a", a2a, golden, EP_BAR)
            r.report["outputs"].update(ep_replicated=rep.cpu(), ep_a2a=a2a.cpu())

        with r.part(2, "TP"):
            mesh_m = par.make_mesh(("model",), (n,), device_type=device_type)
            qtl_whole = quantize(torch.from_numpy(wl), layout="planar")
            y = par.tp_int4_matmul(x, par.shard_qt_out_dim(qtl_whole, mesh_m, "model"), mesh_m,
                                   axis="model")
            with r.golden():
                want = ops.int4_matmul(x, par.replicate(qtl_whole, mesh_m))
            r.check(2, "tp_int4_matmul", y, want, EP_BAR)

        with r.part(3, "DP x EP sharded step"):
            cfg, model = _tiny_model(dev)
            ep = min(cfg.moe.num_experts, n)
            dp = n // ep
            mesh = par.make_mesh(("data", "expert"), (dp, ep), device_type=device_type)
            placed = par.place_model(model, mesh)
            b = 2 * dp
            tokens = torch.zeros((b // dp, 1), dtype=torch.int32, device=dev)
            caches = placed.init_cache(cfg, b // dp, 16)
            whole_caches = model.init_cache(cfg, b, 16)
            for step in range(2):   # the second step proves the caches advanced
                positions = torch.full((b // dp, 1), step, dtype=torch.int32, device=dev)
                got, caches = par.sharded_decode_step(placed, mesh, tokens, caches, positions)
                with r.golden():
                    want, whole_caches = model(torch.zeros((b, 1), dtype=torch.int32, device=dev),
                                               whole_caches, positions[:1].expand(b, 1))
                bar = None if dp == 1 else MODEL_REL_TOL * want.float().abs().max().item()
                r.check(3, f"sharded_decode_step {step} vs forward", got, want, bar)

        with r.part(4, "dropless a2a EP"):
            dl = gathered(par.moe_ep_a2a_dropless(rows(x), rows(logits), qt, mesh_e, **kw))
            r.check(4, "moe_ep_a2a_dropless", dl, golden, EP_BAR)
            r.report["outputs"]["ep_dropless"] = dl.cpu()

        with r.part(5, "mesh engine"):
            eng = ServingEngine(placed, cfg, num_slots=b, max_seq=24, prefill_bucket=4,
                                mesh=mesh)
            for uid in range(b + 1):   # one request more than slots: a slot is recycled
                eng.submit(GenerationRequest(uid=uid, prompt=[1 + uid, 2, 3, 4, 5, 6],
                                             max_new_tokens=2))
            r.served(5, "mesh engine", eng.run(), b + 1, 2)

        with r.part(6, "ring EP"):
            ring = gathered(par.moe_ep_ring(rows(x), rows(logits), qt, mesh_e, **kw))
            r.check(6, "moe_ep_ring", ring, golden, EP_BAR)
            r.report["outputs"]["ep_ring"] = ring.cpu()

        with r.part(7, "mesh engine at decode_block=3"):
            eng = ServingEngine(placed, cfg, num_slots=b, max_seq=24, prefill_bucket=4,
                                mesh=mesh, decode_block=3)
            for uid in range(b):
                eng.submit(GenerationRequest(uid=uid, prompt=[2 + uid, 3, 4], max_new_tokens=5))
            r.served(7, "mesh engine at decode_block=3", eng.run(), b, 5)

        with r.part(8, "pipeline stages"):
            mesh_pp = par.make_mesh(("stage",), (n,), device_type=device_type)
            qts = [quantize(torch.from_numpy(wi), layout="planar") for wi in w_pp]
            params = par.stack_stage_params([dict(packed=q.packed, scales=q.scales,
                                                  zps=q.zero_points) for q in qts])
            local = {name: par.shard_tensor(v, mesh_pp, par.Shard("stage", 0))
                     for name, v in params.items()}
            meta = qts[0]

            def stage_fn(p, act):
                q = QuantizedTensor(p["packed"], p["scales"], p["zps"], meta.shape,
                                    granularity=meta.granularity, layout=meta.layout,
                                    block_k=meta.block_k, group_size=meta.group_size,
                                    bits=meta.bits)
                return torch.tanh(ops.int4_matmul(act, q))

            x_pp = torch.from_numpy(x_pp_np).to(dev).bfloat16()
            got = par.pipeline_stages(stage_fn, local, x_pp, mesh_pp)
            with r.golden():
                want = x_pp
                for q in par.replicate(qts, mesh_pp):
                    want = torch.tanh(ops.int4_matmul(want.reshape(-1, h), q)).reshape(3, 8, h)
            r.check(8, "pipeline_stages", got.float(), want.float(), PIPELINE_BAR)

        with r.part(9, "ring and Ulysses attention"):
            q, kk, v = (torch.from_numpy(a).to(dev) for a in qkv_np)
            mesh_sp = par.make_mesh(("seq",), (n,), device_type=device_type)
            sp = [par.shard_sequence(a, mesh_sp) for a in (q, kk, v)]
            ring_out = par.mesh.all_gather_dim(par.ring_attention(*sp, mesh_sp), mesh_sp, "seq", 2)
            r.check(9, "ring_attention", ring_out, _dense_causal(q, kk, v), SP_BAR)
            mesh_ul = mesh_sp if n == 1 else par.make_mesh(("pair", "seq"), (n // 2, 2),
                                                           device_type=device_type)
            qu, ku, vu = (a[:, :, :tq // 4] for a in (q, kk, v))
            ul = par.ulysses_attention(*(par.shard_sequence(a, mesh_ul) for a in (qu, ku, vu)),
                                       mesh_ul)
            ul = par.mesh.all_gather_dim(ul, mesh_ul, "seq", 2)
            r.check(9, "ulysses_attention", ul, _dense_causal(qu, ku, vu), SP_BAR)
            r.report["outputs"].update(sp_ring=ring_out.cpu(), sp_ulysses=ul.cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
    report = r.finish(t0)
    if dev.type == "cuda":
        missing = [name for name in ("int4_matmul", "grouped_int4_matmul", "int4_attention")
                   if not report["launches"][name]]
        if missing or report["plain_calls"]:
            raise AssertionError(f"dryrun_multichip on rank {r.rank}: never launched {missing}, "
                                 f"{report['plain_calls']} plain-version calls on the card")
    return report


def _rank_main(argv) -> None:
    """One rank: ``python -m fused4bit_tpu_torch.graft_entry WORLD RANK PORT
    DEVICE_TYPE OUTDIR``; the report goes to OUTDIR/rank<RANK>.pt."""
    world, rank, port, device_type, outdir = (int(argv[1]), int(argv[2]), int(argv[3]),
                                              argv[4], argv[5])
    if device_type == "cpu":
        torch.set_num_threads(1)   # n ranks share the host's cores
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device_type=device_type,
                         timeout=RANK_TIMEOUT)
    try:
        report = dryrun_parts(device_type)
    finally:
        dist.destroy_process_group()
    torch.save(report, os.path.join(outdir, f"rank{rank}.pt"))


# --- the ranks, from the calling process ----------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def dryrun_multichip(n_devices: int, device=None) -> List[dict]:
    """Run the nine parts of the parallel layer over ``n_devices`` ranks,
    one process each, and return each rank's report (:func:`dryrun_parts`).

    ``device``: None for the CUDA cards, rank i on card i over NCCL (raises
    ``RuntimeError`` without a card, or with fewer cards than
    ``n_devices``: NCCL takes one rank per card); ``"cpu"`` for gloo ranks
    on the CPU. ``n_devices`` must divide 16. Raises ``RuntimeError`` when
    a rank fails (a part beyond its bar, a dead peer, a rank past
    ``RANK_TIMEOUT``), with the failing ranks' output, which names the part
    and the rank, or when the ranks served different tokens."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if n_devices > have:
            raise RuntimeError(f"need {n_devices} devices, have {have}")
        _build.library()   # built once here; the ranks load it
    elif dev.type != "cpu":
        raise ValueError(f"device={device!r} is not 'cuda' or 'cpu'")
    _check_world(n_devices)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="f4b_dryrun_") as outdir:
        port = str(_free_port())
        procs, logs = [], []
        try:
            for rank in range(n_devices):
                env = dict(os.environ, LOCAL_RANK=str(rank),
                           PYTHONPATH=os.pathsep.join(
                               [root] + ([os.environ["PYTHONPATH"]]
                                         if os.environ.get("PYTHONPATH") else [])))
                logs.append(os.path.join(outdir, f"rank{rank}.log"))
                with open(logs[-1], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "fused4bit_tpu_torch.graft_entry",
                         str(n_devices), str(rank), port, dev.type, outdir],
                        stdout=log, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + RANK_TIMEOUT.total_seconds() + 60
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if None not in codes:
                    break
                if any(codes):   # a rank failed: its peers get 10 s to end too
                    deadline = min(deadline, time.monotonic() + 10)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [rank for rank, p in enumerate(procs) if p.returncode]
        if failed:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): ranks {failed} failed\n" + "\n".join(
                    f"--- rank {rank} (exit {procs[rank].returncode}):\n{_tail(logs[rank])}"
                    for rank in failed))
        reports = [torch.load(os.path.join(outdir, f"rank{rank}.pt"), weights_only=True)
                   for rank in range(n_devices)]
    for rank, rep in enumerate(reports[1:], 1):
        if rep["tokens"] != reports[0]["tokens"]:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank {rank} served other "
                               f"tokens than rank 0: {rep['tokens']} vs {reports[0]['tokens']}")
    return reports


if __name__ == "__main__":
    _rank_main(sys.argv)
