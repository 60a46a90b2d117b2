"""The body each op call runs, as one table: ``int4_matmul._body`` for the
linears (K1, K4-K8) and ``grouped_matmul._body`` for the experts (K2, K9-K14),
with ``_mma._tile_rows`` for the tensor-core body's decode or tall tile.

One row per call of each benchmark cell, one per edge of a choice (64 and 65
rows; 23 and 24 rows an expert; N off whole slices of 128; the group sizes;
f32; the planar layout; the CPU; K1's row threshold, ``PREFILL_THRESHOLD``
and one row above it), and the rows that pin
the warpgroup body's choice at the port's expert counts. The choice reads the
call's kernel, device, type, group size, rows (T_pad, E and tile_m for the
experts), N and K: never the tile map's contents or the routing, so a CUDA
graph replays the body its capture chose.
"""
import importlib
import inspect

import pytest
import torch

from fused4bit_tpu_torch.ops import _mma
from fused4bit_tpu_torch.ops import grouped_matmul as gm

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")
BF16, F32 = torch.bfloat16, torch.float32
T = im.PREFILL_THRESHOLD
LINEAR = ("K1", "K4", "K5", "K6", "K7", "K8")
READS = {"kernel", "cuda", "dtype", "group_size", "m", "t_pad", "e", "tile_m", "n", "k",
         "prefill_threshold"}


def _t_pad(t, e, tile_m, top_k=2):
    """T_pad of a dropless dispatch of t tokens (the port's own plan)."""
    from fused4bit_tpu_torch.layers import make_dispatch_plan, topk_route

    routing = topk_route(torch.randn((t, e), generator=torch.Generator().manual_seed(t)), top_k, e)
    return make_dispatch_plan(routing, e, tile_m=tile_m).t_pad


class Tokens(tuple):
    """A grouped call's T_pad given as the dropless plan of ``t`` tokens,
    each routed to ``top_k`` experts."""


def lin(name, kernel, dtype, gs, m, n, k, want, cuda=True):
    return pytest.param(kernel, cuda, dtype, gs, m, None, None, n, k, want, id=name)


def grp(name, kernel, dtype, gs, t_pad, e, tile_m, n, k, want, cuda=True):
    return pytest.param(kernel, cuda, dtype, gs, t_pad, e, tile_m, n, k, want, id=name)


CELLS = [
    # mixtral-8x7b.offline_isl2k: 576 rows, per row; the router (N=8) off the body
    *(lin(f"8x7B K1 {n}x{k} at 576", "K1", BF16, 0, 576, n, k, want)
      for n, k, want in ((4096, 4096, "wg"), (1024, 4096, "wg"), (8, 4096, "mma tall"),
                         (32000, 4096, "wg"))),
    *(grp(f"8x7B K2 {n}x{k} at 2176/128", "K2", BF16, 0, 2176, 8, 128, n, k, "wg")
      for n, k in ((14336, 4096), (4096, 14336))),
    # mixtral-8x22b-pg128.offline_isl2k: 384 rows, per group of 128; the router per row
    *(grp(f"8x22B K13 {n}x{k} at 896/16", "K13", BF16, 128, 896, 8, 16, n, k, "wg")
      for n, k in ((16384, 6144), (6144, 16384))),
    *(lin(f"8x22B K7 {n}x{k} at 384", "K7", BF16, 128, 384, n, k, "wg")
      for n, k in ((6144, 6144), (1024, 6144), (32768, 6144))),
    lin("8x22B router K1 8x6144 at 384", "K1", BF16, 0, 384, 8, 6144, "mma tall"),
    # k-exaone-236b-ep4-pg128.offline_isl2k_hybrid: 896 rows, 32 experts held
    *(lin(f"K-EXAONE K7 {n}x{k} at 896", "K7", BF16, 128, 896, n, k, "wg")
      for n, k in ((8192, 6144), (1024, 6144), (6144, 8192), (2048, 6144), (6144, 2048),
                   (18432, 6144), (6144, 18432), (153600, 6144))),
    *(grp(f"K-EXAONE K13 {n}x{k} at 11264/128", "K13", BF16, 128, 11264, 32, 128, n, k, "wg")
      for n, k in ((2048, 6144), (6144, 2048))),
]

EDGES = [
    # the tall tile and the warpgroup body start above 64 rows
    lin("K7 at 64", "K7", BF16, 128, 64, 1024, 6144, "mma"),
    lin("K7 at 65", "K7", BF16, 128, 65, 1024, 6144, "wg"),
    lin("K1 at 64", "K1", BF16, 0, 64, 1024, 6144, "mma"),
    lin("K1 at 65", "K1", BF16, 0, 65, 1024, 6144, "wg"),
    lin("K1 router at 65", "K1", BF16, 0, 65, 8, 6144, "mma tall"),
    lin("K1 f32 at 65", "K1", F32, 0, 65, 1024, 6144, "rows"),
    lin("K6 at 64", "K6", BF16, 128, 64, 1024, 6144, "mma"),
    lin("K6 at 65", "K6", BF16, 128, 65, 1024, 6144, "mma tall"),
    lin("K5 at 64", "K5", BF16, 0, 64, 1024, 6144, "int8"),
    lin("K4 at 65", "K4", BF16, 0, 65, 1024, 6144, "int8"),
    # 23 and 24 routed rows an expert (16 experts, tile_m 16: 256 rows of padding)
    grp("K2 at 23 rows an expert", "K2", BF16, 0, 256 + 16 * 23, 16, 16, 14336, 4096, "mma"),
    grp("K2 at 24 rows an expert", "K2", BF16, 0, 256 + 16 * 24, 16, 16, 14336, 4096, "wg"),
    grp("K13 at 23 rows an expert", "K13", BF16, 128, 256 + 16 * 23, 16, 16, 16384, 6144, "mma"),
    grp("K13 at 24 rows an expert", "K13", BF16, 128, 256 + 16 * 24, 16, 16, 16384, 6144, "wg"),
    # N in no whole slices of 128, K/2 in no whole chunks of 64 bytes
    lin("K7 N=960 at 640", "K7", BF16, 128, 640, 960, 4096, "mma tall"),
    lin("K1 N=960 at 576", "K1", BF16, 0, 576, 960, 4096, "mma tall"),
    lin("K1 K=4160 at 576", "K1", BF16, 0, 576, 4096, 4160, "mma tall"),
    grp("K13 N=960 at 896/16", "K13", BF16, 128, 896, 8, 16, 960, 4096, "mma"),
    grp("K2 N=960 at 2176/128", "K2", BF16, 0, 2176, 8, 128, 960, 4096, "mma tall"),
    # K9 takes the tensor-core body at its own launch, at every row count
    grp("K9 at 2176/128", "K9", BF16, 0, 2176, 8, 128, 14336, 4096, "mma tall"),
    grp("K9 at 896/16", "K9", BF16, 0, 896, 8, 16, 14336, 4096, "mma"),
    grp("K10 at 896/32", "K10", BF16, 0, 896, 8, 32, 14336, 4096, "int8"),
    grp("K11 at 896/32", "K11", BF16, 0, 896, 8, 32, 14336, 4096, "int8"),
    # the group sizes: the tensor-core bodies at gs % 64 == 0, the int8 body at gs % 32 == 0
    *(lin(f"K7 gs {gs} at 640", "K7", BF16, gs, 640, 1024, 6144, want)
      for gs, want in ((16, "rows"), (32, "rows"), (48, "rows"), (64, "wg"), (96, "rows"),
                       (128, "wg"), (256, "wg"))),
    *(lin(f"K7 gs {gs} at 8", "K7", BF16, gs, 8, 1024, 6144, want)
      for gs, want in ((16, "rows"), (64, "mma"), (128, "mma"), (256, "mma"))),
    *(lin(f"K8 gs {gs}", "K8", BF16, gs, 8, 1024, 6144, want)
      for gs, want in ((16, "rows"), (32, "int8"), (48, "rows"), (64, "int8"), (96, "int8"),
                       (128, "int8"), (256, "int8"))),
    *(grp(f"K13 gs {gs} at 896/16", "K13", BF16, gs, 896, 8, 16, 16384, 6144, want)
      for gs, want in ((16, "rows"), (32, "rows"), (48, "rows"), (64, "wg"), (96, "rows"),
                       (128, "wg"))),
    *(grp(f"K14 gs {gs}", "K14", BF16, gs, 896, 8, 32, 16384, 6144, want)
      for gs, want in ((16, "rows"), (32, "int8"), (48, "rows"), (64, "int8"), (96, "int8"),
                       (128, "int8"))),
    # f32 activations: the CUDA-core loops, or the int8 body
    lin("K1 f32", "K1", F32, 0, 8, 1024, 6144, "rows"),
    lin("K6 f32", "K6", F32, 128, 640, 1024, 6144, "rows"),
    lin("K7 f32 at 384", "K7", F32, 128, 384, 1024, 6144, "rows"),
    lin("K7 f32 at 8", "K7", F32, 128, 8, 1024, 6144, "rows"),
    lin("K4 f32", "K4", F32, 0, 8, 1024, 6144, "int8"),
    lin("K8 f32", "K8", F32, 128, 8, 1024, 6144, "int8"),
    grp("K2 f32", "K2", F32, 0, 2176, 8, 128, 14336, 4096, "rows"),
    grp("K9 f32", "K9", F32, 0, 2176, 8, 128, 14336, 4096, "rows"),
    grp("K12 f32", "K12", F32, 128, 896, 8, 16, 16384, 6144, "rows"),
    grp("K13 f32", "K13", F32, 128, 896, 8, 16, 16384, 6144, "rows"),
    grp("K13 f32 gs 64", "K13", F32, 64, 896, 8, 16, 16384, 6144, "rows"),
    grp("K14 f32", "K14", F32, 128, 896, 8, 32, 16384, 6144, "int8"),
    # the planar layout (K6, K12) keeps the tensor-core body
    lin("K6 at 8", "K6", BF16, 128, 8, 1024, 6144, "mma"),
    lin("K6 at 640", "K6", BF16, 128, 640, 1024, 6144, "mma tall"),
    grp("K12 at 896/16", "K12", BF16, 128, 896, 8, 16, 16384, 6144, "mma"),
    grp("K12 at 2176/128", "K12", BF16, 128, 2176, 8, 128, 16384, 6144, "mma tall"),
    # the CPU runs the plain versions; K1 above its threshold the dense path first
    *(lin(f"CPU {kn}", kn, BF16, gs, 640, 1024, 6144, "plain", cuda=False)
      for kn, gs in (("K4", 0), ("K5", 0), ("K6", 128), ("K7", 128), ("K8", 128))),
    *(grp(f"CPU {kn}", kn, BF16, gs, 2176, 8, 128, 14336, 4096, "plain", cuda=False)
      for kn, gs in (("K2", 0), ("K9", 0), ("K10", 0), ("K11", 0), ("K12", 128), ("K13", 128),
                     ("K14", 128))),
    lin("CPU K1 at 512", "K1", BF16, 0, 512, 1024, 6144, "plain", cuda=False),
    lin("CPU K1 at 513", "K1", BF16, 0, 513, 1024, 6144, "plain" if T > 512 else "dense",
        cuda=False),
    lin("CPU K1 at PREFILL_THRESHOLD", "K1", BF16, 0, T, 1024, 6144, "plain", cuda=False),
    lin("CPU K1 above PREFILL_THRESHOLD", "K1", BF16, 0, T + 1, 1024, 6144, "dense", cuda=False),
    # K1's row threshold: the warpgroup body (the tall tile off whole slices)
    # up to it, on either device the dense path above it
    lin("K1 at 512", "K1", BF16, 0, 512, 1024, 6144, "wg"),
    lin("K1 at 513", "K1", BF16, 0, 513, 1024, 6144, "wg" if T > 512 else "dense"),
    lin("K1 f32 at 513", "K1", F32, 0, 513, 1024, 6144, "rows" if T > 512 else "dense"),
    lin("K1 at PREFILL_THRESHOLD", "K1", BF16, 0, T, 1024, 6144, "wg"),
    lin("K1 above PREFILL_THRESHOLD", "K1", BF16, 0, T + 1, 1024, 6144, "dense"),
    lin("K1 router at PREFILL_THRESHOLD", "K1", BF16, 0, T, 8, 6144, "mma tall"),
    lin("K1 router above PREFILL_THRESHOLD", "K1", BF16, 0, T + 1, 8, 6144, "dense"),
    lin("K1 f32 at PREFILL_THRESHOLD", "K1", F32, 0, T, 1024, 6144, "rows"),
    lin("K1 f32 above PREFILL_THRESHOLD", "K1", F32, 0, T + 1, 1024, 6144, "dense"),
]

# The warpgroup body at the port's expert widths: decode (T=8) and the
# self-draft verify (T=40) keep the tensor-core body at 8 experts, at tile_m 16,
# 32 and 64 (the verify's rows stay the decode's bits); so do f32, group sizes
# off 64, N off whole slices (320: 2.5) and K/2 off whole chunks (4160: 32.5).
WG_SHAPES = [(16384, 6144), (6144, 16384), (14336, 4096), (4096, 14336), (512, 256), (256, 512)]
WG = [
    *(grp(f"K{13 if gs else 2} {n}x{k} T={t} tile_m {tile_m}", "K13" if gs else "K2", BF16, gs,
          Tokens((t, 2)), 8, tile_m, n, k, "mma")
      for n, k in WG_SHAPES for gs in (0, 128) for t in (8, 40) for tile_m in (16, 32, 64)),
    *(grp(f"K{13 if gs else 2} {n}x{k} at 4096/16", "K13" if gs else "K2", BF16, gs, 4096, 8, 16,
          n, k, "wg") for n, k in WG_SHAPES for gs in (0, 128)),
    grp("K13 N=320 at 896/16", "K13", BF16, 128, 896, 8, 16, 320, 512, "mma"),
    grp("K2 K=4160 at 2176/128", "K2", BF16, 0, 2176, 8, 128, 4096, 4160, "mma tall"),
    grp("K13 gs 64 at 384 tokens", "K13", BF16, 64, Tokens((384, 2)), 8, 16, 6144, 16384, "wg"),
    grp("K2 at 576 tokens", "K2", BF16, 0, Tokens((576, 2)), 8, 128, 4096, 14336, "wg"),
]
# At 8 to 128 experts the body starts at the same rows an expert, whatever E
# (the padding a dispatch gives each expert does not count as rows): 24, that
# is 96 tokens at 8 experts top-2 and 192 at 64 top-8. Below them, decode and
# the verify keep the tensor-core body at tile_m 16, 32 and 64.
for e, top_k, hidden, ffn in ((8, 2, 4096, 14336), (16, 2, 4096, 14336),
                              (64, 8, 4096, 11008), (128, 8, 5120, 13696)):
    start = e * gm.WG_MIN_EXPERT_ROWS // top_k
    for n, k in ((ffn, hidden), (hidden, ffn)):
        for gs in (0, 128):
            if (k // 2) % max(gs, 1):
                continue                # GLM_5's down: K/2 is no whole number of groups of 128
            kn = "K13" if gs else "K2"
            at = f"{kn} E={e} top-{top_k} {n}x{k}"
            WG.append(grp(f"{at} at 2**20/16", kn, BF16, gs, 1 << 20, e, 16, n, k, "wg"))
            WG.append(grp(f"{at} {start} tokens", kn, BF16, gs, Tokens((start, top_k)), e, 16,
                          n, k, "wg"))
            WG.append(grp(f"{at} {start - 8} tokens", kn, BF16, gs, Tokens((start - 8, top_k)),
                          e, 16, n, k, "mma"))
            WG.extend(grp(f"{at} T={t} tile_m {tile_m}", kn, BF16, gs, Tokens((t, top_k)), e,
                          tile_m, n, k, "mma") for t in (8, 40) for tile_m in (16, 32, 64))


@pytest.mark.parametrize("kernel,cuda,dtype,gs,rows,e,tile_m,n,k,want", CELLS + EDGES + WG)
def test_body_choice(kernel, cuda, dtype, gs, rows, e, tile_m, n, k, want):
    """Each call's body ("mma tall": the tensor-core body's 64-row tile),
    named by one function per family from the call's type, format and
    shape alone."""
    if kernel in LINEAR:
        choose, args, tile = im._body, (rows, n, k), (rows, 0)
    else:
        t_pad = _t_pad(rows[0], e, tile_m, rows[1]) if isinstance(rows, Tokens) else rows
        choose, args, tile = gm._body, (t_pad, e, tile_m, n, k), (t_pad, tile_m)
    assert set(inspect.signature(choose).parameters) <= READS
    body = choose(kernel, cuda, dtype, gs, *args)
    if body == "mma" and _mma._tile_rows(*tile) == _mma._MMA_TALL_M:
        body = "mma tall"
    assert body == want
