#!/usr/bin/env python3
"""Drive the PyTorch port (fused4bit_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. require a CUDA card; print its name and power limit, the CUDA version
     and nvcc's version;
  2. build the kernels of fused4bit_tpu_torch/csrc (nvcc, sm_90a), print
     ptxas's registers and spills and the tensor-core instructions in the
     SASS of each instantiation of the tensor-core bodies: HMMA in the
     linear one of K1, K6 and K7 and its grouped instantiations of K2, K12
     and K13 (csrc/int4_mma.cuh) and the attention one of K3 and K3'
     (csrc/decode_attention.cu), IMMA in the int8 one of K10, K11, K14, K8
     and K5 (csrc/int8_mma.cuh), and fail if one has none;
  3. hold each kernel against its plain PyTorch version at the shapes the
     `layer2` serving path gives it (Mixtral-8x7B layer width), and time both
     with CUDA events (L2 flushed before each launch); time the integer-GEMM
     paths (resident i8 and transient unpack) at a prefill shape; K1 at
     1, 8, 32 and 40 rows, K6 at 8, 40 and 640, and rows 0-7 of each 40-row
     call equal to the 8-row call bit for bit (the self-draft verify's rows);
     The per-group kernels (K7, K8, K13, K14) are checked the same way, on
     weights quantized per group of 128 columns (planar_groups), K7 and K8
     also at 40 rows (rows 0-7 equal to the 8-row call bit for bit), K7 at
     gs 64 (the tensor-core body) and gs 32 (the CUDA-core loop), K8 (the
     int8 body) bit for bit against its plain version at 8, 40 and 640 rows
     in bf16 and f32 and at gs 64, 32 and 16 (the CUDA-core loop), and K6
     and K12 on planar weights per group of 128 (what convert_checkpoint
     gives);
     K9 (grouped_int4_matmul(mode="ksplit"); bf16 on the tensor-core body
     with K split across CTAs) on the down projection's stack at decode and
     T=600 against its plain version and K2, with zero padding rows exactly
     0, its token rows the same bits at T=8 and T=40 and at tile_m 16, 32
     and 64, and on a narrow stack that it splits into many CTAs along K.
     K2, K12 and K13 (bf16, the tensor-core body) are held to their
     plain versions at decode and prefill, gate/up and down, with zero
     padding rows exactly 0; one token's rows must be the same bits in a T=8
     and a T=40 dispatch (K12 also at tile_m 16, 32 and 64), and each
     expert's rows must equal the linear body (K1, K6, K7) at the same
     launch shape on that expert's weights, bit for bit. K2 and K13 on the
     warpgroup body (csrc/grouped_wgmma.cu) are held to their plain
     versions at the benchmark cells' widths and T_pad (K13 per group of 128
     at Mixtral-8x22B's, T_pad 896 at tile_m 16; K2 at Mixtral-8x7B's, T_pad
     2176 at tile_m 128), under spread and skewed routing (one expert past
     256 rows, some with none), padding rows exactly 0, and a token's rows
     the same bits at tile_m 16, 32, 64 and 128. K1's and K7's tall calls
     on the same body are held to their plain versions at the cells'
     linear shapes (K1: Mixtral-8x7B's at 576 and 65 rows, two replays of a
     CUDA graph bit-equal to the eager call, the router off the body; K7:
     the per-group cells', two launches bit-equal).
     Beside each
     kernel's time at its main shape stand its bound (the least time the card
     could take: bytes over 3.35 TB/s or operations over the peak of their
     type) and, where one PyTorch call computes the same function, that
     call's time, its output first held against the plain version at the
     kernel's bar. K3 is also timed at a B=8 decode over 4096 positions
     (split over 16 CTAs per row), and each decode row must equal the same
     position's row of a T=5 chunked prefill over the same cache bit for
     bit, on the contiguous and the paged cache. K3' runs on a page pool
     holding a contiguous cache's bytes in shuffled page order and must
     equal K3 on that cache bit for bit. K10, K11 and K14 (the int8 body)
     must equal their plain versions bit for bit at decode and prefill,
     gate/up and down, in bf16 and f32, with zero padding rows exactly 0, and
     one token's rows must be the same bits in a T=8 and a T=40 dispatch; K14
     also at gs 32 (the body's 8-byte runs) and gs 16 (the CUDA-core loop),
     and K10 and K14 on a narrow stack (N=256) whose launch splits K over
     CTAs. K5 and K4 (the int8 body as one expert, K4's first pass dividing
     by 127) must equal their plain versions bit for bit at 1, 8, 32 and 640
     rows (K5 also at 40) in bf16 (and in f32 at k/v), K4 also at deep K,
     K5's rows 0-7 the same bits at 8, 40 and 640 rows. These rows print the
     main kernel's device time beside the wrapper's. K3 with a window
     (int4_attention_window_kernel) is held to its plain version at the
     K-EXAONE cell's shapes (896 rows, 8 KV heads of 128, 8 query heads
     each, a window of 128 after 2048 positions): decode over the cell's
     wrapped ring of 130 slots (timed, beside the bound of the 128 visible
     positions), a 32-position chunk over a ring sized for it, and K3' over
     full pages with the window a mask; one decode step of a small
     K-EXAONE-shaped model, the counters reset just before it, must launch
     K3 8 times, 6 of them over a window (the JSON line's
     "window_launches"). K15 (mla_attention_kernel) is held to its plain
     version at the DeepSeek-V3 cell's shapes (256 sequences of 2049-2080
     positions, 128 heads, a latent of 512 and a RoPE key of 64; timed,
     beside its bound and scaled_dot_product_attention over the latent
     dequantized to bf16), two launches bit-equal, over a ragged batch of
     lengths 1-4095 cut in two segments, and a 4-query chunk whose rows
     equal decode calls bit for bit; the absorption's grouped calls
     (W_UK^T on K2, W_UV on K13) at the cell's shapes; one decode step of a
     small DeepSeek-V3-shaped model must launch K15 once a layer and no
     plain version (its launches in the JSON line);
  4. serve 12 requests on the `layer2` model (random weights from a seeded
     generator) with 8 slots, in the default (w4a16) mode and then, on the
     same weights, in the `as_u4_turbo` (w4a8), `as_per_group` (w4a16,
     per-group) and `as_turbo(as_per_group)` (w4a8, per-group: the serving
     benchmark's pg_turbo) modes, and check that each run launched the
     kernels of its mode and no plain version; after the default run, serve
     the same requests on a paged cache whose pool is too small for all 8
     slots (K3', admission waits; first tokens equal the contiguous run's),
     8 requests sharing a 128-token prompt prefix (prefix caching), the 12
     with decode_block=8 (contiguous, and paged across a page boundary;
     tokens equal decode_block=1's) and speculatively with the model as its
     own draft (acceptance 1.0, tokens equal), then run speculative_generate
     with the `small` model as an independent draft (teacher-forced greedy
     check);
  5. call the op entry points whose kernels no serving path of `layer2`
     takes: the w4a8 linear at deep K (K4), the w4a8 grouped product with the
     quantization fused (K11), and the experts with mode="ksplit" (K9);
  6. run one 2 x 320-token forward of `layer2` in the default mode and in
     each w4a8 and per-group mode, check that each took its prefill paths
     (transient unpack and capacity MoE, or K5 and K10, or resident i8, or
     K7/K8 at 640 rows and K13/K14 at tile_m 128), that the w4a8 modes agree
     with each other, and print their cosines against the default mode;
  7. make a seeded dense `layer2` checkpoint on the card one weight at a
     time (SeededCheckpoint), check that quantizing one full-width weight on
     the card gives the CPU's bytes per row, per group and per tensor,
     convert it with convert_checkpoint per row, per group of 128, and per
     row after AWQ equalization on 8 x 128 seeded token ids (printing its
     seconds, peak device memory and each site's alpha), and serve phase 4's
     12 requests on each: per row and AWQ on K1, K2 and K3, per group on K6,
     K12 and K3 (the router is dense: no K1), no plain version;
  8. convert the trained h256 fixture (tests/fixtures) on the card in the
     seven policies of the JAX quality record (router dense, all quantized,
     per group of 64 and 128, per tensor, AWQ per row and per group of 64,
     calibrated on the corpus head as the JAX evaluation does; each AWQ
     site's alpha printed, and an AWQ model whose sites all kept the
     identity must hold the plain conversion's bytes), and the router-dense
     model under
     as_per_group (K7, K13, K3), pg_turbo (K8, K14), u4_turbo (K5, K10,
     K3; two rows a forward, below the integer-GEMM gates) and turbo (K5 at
     every row count, K10 beside it; all rows in one forward), evaluate each
     on the held-out tail of its corpus against the bf16 twin built from the
     same checkpoint (dense_from_params), print the numbers beside the JAX
     package's committed record, hold them to tests/test_convert.py's gates
     (as_per_group and turbo to the router-dense policy's; each AWQ policy's
     cosine to at least its granularity's without AWQ less 1e-3, as
     tests/test_equalize.py holds it), and check the
     per-group-128 model on the card against the CPU;
  9. run the `tiny` model with the same weights on the card and on the CPU,
     in the default mode and in each w4a8 and per-group mode, and on paged
     caches, and compare the logits;
 10. persistence and utilities: pack four full-width weights of phase 7's
     seeded checkpoint with the native host packer (C++, g++) and hold its
     bytes, scales and zero points to quantize's bit for bit; save the
     default `layer2` model and the per-group-128 conversion, load each into
     a template built on the card from another seed, and serve phase 4's
     requests on each before and after (the same tokens, on K1/K2/K3 and on
     K6/K12/K3, no plain version; bytes on disk, save and load seconds);
     run 24 greedy decode steps of `layer2` at batch 8 through elastic_loop
     with a transient fault at step 13 and a crash at step 17 and its
     relaunch, each equal to an uninterrupted loop bit for bit; quantize
     FP4 on the card (codes and scales equal to the CPU's; the gate stack's
     peak memory; FP4's and INT4's error against the dense product); run
     QuantizedDense 4096->14336 (K1, equal to QuantizedLinear on the same
     bytes); count one decode step's kernels with device_op_times against
     the launch counters, replay K1 in a CUDA graph (time_fn_scan; equal to
     the eager call), hold linear_roofline to phase 3's K1 bound, and time
     a 1 GiB device-to-device copy;
 11. the parallel layer (fused4bit_tpu_torch.parallel) on a world-size-1 NCCL
     group, mesh (data, expert) = (1, 1): sharded_decode_step on the placed
     default model and on its as_per_group conversion (an 8 x 8 prefill and
     one decode step at batch 8) equal to the model's forward bit for bit,
     with wall and device ms per decode step of both; ServingEngine(mesh=...)
     on phase 4's 12 requests against the single-card engine's tokens (where
     they differ, the differing requests' prefill logits held to the model
     bar); the per-rank bodies of a D-way split, D = 2 and 4, one after
     another: EP-replicated on the gate stack (K2, and K13 per group) summed
     in rank order by the module's own summation code, TP on a 4096 -> 14336
     weight (K1) concatenated in rank order, each within the bf16 kernel bar
     of the single-card product; and the world-size-1 collectives
     (moe_ep_replicated, tp_int4_matmul) equal to it bit for bit. K1, K2, K3
     and K13 must launch and no plain version run; the group is destroyed at
     the end, also on failure.
 12. the graft entry points (fused4bit_tpu_torch.graft_entry): entry() on
     the card, its step's logits within the model bar of a CPU copy (K1, K2
     and K3 launched, no plain version); dryrun_multichip over the cards
     (one rank per card, NCCL; one rank on one card), every check of its
     nine parts printed beside its bar and the rank's launches (K1, K2 and
     K3, no plain version); and moe_ep_a2a, moe_ep_a2a_dropless and
     moe_ep_ring beside moe_ep_replicated at layer2's gate stack (8 experts,
     4096 -> 14336, bf16, T=8) on a world-size-1 NCCL group, each within the
     bf16 bar of the single-card grouped product, with wall ms a call.
 13. the bench twin (fused4bit_tpu_torch.bench): bench.run() at full
     geometry (`layer2` and `small`, batch 8, 24 steps, 4 repeats): the
     INT4 model in the default, u4_turbo and xla_turbo modes and its
     dense_all bf16 twin, then at `small` the INT4 model and its gather and
     dense_all twins, each loop captured in one CUDA graph. For each loop
     the graph's tokens must equal the eager decode_loop's from the same
     first token, an INT4 loop's caches after a replay must hold the eager
     loop's bytes, and a captured step must launch what
     bench_step_launches reads from the code (K1 11, K2 6, K3 2 at
     `layer2` in the default mode; K5 11, K10 6, K3 2 under u4_turbo; K2
     6, K3 2 and 11 int8 linears under xla_turbo), no plain version; every
     device ms must be a number. The default mode's loops (`layer2` and
     `small`) hold K1, K2 and K3 against their plain versions at the loop's
     own shapes: one more eager step in which every K1 and K2 call is made
     again through its wrapper on the same inputs, and K3 on each layer's
     cache after it (bf16 bars; these launches are not counted). One replay of each loop is traced under
     torch.profiler (annotate("loop")): its main kernels must number the
     graph's launches. Prints each loop's graph and eager wall ms per step,
     its device ms per step by CUDA events beside the profiler's range, and
     the twin's JSON line.
The line before the last is a JSON summary of the kernels, with each
kernel's launches counted over the phase that drives it (4, 5 or 7; K3' over
the first paged serve; K15 over phase 3's small DeepSeek-V3 step) and, beside them, its launches in phase 11's parallel
calls (``parallel_launches``), in phase 12 (``graft_launches``) and in phase
13 (``bench_launches``); the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from fused4bit_tpu_torch import bench, native, ops
from fused4bit_tpu_torch import parallel as par
from fused4bit_tpu_torch.layers import (
    LatentKVCache,
    MoEINT4,
    PagedKVCache,
    QuantizedDense,
    QuantizedKVCache,
    QuantizedLinear,
    dispatch,
    make_dispatch_plan,
    topk_route,
)
from fused4bit_tpu_torch.models import (
    DEEPSEEK_V3_671B,
    MLAttention,
    ModelConfig,
    MoEConfig,
    QuantizedTransformer,
    as_per_group,
    as_turbo,
    as_u4_turbo,
    as_xla_turbo,
    SeededCheckpoint,
    convert_checkpoint,
    convert_safetensors,
    dense_from_params,
    flagship_model_config,
    load_safetensors,
)
from fused4bit_tpu_torch.ops import _build, _front, _mma, _wg
from fused4bit_tpu_torch.ops._int8 import _a8_mma_launch
from fused4bit_tpu_torch.ops._mma import (
    _MMA_TALL_M,
    _fold_mma_launch,
    _grouped_mma_launch,
    _ksplit_mma_launch,
    _mma_launch,
)
from fused4bit_tpu_torch.ops._rows import _ksplit_splits
from fused4bit_tpu_torch.ops.grouped_matmul import _body as _grouped_body
from fused4bit_tpu_torch.ops.int4_matmul import WG_MIN_LINEAR_ROWS, _body as _linear_body
from fused4bit_tpu_torch.ops.mla_attention import _mla_segment
from fused4bit_tpu_torch.quant import (
    dequantize,
    dequantize_fp4,
    fp4_matmul,
    planar_groups_to_planar,
    quantize,
    quantize_fp4,
    unpack_planar,
)
from fused4bit_tpu_torch.graft_entry import decode_step, dryrun_multichip, entry
from fused4bit_tpu_torch.parallel import multihost
from fused4bit_tpu_torch.serving import GenerationRequest, ServingEngine, speculative_generate
from fused4bit_tpu_torch.utils import (
    H100_SXM,
    annotate,
    checkpoint,
    device_op_times,
    elastic_loop,
    latest_step,
    linear_roofline,
    time_fn_scan,
)

# Tolerances, kernel vs plain version on the same inputs:
# - bf16 output: both round one f32 sum to bf16, summed in another order, so a
#   few bf16 ulps of the largest output: max|d| <= 1e-2 * max|y_plain|.
# - f32 output at K >= 4096: the reference's ladder for a 4096-deep f32 sum
#   taken in another order: max|d| <= 1e-2.
# - K3: outputs are convex combinations of values of order 1, rounded to
#   bf16 once, with ps rounded to bf16 at a running max in the kernel and at
#   the row max in the plain version: max|d| <= 2e-2.
BF16_REL_TOL = 1e-2
F32_ABS_TOL = 1e-2
ATTN_ABS_TOL = 2e-2
# - w4a8: the same quantization and an exact integer dot on both sides, then
#   the same f32 epilogue, operation by operation: the kernels (K4, K5, K8,
#   K10, K11, K14) bit for bit; the integer-GEMM path (int8_linear, whose
#   epilogue is not the kernels') to max|d| <= 1e-6 * max|y_plain| in f32,
#   one bf16 ulp (2^-7 * max|y_plain|) in bf16.
A8_F32_REL_TOL = 1e-6
A8_BF16_REL_TOL = 2.0 ** -7
# Whole model on the card vs the CPU: bf16 activations through 2 layers.
MODEL_REL_TOL = 2e-2
# Speculative output against a teacher-forced forward: the runner-up is
# accepted within this logit gap (the verify forward at T = gamma+1 and the
# decode forward round in another order; tests/test_speculative.py).
SPEC_TIE_BAND = 0.2
# Long prefill, turbo (w4a8 kernels) vs u4_turbo (integer GEMMs), cosine of
# each row's last-position logits and of all its positions together. The
# two modes compute the same integers but round their f32 epilogues and
# activation scales in another order, which flips the routing of a share of
# the tokens with random weights, in the JAX package as in the port
# (tests/test_torch_model.py): bars below the readings of 0.998 and 0.986.
PREFILL_COS_LAST = 0.995
PREFILL_COS_ALL = 0.98

SOURCES = {
    "int4_matmul": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                    "fused4bit_tpu/ops/int4_matmul.py:90"),
    "grouped_int4_matmul": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                            "fused4bit_tpu/ops/grouped_matmul.py:59"),
    "int4_attention": ("fused4bit_tpu_torch/csrc/decode_attention.cu",
                       "fused4bit_tpu/ops/decode_attention.py:71"),
    "paged_int4_attention": ("fused4bit_tpu_torch/csrc/decode_attention.cu",
                             "fused4bit_tpu/ops/decode_attention.py:311"),
    "int4_matmul_a8": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                       "fused4bit_tpu/ops/int4_matmul.py:1039"),
    "int4_matmul_a8_fused": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                             "fused4bit_tpu/ops/int4_matmul.py:1094"),
    "grouped_int4_matmul_a8": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                               "fused4bit_tpu/ops/grouped_matmul.py:500"),
    "grouped_int4_matmul_a8_fused": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                                     "fused4bit_tpu/ops/grouped_matmul.py:552"),
    "int4_matmul_per_group": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                              "fused4bit_tpu/ops/int4_matmul.py:587"),
    "int4_matmul_per_group_a8": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                                 "fused4bit_tpu/ops/int4_matmul.py:761"),
    "grouped_int4_matmul_per_group": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                                      "fused4bit_tpu/ops/grouped_matmul.py:994"),
    "grouped_int4_matmul_per_group_a8": ("fused4bit_tpu_torch/csrc/int8_mma.cuh",
                                         "fused4bit_tpu/ops/grouped_matmul.py:1101"),
    "int4_matmul_per_group_planar": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                                     "fused4bit_tpu/ops/int4_matmul.py:427"),
    "grouped_int4_matmul_ksplit": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                                   "fused4bit_tpu/ops/grouped_matmul.py:241"),
    "grouped_int4_matmul_per_group_planar": ("fused4bit_tpu_torch/csrc/int4_mma.cuh",
                                             "fused4bit_tpu/ops/grouped_matmul.py:859"),
    "mla_attention": ("fused4bit_tpu_torch/csrc/mla_attention.cu",
                      "none: the JAX package runs no latent attention"),
}
# Each kernel's decode shape on the serving path: its ms / plain_ms in the
# JSON summary.
MAIN_SHAPE = {
    "int4_matmul": "M=8 N=4096 K=4096 bf16",
    "grouped_int4_matmul": "T=8 tile_m=16 N=14336 K=4096",
    "int4_attention": "decode B=8 lengths [1, 2, 37, 255]",
    "paged_int4_attention": "decode B=8 page 128 bf16",
    "int4_matmul_a8": "M=8 N=4096 K=4096 bf16",
    "int4_matmul_a8_fused": "M=8 N=4096 K=4096 bf16",
    "grouped_int4_matmul_a8": "T=8 tile_m=32 N=14336 K=4096",
    "grouped_int4_matmul_a8_fused": "T=8 tile_m=32 N=14336 K=4096",
    "int4_matmul_per_group": "M=8 N=4096 K=4096 bf16",
    "int4_matmul_per_group_a8": "M=8 N=4096 K=4096 bf16",
    "grouped_int4_matmul_per_group": "T=8 tile_m=16 N=14336 K=4096",
    "grouped_int4_matmul_per_group_a8": "T=8 tile_m=32 N=14336 K=4096",
    "int4_matmul_per_group_planar": "M=8 N=4096 K=4096 bf16",
    "grouped_int4_matmul_ksplit": "T=8 tile_m=16 N=4096 K=14336",
    "grouped_int4_matmul_per_group_planar": "T=8 tile_m=16 N=14336 K=4096",
    "mla_attention": "decode B=256 H=128 lengths 2049-2080",
}
# The card's published rates (NVIDIA's H100 SXM data sheet, dense, at the
# 700 W limit; utils.roofline.H100_SXM): a kernel's bound is the larger of its
# bytes over the HBM rate and its operations over the peak of their type.


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_: float, ops: float, kind: str) -> dict:
    """The least time the card could take for ``bytes_`` moved and ``ops``
    operations of type ``kind``, in ms, and which of the two bounds it."""
    by_bytes = bytes_ / (H100_SXM.hbm_gbps * 1e9) * 1e3
    by_ops = ops / H100_SXM.peak_ops(kind) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops
                else "operations")


def _op_kind(x: torch.Tensor, a8: bool) -> str:
    return "int8" if a8 else ("bf16" if x.dtype == torch.bfloat16 else "f32")


def linear_bound(x, qt, a8=False) -> dict:
    """x [M, K] @ W[N, K]^T: x, the packed weight and its scales/zero points
    read once, y written once; 2*M*N*K operations."""
    m, n, k = x.shape[0], qt.out_dim, qt.in_dim
    return bound(nbytes(x, qt.packed, qt.scales, qt.zero_points) + m * n * x.element_size(),
                 2.0 * m * n * k, _op_kind(x, a8))


def grouped_bound(xs, gids, qt, rows, a8=False) -> dict:
    """The grouped product at this routing: x_sorted and the tile map read
    once, the weights of the experts the routing hits read once, y written
    once; 2*rows*N*K operations over the rows that hold a token."""
    e, n, k = qt.shape
    hit = torch.unique(gids[(xs.reshape(gids.shape[0], -1).abs().sum(dim=1) != 0)]).numel()
    per_expert = nbytes(qt.packed, qt.scales, qt.zero_points) / e
    return bound(nbytes(xs, gids) + hit * per_expert + xs.shape[0] * n * xs.element_size(),
                 2.0 * rows * n * k, _op_kind(xs, a8))


def int4pack_yardstick(x, qt):
    """One PyTorch call that computes the same w4a16 linear (a library
    yardstick, used nowhere in the port): ``torch._weight_int4pack_mm`` on the
    same 4-bit codes after a one-time ``_convert_weight_to_int4pack``, with
    bf16 scales and zeros (8 - zp) * s per group of 128 columns (per_row
    weights as equal groups). None where this PyTorch lacks it."""
    if not hasattr(torch, "_weight_int4pack_mm") or x.dtype != torch.bfloat16:
        return None
    n, k = qt.out_dim, qt.in_dim
    gs = qt.group_size or 128
    w = qt.packed if qt.layout == "planar" else planar_groups_to_planar(qt.packed)
    codes = unpack_planar(w).to(torch.int32)                        # [N, K]
    packed = (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8)
    wp = torch._convert_weight_to_int4pack(packed, 8)
    s, z = qt.scales, qt.zero_points
    if qt.granularity == "per_row":
        s, z = s[:, None].expand(n, k // gs), z[:, None].expand(n, k // gs)
    sz = torch.stack([s, (8.0 - z) * s], dim=-1).transpose(0, 1).contiguous().bfloat16()
    return lambda: torch._weight_int4pack_mm(x, wp, gs, sz)


def card() -> str:
    return bench.card_line(torch.device("cuda", 0))


def require_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    line = card()
    print(line)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return line


def build() -> float:
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (0 s means the library was already built)")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    tensor_core_sass()
    return secs


# The tensor-core bodies, their instantiations and the tensor-core instruction
# each must hold: the linear body (csrc/int4_mma.cuh) for K1, K6 and K7 in
# bf16 and, with grouped addressing, K2 (K9 runs its instantiation), K12 and
# K13, each with a 16-row and a 64-row tile of x; the attention body
# (csrc/decode_attention.cu) for K3 and K3', each at head_dim 64 and 128; the
# int8 body (csrc/int8_mma.cuh) for K10 (K11, K5 and K4 run its
# instantiation) and for K14 with 16- and 8-byte runs (K8 runs K14's two);
# the warpgroup body (csrc/grouped_wgmma.cu, wgmma: HGMMA) for K2 and K13
# and, without grouped addressing, for K1's and K7's tall calls.
TENSOR_CORE_KERNELS = {"int4_mma_kernel": (12, "HMMA"),
                       "int4_attention_mma_kernel": (4, "HMMA"),
                       "int8_mma_kernel": (3, "IMMA"),
                       "int4_mma_kernel_wg": (4, "HGMMA")}


def _tensor_core_body(fn: str):
    """The body of TENSOR_CORE_KERNELS a kernel symbol instantiates (the
    longest name it holds), or None."""
    return max((k for k in TENSOR_CORE_KERNELS if k in fn), key=len, default=None)


def tensor_core_sass() -> dict:
    """The tensor-core instructions (HMMA, IMMA for the int8 body, HGMMA for
    the warpgroup body) in the SASS of each instantiation of the tensor-core
    bodies, from ``cuobjdump -sass`` of the built library; raises if a
    kernel has none (it would not run on the tensor cores) or if an
    instantiation is missing."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn, op = {}, None, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            body = _tensor_core_body(fn)
            op = TENSOR_CORE_KERNELS[body][1] if body else None
            if op is not None:
                counts[fn] = 0
        elif fn in counts and op in line:
            counts[fn] += 1
    for name, c in counts.items():
        print(f"  sass: {c} {TENSOR_CORE_KERNELS[_tensor_core_body(name)][1]} in {name}")
    found = {k: sum(_tensor_core_body(fn) == k for fn in counts) for k in TENSOR_CORE_KERNELS}
    if found != {k: n for k, (n, _) in TENSOR_CORE_KERNELS.items()} or min(counts.values()) == 0:
        raise AssertionError(f"tensor-core bodies: instantiations {found}, counts {counts}")
    return counts


class Timer:
    """Median device time of one call, with CUDA events around each call
    and the L2 cache flushed before it (the serving path finds weights cold)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            # keep the card busy while the host enqueues, so the events time
            # the device work and not the host's launch overhead
            torch.cuda._sleep(1_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(self, fn, kernel: str, calls: int = 10) -> float:
        """Device time per call of the kernels whose name holds ``kernel``
        (a wrapper's main kernel, without its first pass), under
        torch.profiler, the L2 flushed before each call."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                self.flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if kernel in e.key:
                t = getattr(e, "device_time_total", None)
                total += e.cuda_time_total if t is None else t
        return total / calls / 1e3


def _compare(name, shape, y, ref, tol, results, timer, fn, ref_fn, iters=20, work=None,
             library=None, exact=False, main=None):
    """Hold a kernel's output ``y`` against its plain version's ``ref`` (bit
    for bit with ``exact``); with a timer, time both (and the library call
    ``library``, where given, after holding its output against ``ref`` at the
    same bar, so that it times the same function, and with ``main`` the
    device time of the wrapper's main kernel, the kernels whose name holds
    ``main``); with ``work`` (see :func:`bound`), record the bound at this
    shape."""
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"{name} {shape}: non-finite output")
    if exact and not torch.equal(y, ref):
        d = (y.float() - ref.float()).abs().max().item()
        raise AssertionError(f"{name} {shape}: not bit-equal to its plain version (max|d| {d})")
    err = (y.float() - ref.float()).abs().max().item()
    if library is not None:
        lib_err = (library().float().reshape(ref.shape) - ref.float()).abs().max().item()
        print(f"    library call {shape}: max|d| {lib_err:.3e} against the plain version "
              f"(tol {tol:.3e})")
        if not lib_err <= tol:
            raise AssertionError(f"{name} {shape}: the library call is off by {lib_err} > {tol}")
    ms = timer(fn, iters=iters) if timer else float("nan")
    plain_ms = timer(ref_fn, iters=min(iters, 5)) if timer else float("nan")
    library_ms = timer(library, iters=iters) if timer and library else None
    main_ms = timer.device_ms(fn, main) if timer and main else None
    ok = err <= tol
    extra = "" if work is None else f" bound {work['bound_ms']:.4f} ms ({work['bound_by']})"
    extra += "" if library_ms is None else f" library {library_ms:.4f} ms"
    extra += "" if main_ms is None else f" main kernel {main_ms:.4f} ms"
    extra += " bit-equal" if exact else ""
    print(f"  {name:20s} {shape:34s} max|d| {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {shape}: max|d| {err} > {tol}")
    results.append(dict(name=name, shape=shape, err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, main_ms=main_ms, **(work or {})))


def same_rows(name, shape, small, big):
    """Rows of an M=8 call equal rows 0-7 of an M=40 call (or a larger one)
    on the same rows of x bit for bit: the tensor-core body's launch rule
    reads (N, K, SMs) only, as the self-draft speculative verify (40 rows)
    needs (K5's may read M: its sums are exact)."""
    m = big.shape[0]
    if not torch.equal(small, big[:small.shape[0]]):
        d = (small.float() - big[:small.shape[0]].float()).abs().max().item()
        raise AssertionError(f"{name} {shape}: rows 0-7 differ between M=8 and M={m} ({d})")
    print(f"    {name} {shape}: rows 0-7 of M={m} equal M=8 bit for bit")


def check_linear(device, results, timer, gen):
    for n, k in ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096)):
        w = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
        qt = quantize(w)
        x40 = torch.randn((40, k), generator=gen, device=device).bfloat16()
        rows = {}
        for m in (1, 8, 32, 40):
            x = x40[:m].contiguous()
            ref = ops.int4_matmul_reference(x, qt)
            y = rows[m] = ops.int4_matmul(x, qt)
            torch.cuda.synchronize()
            main = (m, n) == (8, 4096)
            _compare("int4_matmul", f"M={m} N={n} K={k} bf16", y, ref,
                     BF16_REL_TOL * ref.float().abs().max().item(), results, timer,
                     lambda: ops.int4_matmul(x, qt),
                     lambda: ops.int4_matmul_reference(x, qt), work=linear_bound(x, qt),
                     library=int4pack_yardstick(x, qt) if main else None)
        same_rows("int4_matmul", f"N={n} K={k} bf16", rows[8], rows[40])
        if n == 1024:
            x = torch.randn((8, k), generator=gen, device=device)
            ref = ops.int4_matmul_reference(x, qt)
            _compare("int4_matmul", f"M=8 N={n} K={k} f32", ops.int4_matmul(x, qt),
                     ref, F32_ABS_TOL, results, None, None, None)


def _skewed_plan(t, e, top_k, tile_m, gen, device):
    """Routing skewed so some experts get several tokens and some none."""
    bias = torch.log(1.0 / (torch.arange(e, device=device) + 1.0)) * 4.0
    logits = bias[None, :] + torch.randn((t, e), generator=gen, device=device)
    routing = topk_route(logits, top_k, e)
    return routing, make_dispatch_plan(routing, e, tile_m=tile_m)


def linear_at(x, qt, launch):
    """The linear tensor-core body at launch shape ``launch`` = (ws, kw,
    splits), 16 rows of x per CTA: K1 on a per_row weight, K6 on a per_group
    planar one, K7 on a per_group planar_groups one; as ops launches it,
    through the C entry points."""
    ws, kw, splits = launch
    m, k = x.shape
    n = qt.out_dim
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    per_group = qt.granularity == "per_group"
    fn = (lib.f4b_int4_matmul_bf16 if not per_group else
          lib.f4b_int4_matmul_planar_pg_bf16 if qt.layout == "planar" else
          lib.f4b_int4_matmul_pg_mma_bf16)
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.zero_points.data_ptr(),
             y.data_ptr(), partial.data_ptr(), m, n, k, *([qt.group_size] if per_group else []),
             ws, kw, splits, 16, _build.stream_of(x))
    _build.check(err, "linear_at")
    return y


def same_as_linear(name, xs, gids, qt, tile_m, y, launch=None):
    """Each expert's token rows of a grouped call ``y`` (K2, K12 or K13 at
    tile_m <= 64, at launch shape ``launch``, by default the grouped rule's)
    equal the linear body (K1, K6 or K7) at the same launch shape on that
    expert's weights, bit for bit: the grouped addressing reads the right
    expert and rows, and a row's sums run in the linear body's order. Prints
    whether the shape is the linear rule's."""
    e, n, k = qt.shape
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    launch = launch or _grouped_mma_launch(n, k, sms)
    linear_rule = _fold_mma_launch if qt.layout == "planar_groups" else _mma_launch
    token = (xs.abs().sum(dim=1) != 0).reshape(-1, tile_m)
    for ex in torch.unique(gids[token.any(dim=1)]).tolist():
        tiles = (gids == ex) & token.any(dim=1)
        rows = tiles[:, None].expand(-1, tile_m).reshape(-1) & token.reshape(-1)
        sub = dataclasses.replace(qt, packed=qt.packed[ex], scales=qt.scales[ex],
                                  zero_points=qt.zero_points[ex], shape=(n, k))
        lin = linear_at(xs[rows], sub, launch)
        if not torch.equal(y[rows], lin):
            d = (y[rows].float() - lin.float()).abs().max().item()
            raise AssertionError(f"{name} N={n} K={k}: expert {ex}'s rows differ from the "
                                 f"linear body at {launch} ({d})")
    same = launch == linear_rule(n, k, sms)
    print(f"    {name} N={n} K={k} tile_m={tile_m}: each expert's rows equal the linear body's "
          f"at {launch} bit for bit ({'the' if same else 'not the'} linear rule's shape"
          f"{'' if same else ' ' + str(linear_rule(n, k, sms))})")


def check_grouped(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    """K2 at the expert shapes: decode (T=8, tile_m 16; f32 too) and the
    prefill (T=600, tile_m 128), skewed routing, with zero padding rows
    exactly 0; each expert's decode rows equal the linear body at the same
    launch shape, and a token's rows are the same bits in a T=8 and a T=40
    dispatch. bf16 rows print the main kernel's device time."""
    for n, k in ((ffn, hidden), (hidden, ffn)):       # gate/up, then down
        w = torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5
        qt = quantize(w)
        del w
        for t, tile_m in ((8, 16), (600, 128)):
            routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
            x = torch.randn((t, k), generator=gen, device=device).bfloat16()
            xs = dispatch(x, routing, plan)
            gids = plan.tile_group_ids
            ref = ops.grouped_int4_matmul_reference(xs, gids, qt, tile_m=tile_m)
            y = ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m)
            torch.cuda.synchronize()
            pad = xs.abs().sum(dim=1) == 0
            if not bool((y[pad] == 0).all()):
                raise AssertionError("grouped_int4_matmul: padding rows are not exactly zero")
            loads = routing.tokens_per_expert.tolist()
            _compare("grouped_int4_matmul",
                     f"T={t} tile_m={tile_m} N={n} K={k}", y, ref,
                     BF16_REL_TOL * ref.float().abs().max().item(), results, timer,
                     lambda: ops.grouped_int4_matmul(xs, gids, qt, tile_m=tile_m),
                     lambda: ops.grouped_int4_matmul_reference(xs, gids, qt, tile_m=tile_m),
                     iters=20 if t == 8 else 5, work=grouped_bound(xs, gids, qt, 2 * t),
                     main="int4_mma_kernel")
            print(f"    tokens per expert {loads}, T_pad {plan.t_pad}")
            if t == 8:  # the f32 instantiation, at the decode shape
                same_as_linear("grouped_int4_matmul", xs, gids, qt, tile_m, y)
                xf = xs.float()
                _compare("grouped_int4_matmul", f"T={t} tile_m={tile_m} N={n} K={k} f32",
                         ops.grouped_int4_matmul(xf, gids, qt, tile_m=tile_m),
                         ops.grouped_int4_matmul_reference(xf, gids, qt, tile_m=tile_m),
                         F32_ABS_TOL, results, None, None, None)
        same_token_rows("grouped_int4_matmul", ops.grouped_int4_matmul, qt, k, e, gen, device,
                        tile_m=16)
        del qt


A8_NAMES = {False: ("int4_matmul_a8", "grouped_int4_matmul_a8"),          # K4, K10
            True: ("int4_matmul_a8_fused", "grouped_int4_matmul_a8_fused")}  # K5, K11


def _a16_tol(ref):
    """The w4a16 bars: BF16_REL_TOL of the largest output in bf16, F32_ABS_TOL
    in f32."""
    f32 = ref.dtype == torch.float32
    return F32_ABS_TOL if f32 else BF16_REL_TOL * ref.float().abs().max().item()


def _a8_tol(ref):
    rel = A8_F32_REL_TOL if ref.dtype == torch.float32 else A8_BF16_REL_TOL
    return rel * ref.float().abs().max().item()


def check_linear_a8(device, results, timer, gen):
    """K4 and K5 at the layer2 linear shapes (K4 also at deep K), each bit
    for bit against the plain version with its own quantizer, both on the
    int8 body (K4's first pass divides by 127, K5's multiplies by
    f32(1/127)): K4 at 1, 8, 32 and 640 rows, K5 at 1, 8, 32, 40 and 640
    (the long prefill of phase 6 in the turbo mode), both also in f32 at
    k/v; K5's rows 0-7 the same bits at 8, 40 and 640 rows (its launch rule
    reads M above 64 rows; its int32 sums are exact), bf16 rows with the
    main kernel's device time."""
    for n, k in ((4096, 4096), (1024, 4096), (8, 4096), (8192, 4096), (4096, 14336)):
        qt = quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
        x640 = torch.randn((640 if k == 4096 else 8, k), generator=gen, device=device).bfloat16()
        rows = {}
        for m in ((1, 8, 32, 40, 640) if k == 4096 else (8,)):
            x = x640[:m].contiguous()
            f32 = n == 1024 and m in (8, 40, 640)
            for xx in (x, x.float()) if f32 else (x,):  # + the f32 instantiations
                dt = "bf16" if xx.dtype == torch.bfloat16 else "f32"
                fuses = (False,) if k > 4096 else (True,) if m == 40 else (False, True)
                for fuse in fuses:
                    ref = ops.int4_matmul_a8_reference(xx, qt, fuse_quant=fuse)
                    y = ops.int4_matmul_a8(xx, qt, fuse_quant=fuse)
                    if fuse and xx is x:
                        rows[m] = y
                    timed = xx is x and m != 40
                    _compare(A8_NAMES[fuse][0], f"M={m} N={n} K={k} {dt}", y, ref, _a8_tol(ref),
                             results, timer if timed else None,
                             lambda: ops.int4_matmul_a8(xx, qt, fuse_quant=fuse),
                             lambda: ops.int4_matmul_a8_reference(xx, qt, fuse_quant=fuse),
                             iters=5 if m == 640 else 20, work=linear_bound(xx, qt, a8=True),
                             exact=True, main="int8_mma_kernel" if timed else None)
        if k == 4096:
            for big in (40, 640):
                same_rows(A8_NAMES[True][0], f"N={n} K={k} bf16", rows[8], rows[big])
        del qt


def same_token_rows(name, op, qt, k, e, gen, device, tile_m=32):
    """One token's rows (its top-2 pairs) give the same bits in a T=8 and a
    T=40 dispatch at ``tile_m``, where they sit in other rows and tiles: the
    tensor-core bodies' launch rules read (N, K, (gs,) SMs) only."""
    x40 = torch.randn((40, k), generator=gen, device=device).bfloat16()
    bias = torch.log(1.0 / (torch.arange(e, device=device) + 1.0)) * 4.0
    logits = bias[None, :] + torch.randn((40, e), generator=gen, device=device)
    rows = []
    for t in (8, 40):
        routing = topk_route(logits[:t], 2, e)
        plan = make_dispatch_plan(routing, e, tile_m=tile_m)
        y = op(dispatch(x40[:t], routing, plan), plan.tile_group_ids, qt, tile_m=tile_m)
        rows.append((y[plan.rows[:16]], plan.rows[:16]))
    (small, at8), (big, at40) = rows
    if torch.equal(at8, at40):
        raise AssertionError(f"{name}: the T=40 dispatch put the tokens in the same rows")
    if not torch.equal(small, big):
        d = (small.float() - big.float()).abs().max().item()
        raise AssertionError(f"{name} N={qt.shape[1]} K={k}: a token's rows differ between "
                             f"T=8 and T=40 ({d})")
    print(f"    {name} N={qt.shape[1]} K={k} tile_m={tile_m}: the 8 tokens' rows of T=8 equal "
          "T=40's bit for bit")


def check_grouped_a8(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    """K10 and K11 at the expert shapes: u4_turbo decode (T=8, tile_m 32) and
    turbo prefill (T=600, tile_m 128), skewed routing. Both run the int8 body
    (K10's first pass divides by 127, K11's multiplies by f32(1/127)) and
    must equal their plain versions bit for bit in bf16 and f32, with
    padding rows exactly 0, and a token's rows must be the same bits in a
    T=8 and a T=40 dispatch."""
    for n, k in ((ffn, hidden), (hidden, ffn)):       # gate/up, then down
        qt = quantize(torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5)
        for t, tile_m in ((8, 32), (600, 128)):
            routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
            xs = dispatch(torch.randn((t, k), generator=gen, device=device).bfloat16(),
                          routing, plan)
            gids = plan.tile_group_ids
            pad = xs.abs().sum(dim=1) == 0
            iters = 20 if t == 8 else 5
            for xx in (xs, xs.float()):
                f32 = xx.dtype == torch.float32
                for fuse in (False, True):
                    name = A8_NAMES[fuse][1]
                    ref = ops.grouped_int4_matmul_a8_reference(xx, gids, qt, tile_m=tile_m,
                                                               fuse_quant=fuse)
                    y = ops.grouped_int4_matmul_a8(xx, gids, qt, tile_m=tile_m, fuse_quant=fuse)
                    torch.cuda.synchronize()
                    if not bool((y[pad] == 0).all()):
                        raise AssertionError(f"{name}: padding rows are not exactly zero")
                    _compare(name, f"T={t} tile_m={tile_m} N={n} K={k}" + (" f32" if f32 else ""),
                             y, ref, _a8_tol(ref), results, None if f32 else timer,
                             lambda: ops.grouped_int4_matmul_a8(xx, gids, qt, tile_m=tile_m,
                                                                fuse_quant=fuse),
                             lambda: ops.grouped_int4_matmul_a8_reference(
                                 xx, gids, qt, tile_m=tile_m, fuse_quant=fuse),
                             iters=iters, work=grouped_bound(xx, gids, qt, 2 * t, a8=True),
                             exact=True, main="int8_mma_kernel")
            print(f"    tokens per expert {routing.tokens_per_expert.tolist()}, "
                  f"T_pad {plan.t_pad}")
        same_token_rows("grouped_int4_matmul_a8", ops.grouped_int4_matmul_a8, qt, k, e, gen,
                        device)
        same_token_rows("grouped_int4_matmul_a8_fused",
                        functools.partial(ops.grouped_int4_matmul_a8, fuse_quant=True), qt, k, e,
                        gen, device)
        del qt


def _pg_quantize(w):
    return quantize(w, granularity="per_group", layout="planar_groups", group_size=128)


def check_linear_pg(device, results, timer, gen):
    """K7 and K8 at the layer2 linear shapes, weights per group of 128
    (planar_groups): the decode rows (8), the self-draft verify's (40) and
    the long prefill's (640) in bf16, and the f32 instantiations at N=1024
    (K7 at 8 rows, K8 at 8 and 640); rows 0-7 of each 40-row call must equal
    the 8-row call bit for bit. K8 (the int8 body) must equal its plain
    version bit for bit; bf16 rows print the main kernel's device time.
    Then K7 at gs 64 (the tensor-core body) and gs 32 (the CUDA-core loop),
    and K8 at gs 64 and 32 (the int8 body's 16- and 8-byte runs) and gs 16
    (the CUDA-core loop). At 640 rows bf16 K7 runs the warpgroup body at
    these widths, so last K7 at 640 rows on N=960, a width in no whole
    slices of 128, which keeps the tall tile (``int4_mma_kernel<GroupFold,
    8, false>``), held to the plain version."""
    for n, k in ((4096, 4096), (1024, 4096), (8192, 4096)):
        qt = _pg_quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
        x640 = torch.randn((640, k), generator=gen, device=device).bfloat16()
        rows = {"int4_matmul_per_group": {}, "int4_matmul_per_group_a8": {}}
        for m in (8, 40, 640):
            x = x640[:m].contiguous()
            for xx in ((x, x.float()) if n == 1024 and m != 40 else (x,)):
                f32 = xx.dtype == torch.float32
                dt = "f32" if f32 else "bf16"
                main = (m, n) == (8, 4096)
                iters = 5 if m == 640 else 20
                if not (f32 and m == 640):
                    ref = ops.int4_matmul_per_group_reference(xx, qt)
                    y = ops.int4_matmul_per_group(xx, qt)
                    if not f32:
                        rows["int4_matmul_per_group"][m] = y
                    _compare("int4_matmul_per_group", f"M={m} N={n} K={k} {dt}", y, ref,
                             _a16_tol(ref), results, None if f32 else timer,
                             lambda: ops.int4_matmul_per_group(xx, qt),
                             lambda: ops.int4_matmul_per_group_reference(xx, qt), iters=iters,
                             work=linear_bound(xx, qt),
                             library=int4pack_yardstick(xx, qt) if main else None)
                ref = ops.int4_matmul_per_group_a8_reference(xx, qt)
                y = ops.int4_matmul_per_group_a8(xx, qt)
                if not f32:
                    rows["int4_matmul_per_group_a8"][m] = y
                timed = not f32 and m != 40
                _compare("int4_matmul_per_group_a8", f"M={m} N={n} K={k} {dt}", y, ref,
                         _a8_tol(ref), results, timer if timed else None,
                         lambda: ops.int4_matmul_per_group_a8(xx, qt),
                         lambda: ops.int4_matmul_per_group_a8_reference(xx, qt), iters=iters,
                         work=linear_bound(xx, qt, a8=True), exact=True,
                         main="int8_mma_kernel" if timed else None)
        for name, by_m in rows.items():
            same_rows(name, f"N={n} K={k} bf16", by_m[8], by_m[40])
        del qt
    n = k = 4096
    w = torch.randn((n, k), generator=gen, device=device) * k ** -0.5
    x40 = torch.randn((40, k), generator=gen, device=device).bfloat16()
    for gs in (64, 32):
        qt = quantize(w, granularity="per_group", layout="planar_groups", group_size=gs)
        body = ("tensor cores" if _linear_body("K7", True, torch.bfloat16, gs, 8, n, k) == "mma"
                else "CUDA cores")
        rows = {}
        for m in (8, 40):
            x = x40[:m].contiguous()
            ref = ops.int4_matmul_per_group_reference(x, qt)
            y = rows[m] = ops.int4_matmul_per_group(x, qt)
            _compare("int4_matmul_per_group", f"M={m} N={n} K={k} gs {gs} bf16 ({body})", y, ref,
                     _a16_tol(ref), results, timer, lambda: ops.int4_matmul_per_group(x, qt),
                     lambda: ops.int4_matmul_per_group_reference(x, qt), work=linear_bound(x, qt))
        if gs == 64:
            same_rows("int4_matmul_per_group", f"N={n} K={k} gs {gs} bf16", rows[8], rows[40])
        del qt
    x = x40[:8].contiguous()
    for gs in (64, 32, 16):
        qt = quantize(w, granularity="per_group", layout="planar_groups", group_size=gs)
        body = ("int8 body" if _linear_body("K8", True, torch.bfloat16, gs, 8, n, k) == "int8"
                else "CUDA-core loop")
        ref = ops.int4_matmul_per_group_a8_reference(x, qt)
        _compare("int4_matmul_per_group_a8", f"M=8 N={n} K={k} gs {gs} bf16 ({body})",
                 ops.int4_matmul_per_group_a8(x, qt), ref, _a8_tol(ref), results, None, None,
                 None, exact=True)
        del qt
    n, k = 960, 4096
    qt = _pg_quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
    x = torch.randn((640, k), generator=gen, device=device).bfloat16()
    before = ops.int4_matmul_per_group.wg_launches
    y = ops.int4_matmul_per_group(x, qt)
    if ops.int4_matmul_per_group.wg_launches != before:
        raise AssertionError(f"int4_matmul_per_group M=640 N={n}: took the warpgroup body")
    ref = ops.int4_matmul_per_group_reference(x, qt)
    _compare("int4_matmul_per_group", f"M=640 N={n} K={k} bf16 (tall tile)", y, ref,
             _a16_tol(ref), results, timer, lambda: ops.int4_matmul_per_group(x, qt),
             lambda: ops.int4_matmul_per_group_reference(x, qt), iters=5,
             work=linear_bound(x, qt))


def check_grouped_pg(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    """K13 and K14 at the expert shapes, per group of 128: decode (T=8) at
    tile_m 16 (K13, the per_group mode) and 32 (K14, pg_turbo), and the
    prefill (T=600) at tile_m 128, skewed routing. K13 (bf16 on the
    tensor-core body) is held to its plain version at the w4a16 bars, its
    decode rows to K7's body at the same launch shape bit for bit; K14 (the
    int8 body) must equal its plain version bit for bit in bf16 and f32;
    for both a token's rows must be the same bits in a T=8 and a T=40
    dispatch; then K14 at gs 32
    (the int8 body's 8-byte runs) and gs 16 (the CUDA-core loop), and K10
    and K14 at N=256, where the launch splits K over CTAs (the ordered
    second pass)."""
    for n, k in ((ffn, hidden), (hidden, ffn)):       # gate/up (Gh=16), then down (Gh=56)
        qt = _pg_quantize(torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5)
        for t, tile_m, kernels in ((8, 16, (False,)), (8, 32, (True,)), (600, 128, (False, True))):
            routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
            xs = dispatch(torch.randn((t, k), generator=gen, device=device).bfloat16(),
                          routing, plan)
            gids = plan.tile_group_ids
            pad = xs.abs().sum(dim=1) == 0
            iters = 20 if t == 8 else 3
            for a8 in kernels:
                op = ops.grouped_int4_matmul_per_group_a8 if a8 else ops.grouped_int4_matmul_per_group
                plain = (ops.grouped_int4_matmul_per_group_a8_reference if a8
                         else ops.grouped_int4_matmul_per_group_reference)
                for xx in ((xs, xs.float()) if t == 8 or a8 else (xs,)):  # + f32
                    f32 = xx.dtype == torch.float32
                    ref = plain(xx, gids, qt, tile_m=tile_m)
                    y = op(xx, gids, qt, tile_m=tile_m)
                    torch.cuda.synchronize()
                    if not bool((y[pad] == 0).all()):
                        raise AssertionError(f"{op.__name__}: padding rows are not exactly zero")
                    tol = _a8_tol(ref) if a8 else _a16_tol(ref)
                    _compare(op.__name__,
                             f"T={t} tile_m={tile_m} N={n} K={k}" + (" f32" if f32 else ""),
                             y, ref, tol, results, None if f32 else timer,
                             lambda: op(xx, gids, qt, tile_m=tile_m),
                             lambda: plain(xx, gids, qt, tile_m=tile_m), iters=iters,
                             work=grouped_bound(xx, gids, qt, 2 * t, a8=a8),
                             exact=a8, main="int8_mma_kernel" if a8 else "int4_mma_kernel")
                    if not a8 and not f32 and t == 8:
                        same_as_linear("grouped_int4_matmul_per_group", xx, gids, qt, tile_m, y)
            print(f"    tokens per expert {routing.tokens_per_expert.tolist()}, "
                  f"T_pad {plan.t_pad}")
        same_token_rows("grouped_int4_matmul_per_group", ops.grouped_int4_matmul_per_group,
                        qt, k, e, gen, device, tile_m=16)
        same_token_rows("grouped_int4_matmul_per_group_a8", ops.grouped_int4_matmul_per_group_a8,
                        qt, k, e, gen, device)
        del qt
    w = torch.randn((e, 1024, hidden), generator=gen, device=device) * hidden ** -0.5
    routing, plan = _skewed_plan(8, e, 2, 32, gen, device)
    xs = dispatch(torch.randn((8, hidden), generator=gen, device=device).bfloat16(), routing, plan)
    for gs in (32, 16):
        qt = quantize(w, granularity="per_group", layout="planar_groups", group_size=gs)
        body = ("int8 body" if _grouped_body("K14", True, torch.bfloat16, gs, plan.t_pad, e, 32,
                                             1024, hidden) == "int8" else "CUDA-core loop")
        ref = ops.grouped_int4_matmul_per_group_a8_reference(xs, plan.tile_group_ids, qt, tile_m=32)
        _compare("grouped_int4_matmul_per_group_a8", f"T=8 tile_m=32 N=1024 K={hidden} gs {gs}",
                 ops.grouped_int4_matmul_per_group_a8(xs, plan.tile_group_ids, qt, tile_m=32),
                 ref, _a8_tol(ref), results, None, None, None, exact=True)
        print(f"    gs {gs}: the {body}")
    # a narrow stack, whose launch splits K over CTAs: the ordered second pass
    w = w[:, :256].contiguous()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for op, plain, qt in ((ops.grouped_int4_matmul_a8, ops.grouped_int4_matmul_a8_reference,
                           quantize(w)),
                          (ops.grouped_int4_matmul_per_group_a8,
                           ops.grouped_int4_matmul_per_group_a8_reference, _pg_quantize(w))):
        gs = qt.group_size if qt.granularity == "per_group" else 0
        launch = _a8_mma_launch(256, hidden, gs, sms)
        if launch[2] < 2:
            raise AssertionError(f"{op.__name__} N=256: launch {launch} does not split K")
        ref = plain(xs, plan.tile_group_ids, qt, tile_m=32)
        _compare(op.__name__, f"T=8 tile_m=32 N=256 K={hidden} splits {launch[2]}",
                 op(xs, plan.tile_group_ids, qt, tile_m=32), ref, _a8_tol(ref), results, None,
                 None, None, exact=True)


def _planar_pg_quantize(w):
    """Per group of 128 in the planar layout: what convert_checkpoint gives."""
    return quantize(w, granularity="per_group", layout="planar", group_size=128)


def check_linear_planar_pg(device, results, timer, gen):
    """K6 at the layer2 linear shapes, planar weights per group of 128: the
    decode rows (8), the self-draft verify's (40) and the long prefill's
    (640), bf16 (timed) and f32; rows 0-7 of the 40-row call equal the 8-row
    call bit for bit."""
    for n, k in ((4096, 4096), (1024, 4096), (8192, 4096)):
        qt = _planar_pg_quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
        x640 = torch.randn((640, k), generator=gen, device=device).bfloat16()
        rows = {}
        for m in (8, 40, 640):
            x = x640[:m].contiguous()
            for xx in (x, x.float()):
                f32 = xx.dtype == torch.float32
                ref = ops.int4_matmul_per_group_planar_reference(xx, qt)
                main = (m, n) == (8, 4096) and not f32
                y = ops.int4_matmul_per_group(xx, qt)
                if not f32:
                    rows[m] = y
                _compare("int4_matmul_per_group_planar",
                         f"M={m} N={n} K={k} {'f32' if f32 else 'bf16'}",
                         y, ref, _a16_tol(ref), results,
                         None if f32 else timer, lambda: ops.int4_matmul_per_group(xx, qt),
                         lambda: ops.int4_matmul_per_group_planar_reference(xx, qt),
                         iters=5 if m == 640 else 20, work=linear_bound(xx, qt),
                         library=int4pack_yardstick(xx, qt) if main else None)
        same_rows("int4_matmul_per_group_planar", f"N={n} K={k} bf16", rows[8], rows[40])
        del qt


def same_across_tile_m(name, op, qt, k, e, gen, device, tiles=(16, 32, 64), t=8):
    """One routing of ``t`` tokens dispatched at each tile_m of ``tiles``:
    every token's rows give the same bits at each, though they sit in other
    rows and tiles (the grouped rule reads no tile_m)."""
    routing, _ = _skewed_plan(t, e, 2, tiles[0], gen, device)
    x = torch.randn((t, k), generator=gen, device=device).bfloat16()
    got = []
    for tile_m in tiles:
        plan = make_dispatch_plan(routing, e, tile_m=tile_m)
        got.append(op(dispatch(x, routing, plan), plan.tile_group_ids, qt, tile_m=tile_m)[plan.rows])
    for tile_m, y in zip(tiles[1:], got[1:]):
        if not torch.equal(got[0], y):
            d = (got[0].float() - y.float()).abs().max().item()
            raise AssertionError(f"{name} N={qt.shape[1]} K={k}: token rows differ between "
                                 f"tile_m {tiles[0]} and {tile_m} ({d})")
    print(f"    {name} N={qt.shape[1]} K={k} T={t}: the token rows are the same bits at tile_m "
          f"{', '.join(map(str, tiles))}")


def check_grouped_wg(device, results, timer, gen, e=8):
    """K2 and K13 on the warpgroup body (``csrc/grouped_wgmma.cu``) at the
    benchmark cells' widths and T_pad: K13 per group of 128 at
    Mixtral-8x22B's (gate/up N=16384 K=6144, down N=6144 K=16384; 384
    tokens, T_pad 896 at tile_m 16) and K2 at Mixtral-8x7B's (N=14336
    K=4096, N=4096 K=14336; 576 tokens, T_pad 2176 at tile_m 128), each
    through its public wrapper (which must choose the body) against its
    plain version, under random routing and under a skewed one (one expert
    past 256 rows, some with none), the zero padding rows exactly 0; then
    one skewed routing of 384 tokens at tile_m 16, 32, 64 and 128 (T_pad
    896-1792, all in the body's domain), whose token rows must be the same
    bits at each. Rows print the main kernel's device time."""
    cases = (("grouped_int4_matmul_per_group", ops.grouped_int4_matmul_per_group,
              ops.grouped_int4_matmul_per_group_reference, 384, 16,
              ((16384, 6144), (6144, 16384))),
             ("grouped_int4_matmul", ops.grouped_int4_matmul, ops.grouped_int4_matmul_reference,
              576, 128, ((14336, 4096), (4096, 14336))))
    for name, op, plain, t, tile_m, shapes in cases:
        for n, k in shapes:
            w = torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5
            qt = _pg_quantize(w) if op is ops.grouped_int4_matmul_per_group else quantize(w)
            del w
            for routing_name, skew in (("random", 0.0), ("skewed", 4.0)):
                bias = torch.log(1.0 / (torch.arange(e, device=device) + 1.0)) * skew
                routing = topk_route(bias[None, :] + torch.randn((t, e), generator=gen,
                                                                 device=device), 2, e)
                plan = make_dispatch_plan(routing, e, tile_m=tile_m)
                loads = routing.tokens_per_expert.tolist()
                if skew and not (max(loads) > 256 and min(loads) == 0):
                    raise AssertionError(f"{name}: the skewed routing gave loads {loads}")
                x = torch.randn((t, k), generator=gen, device=device).bfloat16()
                xs, gids = dispatch(x, routing, plan), plan.tile_group_ids
                before = op.wg_launches
                y = op(xs, gids, qt, tile_m=tile_m)
                if op.wg_launches != before + 1:
                    raise AssertionError(f"{name} T_pad={plan.t_pad}: not the warpgroup body")
                ref = plain(xs, gids, qt, tile_m=tile_m)
                torch.cuda.synchronize()
                pad = xs.abs().sum(dim=1) == 0
                if not bool((y[pad] == 0).all()):
                    raise AssertionError(f"{name} warpgroup body: padding rows are not exactly 0")
                _compare(name, f"T={t} tile_m={tile_m} N={n} K={k} wg {routing_name}", y, ref,
                         BF16_REL_TOL * ref.float().abs().max().item(), results,
                         timer if not skew else None,
                         lambda: op(xs, gids, qt, tile_m=tile_m),
                         lambda: plain(xs, gids, qt, tile_m=tile_m), iters=10,
                         work=grouped_bound(xs, gids, qt, 2 * t), main="int4_mma_kernel_wg")
                print(f"    tokens per expert {loads}, T_pad {plan.t_pad}")
            same_across_tile_m(f"{name} (warpgroup body)", op, qt, k, e, gen, device,
                               tiles=(16, 32, 64, 128), t=384)
            del qt
            torch.cuda.empty_cache()


# (N, K) of the per-group cells' K7 linears by their rows: K-EXAONE-236B's
# q, k and v, o, the shared expert's gate/up and down, the dense layer's
# gate/up and down and the LM head at 896; Mixtral-8x22B's q and o, k and v
# and the LM head at 384
PG_LINEAR_SHAPES = {896: ((8192, 6144), (1024, 6144), (6144, 8192), (2048, 6144), (6144, 2048),
                          (18432, 6144), (6144, 18432), (153600, 6144)),
                    384: ((6144, 6144), (1024, 6144), (32768, 6144))}


def check_pg_linear_wg(device, results, timer, gen):
    """K7's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``) at
    the per-group cells' linear shapes (PG_LINEAR_SHAPES), each through the
    public wrapper (which must choose the body) against the plain version,
    a second launch bit-equal to the first; rows print the main kernel's
    device time, the bound and the library call's time. Then the tall tile
    (``int4_mma_kernel<GroupFold, 8, false>``, the launch K7 had at these
    rows before the body, and still has above 64 rows where N is in no
    whole slices of 128) on the same inputs, held to the plain version at
    the same bar and timed."""
    for m, shapes in PG_LINEAR_SHAPES.items():
        for n, k in shapes:
            qt = _pg_quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            before = ops.int4_matmul_per_group.wg_launches
            y = ops.int4_matmul_per_group(x, qt)
            again = ops.int4_matmul_per_group(x, qt)
            if ops.int4_matmul_per_group.wg_launches != before + 2:
                raise AssertionError(f"int4_matmul_per_group M={m} N={n}: not the warpgroup body")
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise AssertionError(f"int4_matmul_per_group M={m} N={n}: two launches differ")
            ref = ops.int4_matmul_per_group_reference(x, qt)
            _compare("int4_matmul_per_group", f"M={m} N={n} K={k} wg", y, ref, _a16_tol(ref),
                     results, timer, lambda: ops.int4_matmul_per_group(x, qt),
                     lambda: ops.int4_matmul_per_group_reference(x, qt), iters=10,
                     work=linear_bound(x, qt), library=int4pack_yardstick(x, qt),
                     main="int4_mma_kernel_wg" if timer else None)

            def tall():
                return _mma._launch(x, qt, "K7")
            _compare("int4_matmul_per_group", f"M={m} N={n} K={k} tall tile", tall(), ref,
                     _a16_tol(ref), results, None, None, None)
            if timer:
                print(f"    tall tile {timer(tall, iters=10):.4f} ms")
            del qt
            torch.cuda.empty_cache()


# (N, K) of Mixtral-8x7B's K1 linears: q and o, k and v, the LM head (on the
# warpgroup body at its cell's 576 rows) and the router (N=8, off it)
K1_LINEAR_SHAPES = ((4096, 4096), (1024, 4096), (32000, 4096))
K1_ROUTER_SHAPE = (8, 4096)
K1_CELL_ROWS = 576


def _replays(fn):
    """``fn()``'s output after each of two replays of one CUDA graph that
    captured it (warmed on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    return first, out.clone()


def check_linear_wg(device, results, timer, gen):
    """K1's tall calls on the warpgroup body (``csrc/grouped_wgmma.cu``,
    ``int4_mma_kernel_wg<RowScale, false>``) at Mixtral-8x7B's linear shapes
    at its cell's 576 rows and at 65, each through the public wrapper (which
    must choose the body) against the plain version at the bf16 bar, equal
    bit for bit to two replays of a CUDA graph that captured it; at least
    one shape's launch cuts slices into ranges of K (the ordered second
    pass). At 576 rows the rows print the main kernel's device time, the
    bound, the library call's time and the dense path's (dequantize +
    matmul, the path these calls had before the body). The router's width
    (N=8) keeps its path: no launch on the body."""
    sms = _front._sm_count(torch.device(device).index or 0)
    cut = 0
    for n, k in K1_LINEAR_SHAPES:
        qt = quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
        for m in (K1_CELL_ROWS, WG_MIN_LINEAR_ROWS):
            x = torch.randn((m, k), generator=gen, device=device).bfloat16()
            before = ops.int4_matmul.wg_launches
            y = ops.int4_matmul(x, qt)
            if ops.int4_matmul.wg_launches != before + 1:
                raise AssertionError(f"int4_matmul M={m} N={n}: not the warpgroup body")
            first, second = _replays(lambda: ops.int4_matmul(x, qt))
            if not (torch.equal(y, first) and torch.equal(y, second)):
                raise AssertionError(f"int4_matmul M={m} N={n}: graph replays differ")
            full, splits, _ = _wg._wg_linear_launch(m, n, k, sms, "K1")
            cut += full < (n // _wg._WG_SLICE) * -(-m // _wg._WG_ROWS)
            ref = ops.int4_matmul_reference(x, qt)
            cell = m == K1_CELL_ROWS
            _compare("int4_matmul", f"M={m} N={n} K={k} wg {full},{splits}", y, ref,
                     _a16_tol(ref), results, timer if cell else None,
                     lambda: ops.int4_matmul(x, qt), lambda: ops.int4_matmul_reference(x, qt),
                     iters=10, work=linear_bound(x, qt),
                     library=int4pack_yardstick(x, qt) if cell else None,
                     main="int4_mma_kernel_wg" if timer and cell else None)
            if timer and cell:
                dense = timer(lambda: ops.int4_matmul(x, qt, prefill_threshold=0), iters=10)
                print(f"    dense path {dense:.4f} ms")
        del qt
        torch.cuda.empty_cache()
    if not cut:
        raise AssertionError("int4_matmul: no launch cut a slice into ranges of K")
    n, k = K1_ROUTER_SHAPE
    qt = quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
    x = torch.randn((K1_CELL_ROWS, k), generator=gen, device=device).bfloat16()
    before = ops.int4_matmul.wg_launches
    y = ops.int4_matmul(x, qt)
    if ops.int4_matmul.wg_launches != before:
        raise AssertionError(f"int4_matmul M={K1_CELL_ROWS} N={n}: the router took the body")
    ref = ops.int4_matmul_reference(x, qt)
    _compare("int4_matmul", f"M={K1_CELL_ROWS} N={n} K={k} router", y, ref, _a16_tol(ref),
             results, None, None, None)


def check_grouped_planar_pg(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    """K12 at the expert shapes, planar weights per group of 128: decode
    (T=8, tile_m 16; f32 too) and the prefill (T=600, tile_m 128), skewed
    routing, zero padding rows exactly 0. bf16 (the tensor-core body) prints
    the main kernel's device time; its decode rows equal K6's body at the
    same launch shape, and a token's rows are the same bits in a T=8 and a
    T=40 dispatch and at tile_m 16, 32 and 64. f32 (the CUDA-core loop) is
    held to its plain version."""
    for n, k in ((ffn, hidden), (hidden, ffn)):       # gate/up (Gh=16), then down (Gh=56)
        qt = _planar_pg_quantize(torch.randn((e, n, k), generator=gen, device=device)
                                 * k ** -0.5)
        for t, tile_m in ((8, 16), (600, 128)):
            routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
            xs = dispatch(torch.randn((t, k), generator=gen, device=device).bfloat16(),
                          routing, plan)
            gids = plan.tile_group_ids
            pad = xs.abs().sum(dim=1) == 0
            for xx in ((xs, xs.float()) if t == 8 else (xs,)):
                f32 = xx.dtype == torch.float32
                ref = ops.grouped_int4_matmul_per_group_planar_reference(xx, gids, qt,
                                                                         tile_m=tile_m)
                y = ops.grouped_int4_matmul_per_group(xx, gids, qt, tile_m=tile_m)
                torch.cuda.synchronize()
                if not bool((y[pad] == 0).all()):
                    raise AssertionError("K12: padding rows are not exactly zero")
                _compare("grouped_int4_matmul_per_group_planar",
                         f"T={t} tile_m={tile_m} N={n} K={k}" + (" f32" if f32 else ""),
                         y, ref, _a16_tol(ref), results, None if f32 else timer,
                         lambda: ops.grouped_int4_matmul_per_group(xx, gids, qt, tile_m=tile_m),
                         lambda: ops.grouped_int4_matmul_per_group_planar_reference(
                             xx, gids, qt, tile_m=tile_m),
                         iters=20 if t == 8 else 3, work=grouped_bound(xx, gids, qt, 2 * t),
                         main=None if f32 else "int4_mma_kernel")
                if not f32 and t == 8:
                    same_as_linear("grouped_int4_matmul_per_group_planar", xx, gids, qt, tile_m, y)
            print(f"    tokens per expert {routing.tokens_per_expert.tolist()}, "
                  f"T_pad {plan.t_pad}")
        same_token_rows("grouped_int4_matmul_per_group_planar", ops.grouped_int4_matmul_per_group,
                        qt, k, e, gen, device, tile_m=16)
        same_across_tile_m("grouped_int4_matmul_per_group_planar",
                           ops.grouped_int4_matmul_per_group, qt, k, e, gen, device)
        del qt


def check_ksplit(device, results, timer, gen, e=8, ffn=14336, hidden=4096):
    """K9 (``mode="ksplit"``) on the down stack (N=4096, K=14336) at T=8
    (tile_m 16; f32 too) and T=600 (tile_m 128), skewed routing: against
    K2's plain version and against K2 on the same inputs, at K2's bars,
    padding rows exactly 0; K2 is timed before and after K9, and bf16 rows
    print the main kernel's and the second pass's device time. A token's
    rows are the same bits in a T=8 and a T=40 dispatch and at tile_m 16, 32
    and 64 (the launch rule reads no T or tile_m), and a narrow stack
    (N=256) splits K/2 over many CTAs."""
    n, k = hidden, ffn
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qt = quantize(torch.randn((e, n, k), generator=gen, device=device) * k ** -0.5)
    for t, tile_m in ((8, 16), (600, 128)):
        routing, plan = _skewed_plan(t, e, 2, tile_m, gen, device)
        xs = dispatch(torch.randn((t, k), generator=gen, device=device).bfloat16(), routing, plan)
        gids = plan.tile_group_ids
        pad = xs.abs().sum(dim=1) == 0
        iters = 20 if t == 8 else 5
        for xx in ((xs, xs.float()) if t == 8 else (xs,)):
            f32 = xx.dtype == torch.float32
            ref = ops.grouped_int4_matmul_reference(xx, gids, qt, tile_m=tile_m)
            y = ops.grouped_int4_matmul(xx, gids, qt, tile_m=tile_m, mode="ksplit")
            y2 = ops.grouped_int4_matmul(xx, gids, qt, tile_m=tile_m)
            torch.cuda.synchronize()
            if not bool((y[pad] == 0).all()):
                raise AssertionError("K9: padding rows are not exactly zero")
            tol = _a16_tol(ref)
            k2_err = (y.float() - y2.float()).abs().max().item()
            if not k2_err <= tol:
                raise AssertionError(f"K9 vs K2 T={t}: max|d| {k2_err} > {tol}")
            k2 = (lambda: ops.grouped_int4_matmul(xx, gids, qt, tile_m=tile_m))
            k9 = (lambda: ops.grouped_int4_matmul(xx, gids, qt, tile_m=tile_m, mode="ksplit"))
            k2_ms = [timer(k2, iters=iters)] if timer and not f32 else []
            _compare("grouped_int4_matmul_ksplit",
                     f"T={t} tile_m={tile_m} N={n} K={k}" + (" f32" if f32 else ""), y, ref, tol,
                     results, None if f32 else timer, k9,
                     lambda: ops.grouped_int4_matmul_reference(xx, gids, qt, tile_m=tile_m),
                     iters=iters, work=grouped_bound(xx, gids, qt, 2 * t),
                     main=None if f32 else "int4_mma_kernel")
            if k2_ms:
                k2_ms.append(timer(k2, iters=iters))
                second = timer.device_ms(k9, "int4_mma_reduce_kernel")
                print(f"    K9 second pass {second:.4f} ms")
            launch = (f"{_ksplit_splits(plan.t_pad, n, k, 8, sms)} splits" if f32
                      else f"launch {_ksplit_mma_launch(n, k, sms)}")
            print(f"    K9 {launch}; K9 vs K2 on the same inputs max|d| {k2_err:.3e} "
                  f"(tol {tol:.3e}); K2 {', '.join(f'{v:.4f}' for v in k2_ms) or 'untimed'} ms "
                  f"(before, after K9)")
        print(f"    tokens per expert {routing.tokens_per_expert.tolist()}, T_pad {plan.t_pad}")
        if t == 8:
            # the first 256 rows of each expert: K9 splits K/2 over many CTAs
            sub = dataclasses.replace(qt, packed=qt.packed[:, :256].contiguous(),
                                      scales=qt.scales[:, :256].contiguous(),
                                      zero_points=qt.zero_points[:, :256].contiguous(),
                                      shape=(e, 256, k))
            y = ops.grouped_int4_matmul(xs, gids, sub, tile_m=tile_m, mode="ksplit")
            ref = ops.grouped_int4_matmul_reference(xs, gids, sub, tile_m=tile_m)
            torch.cuda.synchronize()
            if not bool((y[pad] == 0).all()):
                raise AssertionError("K9 N=256: padding rows are not exactly zero")
            _compare("grouped_int4_matmul_ksplit",
                     f"T={t} tile_m={tile_m} N=256 K={k} launch {_ksplit_mma_launch(256, k, sms)}",
                     y, ref, _a16_tol(ref), results, None, None, None)
    k9 = functools.partial(ops.grouped_int4_matmul, mode="ksplit")
    same_token_rows("grouped_int4_matmul_ksplit", k9, qt, k, e, gen, device, tile_m=16)
    same_across_tile_m("grouped_int4_matmul_ksplit", k9, qt, k, e, gen, device)
    del qt


def check_int8_paths(device, results, timer, gen, m=640, n=4096, k=4096):
    """The integer-GEMM prefill paths (no kernel of their own: torch._int_mm)
    at one prefill shape: the resident i8 copy (xla_turbo) against the
    transient unpack (u4_turbo). Both compute the same integers."""
    qt = quantize(torch.randn((n, k), generator=gen, device=device) * k ** -0.5)
    w8 = ops.to_int8_resident(qt)
    x = torch.randn((m, k), generator=gen, device=device).bfloat16()
    y_res, y_tr = ops.int8_linear(x, w8), ops.int4_linear_transient(x, qt)
    if not torch.equal(y_res, y_tr):
        raise AssertionError("int8_linear and int4_linear_transient differ")
    ref = ops.int4_matmul_a8_reference(x, qt)
    _compare("int8_linear", f"M={m} N={n} K={k} bf16", y_res, ref, _a8_tol(ref), results, timer,
             lambda: ops.int8_linear(x, w8), lambda: ops.int4_linear_transient(x, qt))
    print("    (plain = int4_linear_transient: unpack to i8 per call, then the same GEMM)")


def _filled_cache(b, h_kv, s_max, d, lengths, gen, device):
    cache = QuantizedKVCache.init(b, h_kv, s_max, d, device=device)
    kv = torch.randn((2, b, h_kv, s_max - 1, d), generator=gen, device=device)
    cache.append(kv[0], kv[1], start=torch.zeros(b, dtype=torch.int32, device=device))
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32, device=device))
    return cache


def attention_bound(q, cache, starts, t) -> dict:
    """Attention of t query rows per slot from ``starts``: q and the packed
    K/V bytes and scale/zero-point planes of the positions in use read once,
    the output written once; 4*D operations per (query head, query, key)
    pair under the causal mask."""
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    h_kv = cache.k_packed.shape[1]
    used = sum(int(s) + t for s in starts.tolist())
    pairs = sum(t * int(s) + t * (t + 1) // 2 for s in starts.tolist())
    kv = 2 * h_kv * used * (d // 2 + 2 * 4)    # K and V: D/2 packed bytes + scale + zp
    return bound(2 * nbytes(q) + nbytes(cache.lengths) + kv, 4.0 * hq * d * pairs, "bf16")


def sdpa_yardstick(q, cache):
    """One PyTorch call for decode attention (a library yardstick, used
    nowhere in the port): ``scaled_dot_product_attention`` over the cache
    dequantized to q's type beforehand (K/V heads repeated to the query
    heads), with each slot's length as the mask. It reads bf16 K/V, four
    times the packed bytes."""
    kd, vd = cache.dequantize(dtype=q.dtype)
    rep = q.shape[1] // kd.shape[1]
    kd, vd = kd.repeat_interleave(rep, dim=1), vd.repeat_interleave(rep, dim=1)
    mask = (torch.arange(kd.shape[2], device=q.device)[None, None, None, :]
            < cache.lengths[:, None, None, None])
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=mask)


def check_attention(device, results, timer, gen, b=8, hq=32, h_kv=8, d=128, s_max=256):
    lengths = [(1, 2, 37, 255)[i % 4] for i in range(b)]
    cache = _filled_cache(b, h_kv, s_max, d, lengths, gen, device)
    q = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    ref = ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1)[:, :, 0]
    y = ops.int4_decode_attention(q, cache)
    _compare("int4_attention", f"decode B={b} lengths {sorted(set(lengths))}", y, ref,
             ATTN_ABS_TOL, results, timer, lambda: ops.int4_decode_attention(q, cache),
             lambda: ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1),
             work=attention_bound(q, cache, cache.lengths - 1, 1),
             library=sdpa_yardstick(q, cache))
    # a decode over 4096 positions: 16 CTAs per row, their partials merged
    # in order by the second pass
    lengths_l = [(4095, 4000, 2049, 1)[i % 4] for i in range(b)]
    long = _filled_cache(b, h_kv, 4096, d, lengths_l, gen, device)
    ql = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    starts_l = long.lengths - 1
    _compare("int4_attention", f"decode B={b} 4096 positions, lengths {sorted(set(lengths_l))}",
             ops.int4_decode_attention(ql, long),
             ops.int4_attention_reference(ql[:, :, None], long, starts_l)[:, :, 0],
             ATTN_ABS_TOL, results, timer, lambda: ops.int4_decode_attention(ql, long),
             lambda: ops.int4_attention_reference(ql[:, :, None], long, starts_l), iters=10,
             work=attention_bound(ql, long, starts_l, 1), library=sdpa_yardstick(ql, long))
    del long
    qf = q.float()  # the f32 instantiation
    _compare("int4_attention", f"decode B={b} f32", ops.int4_decode_attention(qf, cache),
             ops.int4_attention_reference(qf[:, :, None], cache, cache.lengths - 1)[:, :, 0],
             ATTN_ABS_TOL, results, None, None, None)
    # a 32-token prefill chunk starting at odd positions
    t = 32
    starts = torch.tensor([(1, 37, 101, 223)[i % 4] for i in range(b)], dtype=torch.int32,
                          device=device)
    cache.lengths.copy_(starts + t)
    q = torch.randn((b, hq, t, d), generator=gen, device=device).bfloat16()
    ref = ops.int4_attention_reference(q, cache, starts)
    y = ops.int4_prefill_attention(q, cache, starts)
    _compare("int4_attention", f"prefill B={b} T={t} starts odd", y, ref, ATTN_ABS_TOL,
             results, timer, lambda: ops.int4_prefill_attention(q, cache, starts),
             lambda: ops.int4_attention_reference(q, cache, starts),
             work=attention_bound(q, cache, starts, t))
    # the long prefill of phase 6: 2 rows of 320 tokens from position 0
    b, t = 2, 320
    cache = QuantizedKVCache.init(b, h_kv, t, d, device=device)
    kv = torch.randn((2, b, h_kv, t, d), generator=gen, device=device)
    starts = torch.zeros(b, dtype=torch.int32, device=device)
    cache.append(kv[0], kv[1], start=starts)
    q = torch.randn((b, hq, t, d), generator=gen, device=device).bfloat16()
    ref = ops.int4_attention_reference(q, cache, starts)
    _compare("int4_attention", f"prefill B={b} T={t} start 0", ops.int4_prefill_attention(
             q, cache, starts), ref, ATTN_ABS_TOL, results, timer,
             lambda: ops.int4_prefill_attention(q, cache, starts),
             lambda: ops.int4_attention_reference(q, cache, starts), iters=5,
             work=attention_bound(q, cache, starts, t))


def paged_copy(cache, page, device):
    """A page pool holding the contiguous ``cache``'s bytes page by page at
    shuffled, non-identity page ids (page 0 parked), with its lengths."""
    b, h_kv, s2, _ = cache.k_packed.shape
    mp = 2 * s2 // page
    paged = PagedKVCache.init(b, h_kv, cache.head_dim, num_pages=b * mp + 1, page_size=page,
                              max_pages_per_slot=mp, device=device)
    table = (torch.randperm(b * mp, generator=torch.Generator().manual_seed(5)) + 1).reshape(b, mp)
    paged.page_table.copy_(table)
    ids = table.reshape(-1).to(device)

    def split(t, n):  # [B, H, mp*n, ...] -> [B*mp, H, n, ...] in table order
        rest = tuple(t.shape[3:])
        return t.reshape(b, h_kv, mp, n, *rest).transpose(1, 2).reshape(b * mp, h_kv, n, *rest)

    for pool, packed in ((paged.k_pool, cache.k_packed), (paged.v_pool, cache.v_packed)):
        pool[ids] = split(packed, page // 2)
    for f in ("k_scale", "k_zp", "v_scale", "v_zp"):
        getattr(paged, f)[ids] = split(getattr(cache, f), page)
    paged.lengths.copy_(cache.lengths)
    return paged


def paged_attention_bound(q, cache, starts, t) -> dict:
    """K3' for t query rows per slot from ``starts``: q read and the output
    written once, the table, lengths and starts read once, and the positions
    in use read once through the table (packed K and V, D/2 bytes per
    position each, and the four f32 planes), on K3's scale
    (:func:`attention_bound`); 4*D operations per (query head, query, key)
    pair under the causal mask."""
    hq, d = q.shape[1], q.shape[-1]
    h_kv = cache.k_pool.shape[1]
    used = sum(int(s) + t for s in starts.tolist())
    kv = h_kv * used * (d + 4 * 4)
    pairs = sum(t * int(s) + t * (t + 1) // 2 for s in starts.tolist())
    return bound(2 * nbytes(q) + nbytes(cache.page_table, cache.lengths, starts) + kv,
                 4.0 * hq * d * pairs, "bf16")


def check_paged_attention(device, results, timer, gen, b=8, hq=32, h_kv=8, d=128, page=128):
    """K3' at the layer2 attention shapes on a pool whose pages hold a
    contiguous cache's bytes in shuffled order: equal to K3 on that cache bit
    for bit, and within K3's bar of its plain version. Decode in bf16 and
    f32 (lengths odd and even, one past a page boundary), and a 2 x 320-token
    prefill from odd starts (chunks beginning mid-page)."""
    lengths = [(1, 2, 37, 255, 129, 128, 200, 77)[i % 8] for i in range(b)]
    cache = _filled_cache(b, h_kv, 256, d, lengths, gen, device)
    paged = paged_copy(cache, page, device)
    q = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    for qq in (q, q.float()):
        bf16 = qq.dtype == torch.bfloat16
        y = ops.int4_decode_attention(qq, paged)
        torch.cuda.synchronize()
        if not torch.equal(y, ops.int4_decode_attention(qq, cache)):
            raise AssertionError(f"K3' decode {qq.dtype}: not bit-equal to K3 on the same bytes")
        starts = paged.lengths - 1
        _compare("paged_int4_attention", f"decode B={b} page {page} {'bf16' if bf16 else 'f32'}",
                 y, ops.paged_int4_attention_reference(qq[:, :, None], paged, starts)[:, :, 0],
                 ATTN_ABS_TOL, results, timer if bf16 else None,
                 lambda: ops.int4_decode_attention(qq, paged),
                 lambda: ops.paged_int4_attention_reference(qq[:, :, None], paged, starts),
                 work=paged_attention_bound(qq, paged, starts, 1),
                 library=sdpa_yardstick(qq, paged.logical()) if bf16 else None)
    print(f"    K3' == K3 bit for bit at decode (bf16, f32), lengths {sorted(set(lengths))}")
    b, t = 2, 320
    starts = torch.tensor([1, 67], dtype=torch.int32, device=device)
    cache = _filled_cache(b, h_kv, 512, d, (starts + t).tolist(), gen, device)
    paged = paged_copy(cache, page, device)
    q = torch.randn((b, hq, t, d), generator=gen, device=device).bfloat16()
    y = ops.int4_prefill_attention(q, paged, starts)
    torch.cuda.synchronize()
    if not torch.equal(y, ops.int4_prefill_attention(q, cache, starts)):
        raise AssertionError("K3' prefill: not bit-equal to K3 on the same bytes")
    _compare("paged_int4_attention", f"prefill B={b} T={t} starts odd", y,
             ops.paged_int4_attention_reference(q, paged, starts), ATTN_ABS_TOL, results, timer,
             lambda: ops.int4_prefill_attention(q, paged, starts),
             lambda: ops.paged_int4_attention_reference(q, paged, starts), iters=5,
             work=paged_attention_bound(q, paged, starts, t))
    print(f"    K3' == K3 bit for bit at the {b} x {t} prefill from starts {starts.tolist()}")


def check_decode_equals_prefill(device, gen, b=8, hq=32, h_kv=8, d=128):
    """The self-draft verify's case at the layer2 attention shape: each
    decode row at position p (K3, and K3' on a pool holding the same bytes)
    equals, bit for bit, the row at p of a T=5 chunked prefill over the same
    cache whose query 4, 2 or 0 sits at p (query 2 lands in the upper half
    of the tensor-core tile, query 4 in a second query tile)."""
    lengths = [(1, 2, 37, 250, 129, 128, 200, 77)[i % 8] for i in range(b)]
    cache = _filled_cache(b, h_kv, 256, d, lengths, gen, device)
    paged = paged_copy(cache, 128, device)
    q = torch.randn((b, hq, d), generator=gen, device=device).bfloat16()
    pos = cache.lengths.long() - 1
    rows = torch.arange(b, device=device)
    for name, c in (("K3", cache), ("K3'", paged)):
        dec = ops.int4_decode_attention(q, c)
        for query in (4, 2, 0):
            starts = (pos - query).clamp(min=0)
            at = pos - starts
            q5 = torch.randn((b, hq, 5, d), generator=gen, device=device).bfloat16()
            q5[rows, :, at] = q
            c.lengths.copy_(starts + 5)
            y5 = ops.int4_prefill_attention(q5, c, starts.to(torch.int32))
            c.lengths.copy_(pos + 1)
            torch.cuda.synchronize()
            if not torch.equal(y5[rows, :, at], dec):
                d_max = (y5[rows, :, at].float() - dec.float()).abs().max().item()
                raise AssertionError(f"{name}: decode rows differ from the T=5 prefill's rows "
                                     f"(query {query}): max|d| {d_max}")
    print(f"    K3 and K3': decode rows == T=5 prefill rows bit for bit (queries 4, 2, 0), "
          f"lengths {sorted(set(lengths))}")


# K-EXAONE's window layers: 8 KV heads of 128, 8 query heads each, a window
# of 128 over a prompt of 2048, at the benchmark cell's 896 rows
WINDOW_SHAPE = dict(b=896, h_kv=8, g=8, d=128, window=128, context=2048)


def window_bound(q, h_kv, window, t) -> dict:
    """Windowed attention of t query rows a slot: q, the packed K/V bytes and
    planes of the ``window`` visible positions of each query read once (a
    chunk's rows share all but t - 1 of them), the output written once; 4*D
    operations per (query head, query, visible key) pair."""
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    used = b * (window + t - 1)
    kv = 2 * h_kv * used * (d // 2 + 2 * 4)
    return bound(2 * nbytes(q) + 4 * b + kv, 4.0 * hq * d * b * t * window, "bf16")


def _ring_cache(gen, device, b, h_kv, d, window, context, max_tokens):
    """A window layer's ring for forwards of up to ``max_tokens`` positions,
    holding the last of ``context`` seeded positions: wrapped many times."""
    cache = QuantizedKVCache.init(b, h_kv, context + 128, d, device=device, window=window,
                                  max_tokens=max_tokens)
    for p0 in range(0, context, 512):
        kv = torch.randn((2, b, h_kv, 512, d), generator=gen, device=device)
        cache.append(kv[0], kv[1], start=torch.full((b,), p0, dtype=torch.int32, device=device))
    return cache


def window_model_launches(device) -> dict:
    """The main path's windowed launches: one decode step of a small
    K-EXAONE-shaped model (q 1024 wide at hidden 512, two "LLLG" periods of
    window 8, a dense first layer, a shared expert, a sigmoid router, 4 of
    16 experts held) through its own forward, the
    counters reset just before it. Six of the eight K3 launches run over a
    window."""
    cfg = ModelConfig(
        name="k-exaone-small", moe=MoEConfig("k-exaone-small", 16, 512, 512, 4),
        num_layers=8, num_heads=8, num_kv_heads=2, head_dim=128, vocab_size=512,
        max_seq_len=64, rope_theta=1e6, rms_eps=1e-5, hidden_size=512,
        windows=(8, 8, 8, 0) * 2, dense_layers=1, dense_ffn=1024, shared_ffn=512,
        router="sigmoid", routed_scale=2.5, block="exaone4", first_expert=4, held_experts=4)
    model = QuantizedTransformer.init(cfg, generator=torch.Generator(device=device).manual_seed(5),
                                      device=device)
    caches = model.init_cache(cfg, 4, cfg.max_seq_len, max_tokens=20)
    tokens = torch.randint(1, cfg.vocab_size, (4, 21), device=device,
                           generator=torch.Generator(device=device).manual_seed(6))
    model(tokens[:, :20], caches, torch.arange(20, device=device))
    _reset_counts()
    model(tokens[:, 20:], caches, torch.tensor([20], device=device))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _launch_counts().items() if v}
    if (launches.get("int4_attention"), launches.get("int4_attention_window")) != (8, 6):
        raise AssertionError(f"k-exaone-small decode step: K3 launches {launches}, want 8 "
                             "of which 6 over a window")
    return launches


def check_window_attention(device="cuda", timer=None, results=None):
    """K3, K3' and the multi-token path with a window against their plain
    versions at the K-EXAONE cell's shapes: decode over a wrapped ring of
    window + 1 slots (the cell's), a 32-position chunk over a ring sized for
    it whose first queries need the keys before it, and K3' over full pages
    with the window a mask; then the main path's windowed launch count."""
    results = [] if results is None else results
    gen = torch.Generator(device=device).manual_seed(22)
    sh = WINDOW_SHAPE
    b, h_kv, g, d, w, ctx = (sh[k] for k in ("b", "h_kv", "g", "d", "window", "context"))
    ring = _ring_cache(gen, device, b, h_kv, d, w, ctx, 1)
    if not (ring.ring and ring.max_seq == w + 2):
        raise AssertionError(f"a decode ring of window {w} holds {ring.max_seq} slots")
    for pos in range(ctx, ctx + 32):       # a replay's 32 steps; three checked
        kv = torch.randn((2, b, h_kv, 1, d), generator=gen, device=device)
        ring.append(kv[0], kv[1], start=torch.full((b,), pos, dtype=torch.int32, device=device))
        if pos not in (ctx, ctx + 1, ctx + 31):
            continue
        q = torch.randn((b, h_kv * g, d), generator=gen, device=device).bfloat16()
        starts = ring.lengths - 1
        before = ops.int4_attention.window_launches
        y = ops.int4_decode_attention(q, ring)
        if ops.int4_attention.window_launches != before + 1:
            raise AssertionError("K3 over a ring did not count a windowed launch")
        _compare("int4_attention", f"window {w} decode B={b} ring {ring.max_seq} pos {pos}", y,
                 ops.int4_attention_reference(q[:, :, None], ring, starts)[:, :, 0],
                 ATTN_ABS_TOL, results, timer if pos == ctx else None,
                 lambda: ops.int4_decode_attention(q, ring),
                 lambda: ops.int4_attention_reference(q[:, :, None], ring, starts),
                 work=window_bound(q, h_kv, w, 1))
    del ring
    t = 32
    chunk = _ring_cache(gen, device, b, h_kv, d, w, ctx, t)
    starts = torch.full((b,), ctx, dtype=torch.int32, device=device)
    kv = torch.randn((2, b, h_kv, t, d), generator=gen, device=device)
    chunk.append(kv[0], kv[1], start=starts)
    q = torch.randn((b, h_kv * g, t, d), generator=gen, device=device).bfloat16()
    _compare("int4_attention", f"window {w} chunk B={b} T={t} ring {chunk.max_seq}",
             ops.int4_prefill_attention(q, chunk, starts),
             ops.int4_attention_reference(q, chunk, starts), ATTN_ABS_TOL, results, None,
             None, None)
    del chunk, q, kv
    pb, page, pages = 64, 128, (ctx + 128) // 128
    paged = PagedKVCache.init(pb, h_kv, d, num_pages=pb * pages + 1, page_size=page,
                              max_pages_per_slot=pages, device=device, window=w)
    for r in range(pb):
        paged.assign_pages(r, range(1 + r * pages, 1 + (r + 1) * pages))
    for p0 in range(0, ctx + t, page):
        n = min(page, ctx + t - p0)
        kv = torch.randn((2, pb, h_kv, n, d), generator=gen, device=device)
        paged.append(kv[0], kv[1], start=torch.full((pb,), p0, dtype=torch.int32, device=device))
    starts = torch.full((pb,), ctx, dtype=torch.int32, device=device)
    q = torch.randn((pb, h_kv * g, t, d), generator=gen, device=device).bfloat16()
    _compare("paged_int4_attention", f"window {w} chunk B={pb} T={t} page {page}",
             ops.int4_prefill_attention(q, paged, starts),
             ops.paged_int4_attention_reference(q, paged, starts), ATTN_ABS_TOL, results, None,
             None, None)
    last = paged.lengths - 1
    _compare("paged_int4_attention", f"window {w} decode B={pb} page {page}",
             ops.int4_decode_attention(q[:, :, -1], paged),
             ops.paged_int4_attention_reference(q[:, :, -1:], paged, last)[:, :, 0],
             ATTN_ABS_TOL, results, None, None, None)
    del paged
    torch.cuda.empty_cache()
    launches = window_model_launches(device)
    print(f"    windowed K3 launches of one k-exaone-small decode step: "
          f"{launches['int4_attention_window']} of {launches['int4_attention']}")
    return launches

# DeepSeek-V3's latent attention (K15) at its cell's shapes: 256 sequences
# of 2049-2080 positions in latent caches of 2176, 128 heads, a latent of
# 512 and a RoPE key of 64, at the model's softmax scale (192^-0.5 times
# YaRN's mscale(40, 1) squared)
MLA_SHAPE = dict(b=256, heads=128, latent=512, rope=64, capacity=2176, lengths=(2049, 2081))
MLA_SCALE = 192 ** -0.5 * (0.1 * math.log(40.0) + 1.0) ** 2


def latent_cache(gen, device, b, capacity, lengths):
    """A latent cache whose rows hold ``lengths`` positions of seeded c_KV
    (of unit RMS, as the model's RMSNorm leaves it) and k_pe."""
    sh = MLA_SHAPE
    cache = LatentKVCache.init(b, capacity, sh["latent"], sh["rope"], device=device)
    top = int(lengths.max())
    c = torch.randn((b, top, sh["latent"]), generator=gen, device=device).bfloat16()
    pe = torch.randn((b, top, sh["rope"]), generator=gen, device=device).bfloat16()
    cache.append(c, pe, start=torch.zeros(b, dtype=torch.int32, device=device))
    cache.lengths.copy_(lengths.to(torch.int32))
    return cache


def mla_queries(gen, device, b, t):
    """(q_lat [H, B * T, L], q_pe [B, T, H, R]) in bf16, seeded."""
    sh = MLA_SHAPE
    q_lat = (torch.randn((sh["heads"], b * t, sh["latent"]), generator=gen, device=device)
             * 0.3).bfloat16()
    q_pe = torch.randn((b, t, sh["heads"], sh["rope"]), generator=gen, device=device).bfloat16()
    return q_lat, q_pe


def mla_bound(q_lat, q_pe, cache, starts, t) -> dict:
    """Latent attention of t query rows a slot from ``starts``: each seen
    position's codes, scale, zero point and k_pe read once (a chunk's rows
    share them), q read and the output written once; per (head, query,
    seen position) 2 (L + R) operations for the scores and 2 L for the
    output."""
    h, _, l = q_lat.shape
    r = q_pe.shape[-1]
    used = int((starts.long() + t).sum())
    pairs = sum(t * int(s) + t * (t + 1) // 2 for s in starts.tolist())
    cached = used * (l // 2 + 8 + 2 * r)
    return bound(cached + 2 * nbytes(q_lat) + nbytes(q_pe), 2.0 * h * (2 * l + r) * pairs, "bf16")


def mla_sdpa_yardstick(q_lat, q_pe, cache, scale):
    """One PyTorch call for decode latent attention (a library yardstick,
    used nowhere in the port): ``scaled_dot_product_attention`` over the
    latent dequantized to bf16 beforehand, with the heads as the query rows
    of one KV head (q = [q_lat | q_pe], k = [c_KV | k_pe], v = c_KV) and
    each slot's length as the mask. It reads bf16 c_KV, four times the
    codes' bytes. [H, B, L] out."""
    h, b, l = q_lat.shape
    c, pe = cache.dequantize(dtype=torch.bfloat16)
    k, v = torch.cat([c, pe], dim=-1)[:, None], c[:, None]                # [B, 1, S, .]
    q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)[:, None]   # [B, 1, H, L + R]
    mask = (torch.arange(c.shape[1], device=c.device)[None, None, None, :]
            < cache.lengths[:, None, None, None])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)[
        :, 0].transpose(0, 1)


def _mla_tol(ref):
    return BF16_REL_TOL * float(ref.float().abs().max())


def check_mla_cell(device="cuda", timer=None, results=None):
    """K15 at the DeepSeek-V3 cell's shapes against its plain version
    (``ops.mla_attention_reference``, the same sum in f32 on the card) at
    chip_smoke's bf16 bar; two launches bit-equal. With a timer, K15, the
    plain version and the SDPA yardstick are timed beside K15's bound."""
    results = [] if results is None else results
    gen = torch.Generator(device=device).manual_seed(26)
    sh = MLA_SHAPE
    b = sh["b"]
    lengths = torch.randint(*sh["lengths"], (b,), generator=gen, device=device)
    cache = latent_cache(gen, device, b, sh["capacity"], lengths)
    q_lat, q_pe = mla_queries(gen, device, b, 1)
    starts = (lengths - 1).to(torch.int32)
    before = ops.mla_attention.launches
    y = ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE)
    again = ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE)
    if ops.mla_attention.launches != before + 2:
        raise AssertionError("mla_attention: two calls did not count two launches")
    if not torch.equal(y, again):
        raise AssertionError("mla_attention: two launches on the same inputs differ")
    ref = ops.mla_attention_reference(q_lat, q_pe, cache, starts, MLA_SCALE)
    _compare("mla_attention", MAIN_SHAPE["mla_attention"], y, ref, _mla_tol(ref), results, timer,
             lambda: ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE),
             lambda: ops.mla_attention_reference(q_lat, q_pe, cache, starts, MLA_SCALE),
             work=mla_bound(q_lat, q_pe, cache, starts, 1),
             library=mla_sdpa_yardstick(q_lat, q_pe, cache, MLA_SCALE))
    print("    mla_attention: two launches bit-equal")
    return results


def check_mla_ragged(device="cuda", results=None):
    """K15 over a ragged batch of lengths 1-4095 in caches of 4096: two
    segments a row, merged in order; two launches bit-equal."""
    results = [] if results is None else results
    gen = torch.Generator(device=device).manual_seed(27)
    b = 24
    lengths = torch.randint(1, 4096, (b,), generator=gen, device=device)
    lengths[0], lengths[1] = 1, 4095
    cache = latent_cache(gen, device, b, 4096, lengths)
    if -(-cache.max_seq // _mla_segment(cache.max_seq)) != 2:
        raise AssertionError(f"a latent cache of {cache.max_seq} is not cut in two segments")
    q_lat, q_pe = mla_queries(gen, device, b, 1)
    starts = (lengths - 1).to(torch.int32)
    y = ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE)
    ref = ops.mla_attention_reference(q_lat, q_pe, cache, starts, MLA_SCALE)
    _compare("mla_attention", f"decode B={b} H=128 lengths 1-4095, 2 segments", y, ref,
             _mla_tol(ref), results, None, None, None)
    if not torch.equal(y, ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE)):
        raise AssertionError("mla_attention over two segments: two launches differ")
    return results


def check_mla_prefill_rows(device="cuda", results=None):
    """A chunk of 4 queries a row against the plain version, and each of
    its rows equal to a decode call at that position bit for bit (the
    segments read neither T nor the lengths)."""
    results = [] if results is None else results
    gen = torch.Generator(device=device).manual_seed(28)
    b, t, h, l = 8, 4, MLA_SHAPE["heads"], MLA_SHAPE["latent"]
    lengths = torch.randint(100, 4000, (b,), generator=gen, device=device)
    cache = latent_cache(gen, device, b, 4096, lengths)
    q_lat, q_pe = mla_queries(gen, device, b, t)
    starts = (lengths - t).to(torch.int32)
    y = ops.mla_attention(q_lat, q_pe, cache, starts, MLA_SCALE)
    ref = ops.mla_attention_reference(q_lat, q_pe, cache, starts, MLA_SCALE)
    _compare("mla_attention", f"prefill B={b} T={t} H=128", y, ref, _mla_tol(ref), results,
             None, None, None)
    rows = y.reshape(h, b, t, l)
    for i in range(t):
        one = ops.mla_attention(q_lat.reshape(h, b, t, l)[:, :, i].contiguous(),
                                q_pe[:, i:i + 1].contiguous(), cache, starts + i, MLA_SCALE)
        if not torch.equal(one, rows[:, :, i]):
            raise AssertionError(f"mla_attention: prefill row {i} differs from its decode call")
    print(f"    mla_attention: the {t} rows of a T={t} chunk equal decode calls bit for bit")
    return results


def check_mla_absorption(device="cuda", results=None):
    """W_UK^T (128 heads of [512, 128] per row: K2, one chunk of K) and
    W_UV (128 heads of [128, 512] per group of 128: K13) over 256 rows a
    head, as ``MLAttention`` calls them, against the grouped matmul's plain
    versions."""
    results = [] if results is None else results
    gen = torch.Generator(device=device).manual_seed(29)
    h, l, rows, tile = MLA_SHAPE["heads"], MLA_SHAPE["latent"], MLA_SHAPE["b"], MLAttention.TILE_M
    kv_b = torch.randn((h * 256, l), generator=gen, device=device) * l ** -0.5
    w_uk, w_uv = MLAttention.absorbed(kv_b, h, 128)
    if (w_uk.weight.granularity, w_uv.weight.granularity) != ("per_row", "per_group"):
        raise AssertionError(f"absorbed layout {w_uk.weight.granularity}, "
                             f"{w_uv.weight.granularity}")
    gids = torch.div(torch.arange(h * rows // tile, dtype=torch.int32, device=device),
                     rows // tile, rounding_mode="floor")
    for name, w, op, plain, k in (
            ("W_UK^T", w_uk, ops.grouped_int4_matmul, ops.grouped_int4_matmul_reference, 128),
            ("W_UV", w_uv, ops.grouped_int4_matmul_per_group,
             ops.grouped_int4_matmul_per_group_reference, l)):
        x = torch.randn((h * rows, k), generator=gen, device=device).bfloat16()
        ref = plain(x, gids, w.weight, tile_m=tile)
        _compare(op.__name__, f"absorb {name} H={h} rows {rows} tile_m={tile}",
                 op(x, gids, w.weight, tile_m=tile), ref, _mla_tol(ref), results, None, None,
                 None)
    return results


def mla_model_launches(device) -> dict:
    """The main path's K15 launches: one decode step of a small
    DeepSeek-V3-shaped model (K15's widths: 64 heads, a latent of 512, a
    RoPE key of 64, YaRN x40; hidden 512, q rank 256, one dense layer and
    two MoE layers of 16 experts in 4 groups, the best 2 kept, top-4, a
    shared expert, experts 4-7 held) through its own forward after a
    20-token prefill, the counters reset just before it: one K15 launch a
    layer, no plain version."""
    cfg = dataclasses.replace(
        DEEPSEEK_V3_671B, name="deepseek-v3-small",
        moe=MoEConfig("deepseek-v3-small", 16, 512, 512, 4), num_layers=3, num_heads=64,
        num_kv_heads=64, vocab_size=512, max_seq_len=64, hidden_size=512, dense_layers=1,
        dense_ffn=1024, shared_ffn=512, n_group=4, topk_group=2, q_lora_rank=256,
        first_expert=4, held_experts=4)
    model = QuantizedTransformer.init(cfg, generator=torch.Generator(device=device).manual_seed(7),
                                      device=device)
    caches = model.init_cache(cfg, 4, cfg.max_seq_len)
    tokens = torch.randint(1, cfg.vocab_size, (4, 21), device=device,
                           generator=torch.Generator(device=device).manual_seed(8))
    model(tokens[:, :20], caches, torch.arange(20, device=device))
    _reset_counts()
    logits = model(tokens[:, 20:], caches, torch.tensor([20], device=device))[0]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _launch_counts().items() if v}
    if launches.get("mla_attention") != cfg.num_layers or _plain_calls():
        raise AssertionError(f"deepseek-v3-small decode step: launches {launches}, plain "
                             f"versions {_plain_calls()}; want {cfg.num_layers} K15 launches")
    if not torch.isfinite(logits).all():
        raise AssertionError("deepseek-v3-small decode step: non-finite logits")
    return launches


def check_mla_attention(device="cuda", timer=None, results=None):
    """K15 against its plain version at the DeepSeek-V3 cell's shapes
    (timed, beside its bound and the SDPA yardstick), over two segments,
    a chunk's rows against decode calls, the absorption's grouped calls at
    the cell's shapes; then the main path's K15 launch count."""
    results = [] if results is None else results
    check_mla_cell(device, timer, results)
    check_mla_ragged(device, results)
    check_mla_prefill_rows(device, results)
    check_mla_absorption(device, results)
    torch.cuda.empty_cache()
    launches = mla_model_launches(device)
    print(f"    K15 launches of one deepseek-v3-small decode step: "
          f"{launches['mla_attention']} ({launches})")
    return launches


def check_kernels(device="cuda", timing=True):
    """Phase 3: every kernel against its plain version at the layer2 shapes."""
    gen = torch.Generator(device=device).manual_seed(1)
    timer = Timer(device) if timing else None
    results = []
    check_linear(device, results, timer, gen)
    check_grouped(device, results, timer, gen)
    check_attention(device, results, timer, gen)
    check_paged_attention(device, results, timer, gen)
    check_decode_equals_prefill(device, gen)
    check_linear_a8(device, results, timer, gen)
    check_grouped_a8(device, results, timer, gen)
    check_linear_pg(device, results, timer, gen)
    check_grouped_pg(device, results, timer, gen)
    check_grouped_wg(device, results, timer, gen)
    check_pg_linear_wg(device, results, timer, gen)
    check_linear_wg(device, results, timer, gen)
    check_linear_planar_pg(device, results, timer, gen)
    check_grouped_planar_pg(device, results, timer, gen)
    check_ksplit(device, results, timer, gen)
    check_int8_paths(device, results, timer, gen)
    torch.cuda.empty_cache()
    return results


# the per-group kernels, each with one launch counter
_PG_OPS = (ops.int4_matmul_per_group, ops.int4_matmul_per_group_a8,
           ops.grouped_int4_matmul_per_group, ops.grouped_int4_matmul_per_group_a8)
_PATH_CALLS = (ops.int4_linear_transient, ops.int4_grouped_transient, ops.int8_linear,
               ops.int8_grouped_capacity)
_reset_counts, _launch_counts, _plain_calls = ops.reset_counts, ops.launch_counts, ops.plain_calls


def _expect_launches(what, launches, launched, idle):
    """Raise unless every kernel in ``launched`` ran and none in ``idle`` did."""
    missing = [k for k in launched if launches[k] == 0]
    extra = [k for k in idle if launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{what}: never launched {missing}, launched unexpectedly {extra}: "
                             f"{launches}")
    if _plain_calls():
        raise AssertionError(f"{what}: ran a plain version {_plain_calls()} times")


def build_layer2(device="cuda", scale="layer2"):
    cfg = flagship_model_config(scale)
    t0 = time.perf_counter()
    model = QuantizedTransformer.init(cfg, generator=torch.Generator(device=device).manual_seed(0),
                                      device=device)
    torch.cuda.synchronize()
    print(f"{cfg.name} built in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return model, cfg


SERVE_LENGTHS = [3, 70, 12, 33, 45, 64, 7, 20, 50, 66, 5, 31]   # 1 to 3 prefill chunks


def phase4_requests(cfg):
    """The 12 requests of phase 4, prompts from a seeded generator, budgets
    of 8 to 16 new tokens."""
    rng = np.random.default_rng(0)
    return [GenerationRequest(uid=uid, prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                              max_new_tokens=8 + (5 * uid) % 9)
            for uid, n in enumerate(SERVE_LENGTHS)]


def _generated(eng) -> int:
    return sum(map(len, eng.generated.values())) + sum(map(len, eng.finished.values()))


def _serve_loop(eng):
    """Step ``eng`` until every request is done. Returns the wall ms of each
    pure decode step (no admission) and the number of steps in which a
    request waited in the queue beside a free slot."""
    decode_ms, waits = [], 0
    with torch.no_grad():
        while eng.active or eng.queue:
            queued = len(eng.queue)
            s0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if len(eng.queue) == queued:  # no admission: a pure decode step
                decode_ms.append((time.perf_counter() - s0) * 1e3)
            waits += bool(eng.queue) and len(eng.active) < eng.num_slots
    return decode_ms, waits


def serve(model, cfg, mode, card_line="", reqs=None, **engine_kw):
    """The continuous-batching server on ``reqs`` (phase 4's 12 requests by
    default), 8 slots, max_seq 256, prefill bucket 32; ``engine_kw`` picks
    the paged cache, decode blocks or a draft model. Checks that every
    request met its budget. Returns the kernel launches of the run, the
    engine, and the number of steps in which a request waited in the queue
    beside a free slot."""
    reqs = phase4_requests(cfg) if reqs is None else reqs
    eng = ServingEngine(model, cfg, **{**dict(num_slots=8, max_seq=256, prefill_bucket=32),
                                       **engine_kw})
    for r in reqs:
        eng.submit(r)
    _reset_counts()
    t0 = time.perf_counter()
    decode_ms, waits = _serve_loop(eng)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    for r in reqs:
        got = eng.finished.get(r.uid)
        if got is None or len(got) != r.max_new_tokens:
            raise AssertionError(f"serve [{mode}] uid {r.uid}: "
                                 f"{None if got is None else len(got)} tokens, want "
                                 f"{r.max_new_tokens}")
        if not all(0 <= tok < cfg.vocab_size for tok in got):
            raise AssertionError(f"serve [{mode}] uid {r.uid}: token out of the vocabulary")
    tokens = sum(r.max_new_tokens for r in reqs)
    print(f"serve [{mode}]: {len(reqs)} requests, {tokens} tokens in {wall:.2f} s wall "
          f"({tokens / wall:.1f} tok/s), decode {statistics.median(decode_ms):.2f} ms/step "
          f"median over {len(decode_ms)} steps, taken on {card_line}")
    print(f"serve [{mode}]: kernel launches {launches}, plain-version calls {_plain_calls()}")
    return launches, eng, waits


def _same_first_tokens(what, got, ref):
    """Raise unless every request's first token equals the reference run's;
    returns how many whole sequences are identical."""
    differ = [uid for uid in ref if got[uid][0] != ref[uid][0]]
    if differ:
        raise AssertionError(f"{what}: first tokens differ from the reference run for uids "
                             f"{differ}")
    return sum(got[uid] == ref[uid] for uid in ref)


_DEFAULT_KERNELS = ("int4_matmul", "grouped_int4_matmul")


def serve_paged(model, cfg, ref, card_line):
    """Paged serving on layer2, default mode: phase 4's 12 requests with
    page 128 and a pool of 5 usable pages for 8 slots, so that admission
    waits for retirements; then 8 requests whose 160-token prompts share
    their first 128 tokens, with prefix caching, against a contiguous run
    of the same requests. Returns the launches of the first run."""
    launches, eng, waits = serve(model, cfg, "paged", card_line, paged=True, page_size=128,
                                 num_pages=6)
    _expect_launches("serve [paged]", launches, _DEFAULT_KERNELS + ("paged_int4_attention",),
                     ("int4_attention",))
    if waits == 0:
        raise AssertionError("serve [paged]: admission never waited for pages")
    same = _same_first_tokens("serve [paged]", eng.finished, ref)
    contiguous = ServingEngine(model, cfg, num_slots=8, max_seq=256, prefill_bucket=32)
    pool_bytes = sum(c.nbytes for c in eng.caches)
    cont_bytes = sum(c.nbytes for c in contiguous.caches)
    del contiguous
    print(f"serve [paged]: every first token equals the contiguous run's; {same} of "
          f"{len(ref)} sequences identical; admission waited in {waits} steps; pool "
          f"{pool_bytes} bytes ({eng.num_pages} pages of {eng.page_size}) against "
          f"{cont_bytes} for the contiguous cache of the same engine (8 slots x 256)")
    rng = np.random.default_rng(6)
    prefix = rng.integers(1, cfg.vocab_size, 128).tolist()
    reqs = [GenerationRequest(uid=uid, prompt=prefix + rng.integers(1, cfg.vocab_size, 32).tolist(),
                              max_new_tokens=8) for uid in range(8)]
    launches_pre, eng_pre, _ = serve(model, cfg, "paged, shared 128-token prefix", card_line,
                                     reqs=reqs, paged=True, page_size=128)
    _expect_launches("serve [paged prefix]", launches_pre,
                     _DEFAULT_KERNELS + ("paged_int4_attention",), ("int4_attention",))
    stats = eng_pre.prefix_stats
    if stats["hits"] != 7 or stats["shared_tokens"] != 7 * 128:
        raise AssertionError(f"serve [paged prefix]: prefix_stats {stats}, want 7 hits and "
                             f"{7 * 128} shared tokens")
    _, eng_ref, _ = serve(model, cfg, "contiguous, same prefix requests", card_line, reqs=reqs)
    same = _same_first_tokens("serve [paged prefix]", eng_pre.finished, eng_ref.finished)
    print(f"serve [paged prefix]: prefix_stats {stats}; every first token equals the "
          f"contiguous run's, {same} of {len(reqs)} sequences identical")
    return launches


def decode_ms_per_token(model, cfg, decode_block, steps=64, **engine_kw):
    """Steady decode on layer2: 8 slots filled in one step (20-token
    prompts), then ``steps`` decode steps timed on the host clock, each
    engine step ending in a device sync; ms per generated token."""
    rng = np.random.default_rng(8)
    eng = ServingEngine(model, cfg, num_slots=8, max_seq=256, prefill_bucket=32,
                        decode_block=decode_block, **engine_kw)
    for uid in range(8):
        eng.submit(GenerationRequest(uid=uid, prompt=rng.integers(1, cfg.vocab_size, 20).tolist(),
                                     max_new_tokens=1 + decode_block + steps))
    with torch.no_grad():
        eng.step()   # admits every slot, then the first block
        torch.cuda.synchronize()
        before = _generated(eng)
        t0 = time.perf_counter()
        for _ in range(steps // decode_block):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall * 1e3 / (_generated(eng) - before)


def serve_blocks(model, cfg, ref, card_line):
    """decode_block=8 on layer2: the 12 requests on the contiguous cache and
    on a paged one of page 64 (uid 8 decodes positions 50-65, a block across
    a page boundary). Token counts and greedy tokens must equal the
    decode_block=1 run's. Then steady decode ms per generated token at
    decode_block 1 and 8, in the order 1, 8, 8, 1."""
    for mode, kw in (("contiguous, decode_block=8", {}),
                     ("paged page 64, decode_block=8", dict(paged=True, page_size=64))):
        launches, eng, _ = serve(model, cfg, mode, card_line, decode_block=8, **kw)
        attn = "paged_int4_attention" if kw else "int4_attention"
        _expect_launches(f"serve [{mode}]", launches, _DEFAULT_KERNELS + (attn,), ())
        differ = [uid for uid in ref if eng.finished[uid] != ref[uid]]
        if differ:
            raise AssertionError(f"serve [{mode}]: tokens differ from decode_block=1 for uids "
                                 f"{differ}")
        print(f"serve [{mode}]: token counts and tokens equal the decode_block=1 run's")
    for paged in (False, True):
        kw = dict(paged=True, page_size=128) if paged else {}
        ms = {}
        for block in (1, 8, 8, 1):
            ms.setdefault(block, []).append(decode_ms_per_token(model, cfg, block, **kw))
        print(f"steady decode [{'paged' if paged else 'contiguous'}], 8 slots, 64 steps: "
              f"ms per generated token, decode_block=1 {ms[1]}, decode_block=8 {ms[8]} "
              f"(order 1, 8, 8, 1; {card_line})")


def serve_speculative(model, cfg, ref, card_line, device="cuda"):
    """Speculative serving on layer2: the engine with the model as its own
    draft (gamma 4) must accept every draft and give phase 4's tokens; then
    speculative_generate with an independent draft of the same vocabulary
    (`small`, random weights) on 4 prompts, every emitted token greedy under
    a fresh teacher-forced layer2 forward within JAX's tie band of 0.2."""
    launches, eng, _ = serve(model, cfg, "speculative, self-draft gamma 4", card_line,
                             draft_model=model, spec_gamma=4)
    _expect_launches("serve [speculative]", launches, _DEFAULT_KERNELS + ("int4_attention",),
                     ("paged_int4_attention",))
    rate = eng.spec_stats.acceptance_rate
    differ = [uid for uid in ref if eng.finished[uid] != ref[uid]]
    if rate != 1.0 or differ:
        raise AssertionError(f"serve [speculative]: acceptance {rate}, tokens differ from the "
                             f"default run for uids {differ}")
    print(f"serve [speculative]: self-draft acceptance {rate}, {eng.spec_stats.rounds} rounds, "
          f"tokens equal the default run's")
    small_cfg = flagship_model_config("small")
    draft = QuantizedTransformer.init(small_cfg, device=device,
                                      generator=torch.Generator(device=device).manual_seed(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 17, 33, 9)]
    t0 = time.perf_counter()
    out, stats = speculative_generate(model, draft, cfg, small_cfg, prompts, gamma=4,
                                      max_new_tokens=16)
    wall = time.perf_counter() - t0
    worst = 0.0
    with torch.no_grad():
        for prompt, got in zip(prompts, out):
            seq = prompt + got
            caches = model.init_cache(cfg, 1, ((len(seq) + 2) // 2) * 2)
            logits, _ = model(torch.tensor([seq[:-1]], dtype=torch.int32, device=device), caches,
                              torch.arange(len(seq) - 1, dtype=torch.int32, device=device))
            rows = logits[0, len(prompt) - 1:].float()
            top2 = rows.topk(2, dim=-1)
            for i, tok in enumerate(got):
                best, second = top2.indices[i].tolist()
                gap = (top2.values[i, 0] - top2.values[i, 1]).item()
                if not (tok == best or (tok == second and gap < SPEC_TIE_BAND)):
                    raise AssertionError(f"speculative_generate: token {tok} at step {i} is not "
                                         f"greedy (top-2 {best}, {second}, gap {gap})")
                if tok != best:
                    worst = max(worst, gap)
    print(f"speculative_generate [layer2 target, small draft]: {len(prompts)} prompts x 16 "
          f"tokens greedy under teacher forcing (largest tie-band gap used {worst:.4f}), "
          f"acceptance {stats.acceptance_rate:.4f} over {stats.rounds} rounds, {wall:.2f} s")
    del draft


def op_entry_points(device="cuda", gen=None, e=8, ffn=14336, hidden=4096):
    """Phase 5: the op entry points whose kernels the layer2 serving paths do
    not take, called as a user would at layer2 widths: the w4a8 linear at
    deep K, where the fuse gate picks K4 by itself, the w4a8 grouped product
    with ``fuse_quant=True`` (K11), and the down projection's experts
    through ``MoEINT4(..., mode="ksplit")`` at a decode step (K9; its output
    held against K2's on the same inputs). Returns the kernel launches."""
    gen = gen or torch.Generator(device=device).manual_seed(3)
    qt = quantize(torch.randn((hidden, ffn), generator=gen, device=device) * ffn ** -0.5)
    x = torch.randn((8, ffn), generator=gen, device=device).bfloat16()
    routing, plan = _skewed_plan(8, e, 2, 32, gen, device)
    xs = dispatch(torch.randn((8, hidden), generator=gen, device=device).bfloat16(), routing, plan)
    qe = quantize(torch.randn((e, ffn, hidden), generator=gen, device=device) * hidden ** -0.5)
    down = MoEINT4.from_dense(torch.randn((e, hidden, ffn), generator=gen, device=device)
                              * ffn ** -0.5)
    routing16, plan16 = _skewed_plan(8, e, 2, 16, gen, device)
    xd = dispatch(torch.randn((8, ffn), generator=gen, device=device).bfloat16(), routing16,
                  plan16)
    _reset_counts()
    y = ops.int4_matmul_a8(x, qt)
    ye = ops.grouped_int4_matmul_a8(xs, plan.tile_group_ids, qe, tile_m=32, fuse_quant=True)
    yd = down(xd, plan16.tile_group_ids, tile_m=16, mode="ksplit")
    torch.cuda.synchronize()
    launches = _launch_counts()
    if not (torch.isfinite(y).all() and torch.isfinite(ye).all() and torch.isfinite(yd).all()):
        raise AssertionError("op entry points: non-finite output")
    _expect_launches("op entry points", launches,
                     ("int4_matmul_a8", "grouped_int4_matmul_a8_fused",
                      "grouped_int4_matmul_ksplit"),
                     ("int4_matmul_a8_fused", "grouped_int4_matmul_a8", "grouped_int4_matmul"))
    y2 = down(xd, plan16.tile_group_ids, tile_m=16)           # K2, outside the counted run
    tol = BF16_REL_TOL * y2.float().abs().max().item()
    err = (yd.float() - y2.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"MoEINT4 mode='ksplit' vs K2: max|d| {err} > {tol}")
    print(f"op entry points: kernel launches {launches}; MoEINT4(mode='ksplit') vs K2 "
          f"max|d| {err:.3e} (tol {tol:.3e})")
    del qt, qe, down
    torch.cuda.empty_cache()
    return launches


def _prefill_logits(model, cfg, tokens):
    b, t = tokens.shape
    caches = model.init_cache(cfg, b, t)
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    logits, _ = model(tokens, caches, positions)
    return logits.float()


def as_pg_turbo(model):
    """The serving benchmark's pg_turbo mode: w4a8 over per-group weights."""
    return as_turbo(as_per_group(model))


# Long prefill, per mode: the converter (from the default model and its
# per-group copy), the kernels it must launch, and the integer-GEMM paths it
# must call at 640 rows.
PREFILL_MODES = (
    ("u4_turbo", lambda m, pg: as_u4_turbo(m), (),
     ("int4_linear_transient", "int4_grouped_transient")),
    ("turbo", lambda m, pg: as_turbo(m), ("int4_matmul_a8_fused", "grouped_int4_matmul_a8"), ()),
    ("xla_turbo", lambda m, pg: as_xla_turbo(m), (), ("int8_linear", "int8_grouped_capacity")),
    ("per_group", lambda m, pg: pg,
     ("int4_matmul_per_group", "grouped_int4_matmul_per_group", "int4_matmul"), ()),
    ("pg_turbo", lambda m, pg: as_turbo(pg),
     ("int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8"), ()),
)


def long_prefill(model, pg, cfg, device="cuda", b=2, t=320):
    """Phase 6: one forward of b x t tokens (640 rows: past the 256-row
    transient gate and the 512-row MoE prefill threshold) per w4a8 and
    per-group mode. Returns the kernel launches of each mode's run.

    Checks that each mode took its prefill paths, that xla_turbo (resident
    i8) and u4_turbo (transient i8) give the same logits bit for bit, and
    that turbo (kernels K5 and K10) agrees with u4_turbo (integer GEMMs and
    the capacity layout) to the cosine bar, over each row's last-position
    logits and over all its positions. The cosines against the default
    (w4a16) mode are printed: with random weights the router flips the
    expert pair of a share of the tokens between w4a16 and w4a8, in the JAX
    package as in the port (tests/test_torch_model.py), and per-group
    requantization moves every weight, so they are measurements here, not
    bars. The per-group modes must run K7/K8 at 640 rows and K13/K14 at
    tile_m 128 and give finite logits; per_group also K1, its per-row
    router's kernel (640 rows lie under K1's PREFILL_THRESHOLD), which the
    other modes must not launch."""
    tokens = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab_size, (b, t))
                              ).to(device)
    logits, all_launches = {}, {}
    with torch.no_grad():
        base = _prefill_logits(model, cfg, tokens)
        for mode, conv, launched, called in PREFILL_MODES:
            _reset_counts()
            got = _prefill_logits(conv(model, pg), cfg, tokens)
            torch.cuda.synchronize()
            launches = _launch_counts()
            paths = {fn.__name__: fn.calls for fn in _PATH_CALLS}
            if not torch.isfinite(got).all():
                raise AssertionError(f"long prefill [{mode}]: non-finite logits")
            if not all(paths[name] for name in called):
                raise AssertionError(f"long prefill [{mode}]: prefill paths not taken {paths}")
            _expect_launches(f"long prefill [{mode}]", launches, launched,
                             [k for k in ("int4_matmul", "grouped_int4_matmul")
                              if k not in launched])
            print(f"long prefill [{mode}] {b}x{t}: vs default, {_cosines(got, base)[2]}; "
                  f"launches {launches}, integer-GEMM calls {paths}")
            logits[mode] = got
            all_launches[mode] = launches
    if not torch.equal(logits["xla_turbo"], logits["u4_turbo"]):
        raise AssertionError("long prefill: xla_turbo and u4_turbo logits differ")
    last, rows, text = _cosines(logits["turbo"], logits["u4_turbo"])
    print(f"long prefill: xla_turbo == u4_turbo bit for bit; turbo vs u4_turbo, "
          f"{text} (bars {PREFILL_COS_LAST} on the last position, "
          f"{PREFILL_COS_ALL} on all positions)")
    if last.min().item() <= PREFILL_COS_LAST or rows.min().item() <= PREFILL_COS_ALL:
        raise AssertionError(f"long prefill: turbo vs u4_turbo cos {last.tolist()}, "
                             f"{rows.tolist()}")
    print(f"long prefill: pg_turbo vs per_group, {_cosines(logits['pg_turbo'], logits['per_group'])[2]}")
    return all_launches


def _cosines(got, ref):
    """Cosines of two [B, T, V] logits: each row's last position and each
    row's T positions together, and a line that adds the spread of the B*T
    per-position cosines."""
    b = got.shape[0]
    last = F.cosine_similarity(got[:, -1], ref[:, -1], dim=-1)
    rows = F.cosine_similarity(got.reshape(b, -1), ref.reshape(b, -1), dim=-1)
    per_pos = F.cosine_similarity(got, ref, dim=-1)
    return last, rows, (f"cos of last-position logits {last.tolist()}, of all positions "
                        f"{rows.tolist()}, per position min {per_pos.min().item():.4f} and "
                        f"share < 0.98 {(per_pos < 0.98).float().mean().item():.4f}")


def whole_model(device="cuda", mode="kernel", convert=None, paged=False):
    """Phase 9: the tiny model, same weights, card (kernels) vs CPU (plain),
    after the converter of ``mode`` on each side; with ``paged``, on paged
    caches of page 32 with the same shuffled page assignment on both."""
    cfg = flagship_model_config("tiny")
    cpu = QuantizedTransformer.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = copy.deepcopy(cpu).to(device)
    if convert is not None:
        cpu, gpu = convert(cpu), convert(gpu)
    caches = None
    if paged:
        kw = dict(num_pages=5, page_size=32, max_pages_per_slot=2)
        caches = [tuple(c.assign_pages(0, [3, 1]).assign_pages(1, [4, 2])
                        for c in m.init_paged_cache(cfg, 2, **kw))
                  for m in (cpu, gpu)]
        mode += ", paged"
    card_vs_cpu(cpu, gpu, cfg, f"tiny model [{mode}]", caches, device)


def card_vs_cpu(cpu, gpu, cfg, what, caches=None, device="cuda"):
    """The same model on the card (kernels) and on the CPU (plain versions):
    a 2 x 12-token prefill then 3 decode steps fed the CPU's greedy token;
    logits within MODEL_REL_TOL of their max and the card's next token in
    the CPU's top-2 at every step. ``caches``: (CPU's, card's), contiguous
    of 64 positions by default."""
    b, t, max_seq = 2, 12, 64
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, t)))
    caches_c, caches_g = caches or (cpu.init_cache(cfg, b, max_seq),
                                    gpu.init_cache(cfg, b, max_seq))
    positions = torch.arange(t, dtype=torch.int32)
    worst = 0.0
    with torch.no_grad():
        for step in range(4):  # one prefill, then 3 decode steps on the CPU's greedy token
            ref, caches_c = cpu(tokens, caches_c, positions)
            got, caches_g = gpu(tokens.to(device), caches_g, positions.to(device))
            ref, got = ref.float(), got.float().cpu()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{what} step {step}: bad output {tuple(got.shape)}")
            err = (got - ref).abs().max().item()
            tol = MODEL_REL_TOL * ref.abs().max().item()
            worst = max(worst, err / tol)
            top2 = ref[:, -1].topk(2, dim=-1).indices
            nxt = got[:, -1].argmax(dim=-1)
            if err > tol or not all(nxt[i] in top2[i] for i in range(b)):
                raise AssertionError(f"{what} step {step}: max|d| {err} (tol {tol}), "
                                     f"argmax {nxt.tolist()} vs CPU top-2 {top2.tolist()}")
            tokens = ref[:, -1].argmax(dim=-1)[:, None]
            positions = torch.tensor([t + step], dtype=torch.int32)
    print(f"{what}: card vs CPU over prefill + 3 decode steps, "
          f"worst max|d|/tol {worst:.3f}, argmax in CPU top-2: ok")


# --- the conversion path: a dense checkpoint into an INT4 model ---------------

SEEDED_TOKENS = "seeded"   # awq_tokens: 8 x 128 token ids from a seeded generator
CONVERSIONS = (
    # (name, convert_checkpoint's arguments, kernels the serve must launch, and must not)
    ("per_row", {}, _DEFAULT_KERNELS + ("int4_attention",),
     ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar")),
    # the router is dense (a plain matmul): no K1 launch at all
    ("per_group128", dict(granularity="per_group", group_size=128),
     ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar", "int4_attention"),
     ("int4_matmul", "grouped_int4_matmul", "int4_matmul_per_group",
      "grouped_int4_matmul_per_group")),
    # AWQ rescales the dense weights and nothing after: per_row's kernels
    ("per_row_awq", dict(awq_tokens=SEEDED_TOKENS), _DEFAULT_KERNELS + ("int4_attention",),
     ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar")),
)


def full_width_conversion(card_line, device="cuda"):
    """Phase 7: a seeded dense layer2 checkpoint (Mixtral-8x7B layer widths,
    2 layers) converted on the card. Quantizing one full-width expert weight
    per format on the card gives the CPU's bytes; then the checkpoint is
    converted per row, per group of 128, and per row after AWQ equalization
    calibrated on 8 x 128 seeded token ids (the alpha of each of its 5
    sites printed), and each model serves phase 4's 12 requests: per row
    and AWQ on K1, K2 and K3, per group on K6, K12 and K3, with no plain
    version. Returns the launches of each serve."""
    cfg = flagship_model_config("layer2")
    params = SeededCheckpoint(cfg, device)
    w = params["layers.0.moe.experts.0.w1.weight"]
    for kw in (dict(), dict(granularity="per_group", layout="planar", group_size=128),
               dict(granularity="per_tensor")):
        on_card, on_cpu = quantize(w, **kw), quantize(w.cpu(), **kw)
        for field in ("packed", "scales", "zero_points"):
            if not torch.equal(getattr(on_card, field).cpu(), getattr(on_cpu, field)):
                raise AssertionError(f"quantize {kw or 'per_row'} {tuple(w.shape)}: {field} on "
                                     "the card differ from the CPU's")
    print(f"quantize on the card == on the CPU, byte for byte: {tuple(w.shape)} per_row, "
          "per_group 128 planar and per_tensor (packed, scales, zero points)")
    del w, on_card, on_cpu
    runs = {}
    for name, kw, launched, idle in CONVERSIONS:
        if kw.get("awq_tokens") == SEEDED_TOKENS:
            gen = torch.Generator(device=device).manual_seed(5)
            kw = dict(kw, awq_tokens=torch.randint(0, cfg.vocab_size, (8, 128), generator=gen,
                                                   device=device))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = convert_checkpoint(params, cfg, device=device, **kw)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        print(f"convert_checkpoint [{name}] layer2: {time.perf_counter() - t0:.2f} s, model "
              f"{held / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB on the card during the "
              f"conversion, taken on {card_line}")
        if model.awq_alphas is not None:
            print(f"convert_checkpoint [{name}] layer2: alpha chosen at each AWQ site "
                  f"{model.awq_alphas} (None: the identity)")
        launches, _, _ = serve(model, cfg, f"converted {name}", card_line)
        _expect_launches(f"serve [converted {name}]", launches, launched, idle)
        runs[name] = launches
        del model
        torch.cuda.empty_cache()
    return runs


H256 = "tests/fixtures/tiny_trained_h256_s1400.safetensors"
JAX_QUALITY_RECORD = "benchmark/results/quality_trained_h256.json"
CORPUS_HEAD = "corpus_head"   # awq_tokens: the fixture's calibration rows (calibration_tokens)
# The JAX quality record's seven policies, with its keyword arguments
# (benchmark/run_quality_eval.py)
QUALITY_POLICIES = {
    "int4_router_dense": dict(quantize_router=False),
    "int4_all_quantized": dict(quantize_router=True),
    "int4_per_group64": dict(granularity="per_group", group_size=64),    # the golden path
    "int4_per_group128": dict(granularity="per_group", group_size=128),  # K6, K12
    "int4_per_tensor": dict(quantize_router=False, granularity="per_tensor"),  # golden path
    "int4_awq": dict(quantize_router=False, awq_tokens=CORPUS_HEAD),               # K1, K2
    "int4_awq_per_group64": dict(quantize_router=False, granularity="per_group", group_size=64,
                                 awq_tokens=CORPUS_HEAD),
}
# each AWQ policy and the policy of the same granularity without AWQ
AWQ_BASELINES = {"int4_awq": "int4_router_dense", "int4_awq_per_group64": "int4_per_group64"}


def calibration_tokens(path, seq=128, rows=8):
    """The AWQ calibration sample, cut as the JAX package's quality
    evaluation cuts it: 8 rows of 128 bytes, evenly strided over the corpus
    before its 90 % mark (the held-out tail starts there)."""
    corpus = np.fromfile(path.replace(".safetensors", ".corpus"), np.uint8)
    head = corpus[: int(len(corpus) * 0.9)]
    hb = head[: (len(head) // seq) * seq].reshape(-1, seq)
    return hb[:: max(1, hb.shape[0] // rows)][:rows].astype(np.int64)


def policy_kwargs(label, path) -> dict:
    """convert_checkpoint's arguments of one quality policy on the fixture
    at ``path`` (the calibration rows in place of CORPUS_HEAD)."""
    kw = QUALITY_POLICIES[label]
    if kw.get("awq_tokens") == CORPUS_HEAD:
        kw = dict(kw, awq_tokens=calibration_tokens(path))
    return kw


def fixture_config(path) -> ModelConfig:
    """The trained fixture's geometry, from the JSON beside it."""
    with open(path.replace(".safetensors", ".json")) as f:
        c = json.load(f)["config"]
    return ModelConfig(
        name="tiny-trained", moe=MoEConfig("tiny-trained-moe", c["num_experts"],
                                           c["num_heads"] * c["head_dim"], c["ffn_dim"],
                                           c["top_k"]),
        num_layers=c["num_layers"], num_heads=c["num_heads"], num_kv_heads=c["num_kv_heads"],
        head_dim=c["head_dim"], vocab_size=c["vocab_size"], max_seq_len=256)


def heldout_tokens(path, seq=128, rows=16):
    """The held-out tail (past 90 %) of the fixture's corpus snapshot, cut
    as the JAX package's quality evaluation cuts it: 16 rows of 128."""
    corpus = np.fromfile(path.replace(".safetensors", ".corpus"), np.uint8)
    held = corpus[int(len(corpus) * 0.9):]
    return held[: (len(held) // seq) * seq].reshape(-1, seq)[:rows].astype(np.int64)


def evaluate(model, cfg, tokens, device="cuda", rows_per_call=None):
    """Logits [B*T, V] (f32) and the mean NLL of next-token prediction over
    the forwards of tokens[:, :-1], ``rows_per_call`` rows each (all rows in
    one by default)."""
    tokens = torch.from_numpy(tokens).to(device)
    t = tokens.shape[1] - 1
    step = rows_per_call or tokens.shape[0]
    parts = []
    with torch.no_grad():
        for r0 in range(0, tokens.shape[0], step):
            rows = tokens[r0:r0 + step]
            out, _ = model(rows[:, :-1], model.init_cache(cfg, rows.shape[0], t + 1),
                           torch.arange(t, device=device))
            parts.append(out.float())
    logits = torch.cat(parts)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, tokens[:, 1:, None])[..., 0].mean()
    return logits.reshape(-1, logits.shape[-1]), nll.item()


def policy_metrics(got, nll, ref, nll_ref) -> dict:
    """The JAX package's quality numbers of one policy's logits and NLL
    against the bf16 twin's (``benchmark/run_quality_eval.py``)."""
    return dict(heldout_nll=nll, nll_delta=nll - nll_ref,
                top1_agreement=(got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                logit_cosine_sim=F.cosine_similarity(got, ref, dim=-1, eps=1e-9).mean().item())


def policy_gates(q) -> dict:
    """tests/test_convert.py's gates of the router-dense policy, on one
    policy's numbers: name -> whether it holds."""
    return {"cosine > 0.97": q["logit_cosine_sim"] > 0.97,
            "top-1 > 0.82": q["top1_agreement"] > 0.82,
            "nll_delta < 0.1": q["nll_delta"] < 0.1}


def quality_gates(res, nll_ref, vocab_size) -> dict:
    """tests/test_convert.py's gates on the trained h256 fixture: name ->
    whether it holds."""
    q, pg = res["int4_router_dense"], res["int4_per_group64"]
    return {"NLL bf16 < 0.5 uniform": nll_ref < 0.5 * float(np.log(vocab_size)),
            **{f"router-dense {name}": ok for name, ok in policy_gates(q).items()},
            "per-group64 cosine >= router-dense - 1e-3":
                pg["logit_cosine_sim"] >= q["logit_cosine_sim"] - 1e-3,
            # tests/test_equalize.py's property of an AWQ conversion
            **{f"{awq} cosine >= {base} - 1e-3":
               res[awq]["logit_cosine_sim"] >= res[base]["logit_cosine_sim"] - 1e-3
               for awq, base in AWQ_BASELINES.items()}}


# The execution modes on the trained fixture (the router-dense conversion,
# then the mode's converter), the kernels each must launch and those it must
# not, and the rows per forward: u4_turbo evaluates 2 rows (254 positions) a
# forward, below the linears' 256-row transient gate and the MoE's 512-row
# threshold, so that its linears run K5 and its experts K10, as at decode;
# turbo evaluates all 16 rows (2032 positions) in one forward, its linears on
# K5 at that row count and its experts on K10 at the prefill's tile_m.
TRAINED_MODES = (
    ("as_per_group", as_per_group,
     ("int4_matmul_per_group", "grouped_int4_matmul_per_group", "int4_attention"),
     ("int4_matmul", "grouped_int4_matmul", "int4_matmul_per_group_a8",
      "grouped_int4_matmul_per_group_a8"), None),
    ("pg_turbo", as_pg_turbo,
     ("int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8", "int4_attention"),
     ("int4_matmul", "grouped_int4_matmul", "int4_matmul_per_group",
      "grouped_int4_matmul_per_group"), None),
    ("u4_turbo", as_u4_turbo,
     ("int4_matmul_a8_fused", "grouped_int4_matmul_a8", "int4_attention"),
     ("int4_matmul", "grouped_int4_matmul", "int4_matmul_a8", "grouped_int4_matmul_a8_fused",
      "int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8"), 2),
    ("turbo", as_turbo,
     ("int4_matmul_a8_fused", "grouped_int4_matmul_a8", "int4_attention"),
     ("int4_matmul", "grouped_int4_matmul", "int4_matmul_a8", "grouped_int4_matmul_a8_fused",
      "int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8"), None),
)


def same_weights(a, b) -> bool:
    """Whether two models hold the same tensors: packed bytes, scales, zero
    points, norms and dense weights."""
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def trained_checkpoint(card_line, device="cuda"):
    """Phase 8: the trained h256 fixture converted on the card in the seven
    policies of the JAX quality record, each evaluated on the held-out tail
    of its corpus against the bf16 twin built from the same checkpoint,
    beside the JAX package's committed record (a CPU run of the JAX
    package); held to the gates of tests/test_convert.py and, for the two
    AWQ policies, to tests/test_equalize.py's cosine property. AWQ prints
    the alpha of every site; where every site keeps the identity its model
    must hold the bytes of the same granularity's conversion without AWQ.
    Then the router-dense model under as_per_group (K7, K13, K3; held to the
    router-dense policy's gates), pg_turbo (K8, K14), u4_turbo (K5, K10, K3)
    and turbo (K5, K10, K3; held to the router-dense policy's gates), and the
    per-group-128 model on the card against the CPU."""
    cfg = fixture_config(H256)
    raw = load_safetensors(H256)
    tokens = heldout_tokens(H256)
    with open(JAX_QUALITY_RECORD) as f:
        record = json.load(f)
    ref, nll_ref = evaluate(dense_from_params(raw, cfg, device=device), cfg, tokens, device)
    print(f"trained h256: held-out NLL bf16 twin {nll_ref:.4f} (JAX record "
          f"{record['heldout_nll_bf16']}), {tokens[:, 1:].size} tokens, on {card_line}")
    res, models = {}, {}
    for label in QUALITY_POLICIES:
        model = models[label] = convert_safetensors(H256, cfg, device=device,
                                                    **policy_kwargs(label, H256))
        _reset_counts()
        got, nll = evaluate(model, cfg, tokens, device)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _launch_counts().items() if v}
        res[label] = q = policy_metrics(got, nll, ref, nll_ref)
        rec = record[label]
        print(f"trained h256 [{label}]: held-out NLL {q['heldout_nll']:.4f}, nll_delta "
              f"{q['nll_delta']:.4f}, top-1 {q['top1_agreement']:.4f}, cosine "
              f"{q['logit_cosine_sim']:.4f}; JAX record (CPU run of the JAX package) "
              f"{rec['nll_delta']} / {rec['top1_agreement']} / {rec['logit_cosine_sim']}; "
              f"launches {launches}, plain-version calls {_plain_calls()}")
        if label == "int4_per_group128":
            _expect_launches("trained h256 [int4_per_group128]", _launch_counts(),
                             ("int4_matmul_per_group_planar",
                              "grouped_int4_matmul_per_group_planar", "int4_attention"),
                             ("int4_matmul", "grouped_int4_matmul"))
        if label == "int4_awq":   # 2032 rows a forward: the linears are past K1's threshold
            _expect_launches("trained h256 [int4_awq]", _launch_counts(),
                             ("grouped_int4_matmul", "int4_attention"),
                             ("int4_matmul_per_group_planar",
                              "grouped_int4_matmul_per_group_planar"))
        if model.awq_alphas is not None:
            identity = set(model.awq_alphas.values()) == {None}
            print(f"trained h256 [{label}]: alpha chosen at each AWQ site {model.awq_alphas} "
                  "(None: the identity)")
            if identity and not same_weights(model, models[AWQ_BASELINES[label]]):
                raise AssertionError(f"trained h256 [{label}]: every site kept the identity, "
                                     f"but the weights differ from {AWQ_BASELINES[label]}'s")
            if identity:
                print(f"trained h256 [{label}]: every site kept the identity; packed bytes, "
                      f"scales and norms equal {AWQ_BASELINES[label]}'s")
    del models
    gates = quality_gates(res, nll_ref, cfg.vocab_size)
    if not all(gates.values()):
        raise AssertionError(f"trained h256 quality gates: {gates}")
    print(f"trained h256: every gate of tests/test_convert.py met {sorted(gates)}")
    base = convert_safetensors(H256, cfg, device=device, **QUALITY_POLICIES["int4_router_dense"])
    for label, convert, launched, idle, rows_per_call in TRAINED_MODES:
        model = convert(base)
        _reset_counts()
        got, nll = evaluate(model, cfg, tokens, device, rows_per_call)
        torch.cuda.synchronize()
        launches = _launch_counts()
        paths = {fn.__name__: fn.calls for fn in _PATH_CALLS if fn.calls}
        if paths:
            raise AssertionError(f"trained h256 [{label}]: integer-GEMM paths called {paths}")
        res[label] = q = policy_metrics(got, nll, ref, nll_ref)
        print(f"trained h256 [router dense, {label}]: held-out NLL {q['heldout_nll']:.4f} (bf16 "
              f"twin {nll_ref:.4f}), nll_delta {q['nll_delta']:.4f}, top-1 "
              f"{q['top1_agreement']:.4f}, cosine {q['logit_cosine_sim']:.4f}; launches "
              f"{ {k: v for k, v in launches.items() if v} }, plain-version calls {_plain_calls()}")
        _expect_launches(f"trained h256 [{label}]", launches, launched, idle)
    for label in ("as_per_group", "turbo"):
        mode_gates = policy_gates(res[label])
        if not all(mode_gates.values()):
            raise AssertionError(f"trained h256 [{label}]: router-dense gates {mode_gates}")
        print(f"trained h256 [{label}]: the router-dense policy's gates met {sorted(mode_gates)}")
    kw = QUALITY_POLICIES["int4_per_group128"]
    card_vs_cpu(convert_checkpoint(raw, cfg, device="cpu", **kw),
                convert_checkpoint(raw, cfg, device=device, **kw), cfg,
                "trained h256 [int4_per_group128]", device=device)
    return res


# --- phase 10: persistence and utilities ---------------------------------------

# Phase 7's seeded checkpoint's full-width weights for the native packer: a
# linear, expert 0's gate/up and down projections, and the lm_head.
PACKED_WEIGHTS = ("layers.0.attn.q_proj.weight", "layers.0.moe.experts.0.w1.weight",
                  "layers.0.moe.experts.0.w2.weight", "lm_head.weight")
# FP4's product against the f32 product of its dequantized weight: the same
# f32 matmul on the same operands, so the same bits up to cuBLAS's choice of
# algorithm: max|d| <= 1e-6 * max|y|.
FP4_REL_TOL = 1e-6


def native_packer(params, card_line):
    """The native host packer (csrc/quantpack.cpp, built with g++) on four
    full-width layer2 weights: bytes, scales and zero points equal the port's
    quantize on the card, bit for bit, and come from the C++ library."""
    if not native.native_available():
        raise AssertionError("native packer: the C++ library did not build or load")
    for key in PACKED_WEIGHTS:
        w = params[key]
        host = w.cpu().numpy()
        calls = native.quantize_pack_planar.native_calls
        t0 = time.perf_counter()
        got = native.quantize_pack_planar(host)
        secs = time.perf_counter() - t0
        if native.quantize_pack_planar.native_calls != calls + 1:
            raise AssertionError(f"native packer {key}: the bytes did not come from the library")
        qt = quantize(w)
        for name, a in zip(("packed", "scales", "zero_points"), got):
            want = getattr(qt, name).cpu().numpy()
            if not np.array_equal(a, want):
                raise AssertionError(f"native packer {key} {tuple(w.shape)}: "
                                     f"{int((a != want).sum())} {name} differ from quantize's")
        print(f"native packer {key} {tuple(w.shape)}: packed bytes, scales and zero points == "
              f"quantize on the card, bit for bit; {secs:.3f} s on the host's "
              f"{os.cpu_count()} cores (card: {card_line})")


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*") if f.is_file())


def checkpoint_models(card_line, ref, device="cuda"):
    """Save the default layer2 model (seed 0, phase 4's) and phase 7's
    per-group-128 conversion, load each into a template built on the card
    from another seed, and serve phase 4's 12 requests on each before the
    save and after the load: the same weights and tokens, on K1/K2/K3 (per
    group: K6/K12/K3) with no plain version. Returns the reloaded default
    model."""
    cfg = flagship_model_config("layer2")
    pg = dict(granularity="per_group", group_size=128)
    models = (
        ("default", lambda seed: QuantizedTransformer.init(
            cfg, generator=torch.Generator(device=device).manual_seed(seed), device=device),
         _DEFAULT_KERNELS + ("int4_attention",),
         ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar")),
        ("converted per_group128", lambda seed: convert_checkpoint(
            SeededCheckpoint(cfg, device, seed=11 + seed), cfg, device=device, **pg),
         ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar",
          "int4_attention"), _DEFAULT_KERNELS),
    )
    tmp = tempfile.mkdtemp(prefix="f4b_ckpt_")
    try:
        for name, make, launched, idle in models:
            model = make(0)
            _, eng, _ = serve(model, cfg, f"{name}, before the save", card_line)
            before = dict(eng.finished)
            if name == "default" and before != ref:
                raise AssertionError("checkpoint [default]: the rebuilt model's tokens differ "
                                     "from phase 4's")
            path = os.path.join(tmp, name.replace(" ", "_"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(path, model)
            save_s = time.perf_counter() - t0
            template = make(1)
            if same_weights(model, template):
                raise AssertionError(f"checkpoint [{name}]: the template holds the same weights")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = checkpoint.load(path, template)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if loaded is not template or not same_weights(model, loaded):
                raise AssertionError(f"checkpoint [{name}]: the loaded weights differ")
            del model
            launches, eng, _ = serve(loaded, cfg, f"{name}, reloaded", card_line)
            _expect_launches(f"checkpoint [{name}] reloaded serve", launches, launched, idle)
            differ = [uid for uid in before if eng.finished[uid] != before[uid]]
            if differ:
                raise AssertionError(f"checkpoint [{name}]: tokens differ after the reload for "
                                     f"uids {differ}")
            print(f"checkpoint [{name}] layer2: {_dir_bytes(path)} bytes on disk for nbytes "
                  f"{loaded.nbytes}; save {save_s:.2f} s, load {load_s:.2f} s (host and card, "
                  f"{card_line}); the reloaded model serves the 12 requests' tokens exactly")
            shutil.rmtree(path)
            if name == "default":
                default = loaded
            else:
                del loaded
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return default, cfg


def elastic_decode(model, cfg, card_line, device="cuda", b=8, prompt=8, steps=24):
    """24 greedy decode steps of layer2 at batch 8 through elastic_loop: the
    state is the KV caches (updated in place by each step), the last tokens
    and the positions, saved every 8 steps, 2 kept. A step that raises once
    at step 13, then a crash at step 17 with max_retries=0 and a relaunch
    that must resume at 16: each run's tokens and final caches equal an
    uninterrupted loop's bit for bit, on K1, K2 and K3."""
    prompts = torch.from_numpy(np.random.default_rng(9).integers(1, cfg.vocab_size, (b, prompt)))
    prompts = prompts.to(device)

    def init_state():
        caches = model.init_cache(cfg, b, 64)
        logits, caches = model(prompts, caches, torch.arange(prompt, device=device))
        return {"caches": caches, "tokens": logits[:, -1].argmax(-1, keepdim=True),
                "positions": torch.full((b, 1), prompt, dtype=torch.int32, device=device)}

    def step(state, i):
        logits, caches = model(state["tokens"], state["caches"], state["positions"])
        return {"caches": caches, "tokens": logits[:, -1].argmax(-1, keepdim=True),
                "positions": state["positions"] + 1}

    def faulty(at):
        def f(state, i):
            if i == at and at not in raised:
                raised.add(at)
                raise RuntimeError(f"injected fault at step {at}")
            return step(state, i)
        return f

    raised = set()
    with torch.no_grad():
        want = init_state()
        ref = {}
        for i in range(steps):
            want = step(want, i)
            ref[i + 1] = want["tokens"][:, 0].cpu()
        tmp = tempfile.mkdtemp(prefix="f4b_elastic_")
        try:
            runs = {}
            for name in ("transient fault at step 13", "crash at step 17, relaunched"):
                got, ckdir = {}, os.path.join(tmp, str(len(runs)))
                kw = dict(ckpt_dir=ckdir, num_steps=steps, save_every=8, keep=2,
                          on_step=lambda i, s: got.__setitem__(i, s["tokens"][:, 0].cpu()))
                _reset_counts()
                t0 = time.perf_counter()
                if name.startswith("transient"):
                    state, resumed = elastic_loop(faulty(13), init_state(), **kw)
                else:
                    try:
                        elastic_loop(faulty(17), init_state(), max_retries=0, **kw)
                        raise AssertionError("elastic: the crash at step 17 did not raise")
                    except RuntimeError as exc:
                        if "injected fault" not in str(exc):
                            raise
                    if latest_step(ckdir) != 16:
                        raise AssertionError(f"elastic: newest checkpoint {latest_step(ckdir)} "
                                             "after the crash, want 16")
                    state, resumed = elastic_loop(step, init_state(), **kw)
                    if resumed != 16:
                        raise AssertionError(f"elastic: the relaunch resumed at {resumed}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                _expect_launches(f"elastic [{name}]", _launch_counts(),
                                 _DEFAULT_KERNELS + ("int4_attention",), ("paged_int4_attention",))
                differ = [i for i in ref if not torch.equal(got.get(i, torch.empty(0)), ref[i])]
                caches_equal = all(torch.equal(getattr(c, f), getattr(w, f))
                                   for c, w in zip(state["caches"], want["caches"])
                                   for f in QuantizedKVCache._FIELDS)
                if differ or not caches_equal:
                    raise AssertionError(f"elastic [{name}]: tokens differ at steps {differ}, "
                                         f"caches equal {caches_equal}")
                listing = sorted(os.listdir(ckdir))
                runs[name] = resumed
                print(f"elastic [{name}]: 24 decode steps of layer2 at batch 8, resumed from "
                      f"{resumed}, checkpoints {listing}; every step's tokens and the final KV "
                      f"caches equal the uninterrupted loop's bit for bit; {wall:.2f} s wall, "
                      f"faults and relaunch included, on {card_line}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return runs


def fp4_phase(params, card_line, device="cuda", e=8):
    """FP4 on the card: expert 0's w1 gives the CPU's codes and scales bit for
    bit; the whole gate stack's peak memory; fp4_matmul at M=8 against the
    f32 product of the dequantized weight; FP4's and INT4-per-row's relative
    error against the dense product."""
    w1 = params["layers.0.moe.experts.0.w1.weight"]
    on_card, on_cpu = quantize_fp4(w1), quantize_fp4(w1.cpu())
    if not (torch.equal(on_card.codes.cpu(), on_cpu.codes)
            and torch.equal(on_card.scale.cpu(), on_cpu.scale)):
        raise AssertionError(f"fp4 {tuple(w1.shape)}: codes or scale on the card differ from "
                             "the CPU's")
    stack = torch.stack([params[f"layers.0.moe.experts.{i}.w1.weight"] for i in range(e)])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gate = quantize_fp4(stack)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.equal(gate.codes[0], on_card.codes) or not torch.equal(gate.scale[0],
                                                                          on_card.scale):
        raise AssertionError("fp4: expert 0 of the stack differs from expert 0 alone")
    print(f"fp4 gate stack {tuple(stack.shape)} f32 ({stack.numel() * 4 / 2**30:.2f} GiB): "
          f"quantized in {secs:.3f} s, peak {peak / 2**30:.2f} GiB above the stack, codes "
          f"{gate.codes.numel() / 2**30:.2f} GiB (ideal packed {gate.nbytes_ideal / 2**30:.2f} "
          f"GiB), on {card_line}")
    del stack, gate
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((8, w1.shape[1]), generator=gen, device=device)
    y = fp4_matmul(x, on_card)
    ref = x @ dequantize_fp4(on_card).t()
    err = (y - ref).abs().max().item()
    if not (torch.isfinite(y).all() and err <= FP4_REL_TOL * ref.abs().max().item()):
        raise AssertionError(f"fp4_matmul M=8: max|d| {err} against the dequantized product")
    dense = x @ w1.t()
    int4 = x @ dequantize(quantize(w1)).t()
    rel = {name: ((a - dense).norm() / dense.norm()).item() for name, a in (("fp4", y),
                                                                         ("int4", int4))}
    print(f"fp4_matmul M=8 {tuple(w1.shape)}: max|d| {err:.3e} against the f32 product of the "
          f"dequantized weight (tol {FP4_REL_TOL:g} * max|y|); relative error against the dense "
          f"f32 product: FP4 per tensor {rel['fp4']:.4f}, INT4 per row {rel['int4']:.4f}")
    return rel


def quantized_dense(device="cuda"):
    """QuantizedDense 4096 -> 14336 at M=8 (bf16): one K1 launch, no plain
    version, and the output of QuantizedLinear on the same bytes, bit for bit."""
    gen = torch.Generator(device=device).manual_seed(3)
    layer = QuantizedDense(4096, 14336, use_bias=True, generator=gen, device=device)
    x = torch.randn((8, 4096), generator=gen, device=device).bfloat16()
    _reset_counts()
    y = layer(x)
    torch.cuda.synchronize()
    launches = _launch_counts()
    _expect_launches("QuantizedDense", launches, ("int4_matmul",), ())
    if launches["int4_matmul"] != 1:
        raise AssertionError(f"QuantizedDense: {launches['int4_matmul']} K1 launches, want 1")
    if not torch.equal(y, QuantizedLinear(layer.weight, layer.bias)(x)):
        raise AssertionError("QuantizedDense: output differs from QuantizedLinear's")
    print(f"QuantizedDense 4096->14336 M=8 bf16: one K1 launch, equal to QuantizedLinear on the "
          f"same bytes bit for bit, max|y| {y.abs().max().item():.3f}")


def _kernel_counts(prof) -> dict:
    """Launches per kernel counter of one traced run, from the kernel names
    on the card's timeline (the profiler leaves names in anonymous
    namespaces mangled): K1 and K2 are the linear body's RowScale
    instantiations without and with grouped addressing (template flag
    false / true, mangled Lb0E / Lb1E), K3 the attention body."""
    def count(pred):
        return sum(t.count for name, t in prof.by_op.items() if pred(name))

    def row_scale(grouped):
        flag = ("true", "Lb1E") if grouped else ("false", "Lb0E")
        return lambda n: ("int4_mma_kernel" in n and "RowScale" in n
                          and any(f in n for f in flag))

    return {"int4_matmul": count(row_scale(False)),
            "grouped_int4_matmul": count(row_scale(True)),
            "int4_attention": count(lambda n: "int4_attention_mma_kernel" in n)}


def utilities(model, cfg, results, card_line, device="cuda", b=8):
    """device_op_times over one layer2 decode step (kernel counts equal the
    launch counters), time_fn_scan on K1 at M=8 (its graph-replayed output
    equals the eager call's), linear_roofline at phase 3's K1 shape (equals
    its bound), and a 1 GiB device-to-device copy probe."""
    gen = torch.Generator(device=device).manual_seed(6)
    tokens = torch.randint(1, cfg.vocab_size, (b, 8), generator=gen, device=device)
    with torch.no_grad():
        caches = model.init_cache(cfg, b, 64)
        logits, caches = model(tokens, caches, torch.arange(8, device=device))
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        pos = torch.full((b, 1), 8, dtype=torch.int32, device=device)

        def decode_step():
            with annotate("decode_step"):
                model(nxt, caches, pos)

        decode_step()
        _reset_counts()
        with tempfile.TemporaryDirectory(prefix="f4b_trace_") as trace_dir:
            prof = device_op_times(decode_step, trace_dir=trace_dir)
        launches = {k: v for k, v in _launch_counts().items() if v}
        counted = _kernel_counts(prof)
        if counted != launches or _plain_calls():
            names = {n: t.count for n, t in prof.by_op.items()}
            raise AssertionError(f"device_op_times: kernel counts {counted} against launch "
                                 f"counters {launches}; kernels on the card {names}")
        # The step's own range holds no kernel directly under the layer spans'
        # f4b.* ranges, so the profiler gives it no device time: the kernels'
        # sum stands for the step.
        print(f"device_op_times, one layer2 decode step at batch {b}: kernels {counted} == the "
              f"launch counters; device {prof.total_ms:.4f} ms in kernels and copies, "
              f"ranges {sorted(prof.by_module)}, on {card_line}")

        qt = model.blocks[0].attn.wq.weight
        x = torch.randn((8, qt.in_dim), generator=gen, device=device).bfloat16()
        seen_x, seen_y = torch.empty_like(x), torch.empty((8, qt.out_dim), dtype=x.dtype,
                                                          device=device)

        def recorded(xi, w):
            seen_x.copy_(xi)
            y = ops.int4_matmul(xi, w)
            seen_y.copy_(y)
            return y

        time_fn_scan(recorded, x, consts=(qt,), iters=4, warmup=1, repeats=1)
        eager = ops.int4_matmul(seen_x, qt)
        if not (torch.equal(eager, seen_y) and seen_y.abs().sum().item() > 0):
            raise AssertionError("time_fn_scan: K1's graph-replayed output differs from the "
                                 "eager call's on the same input")
        scan_ms = time_fn_scan(ops.int4_matmul, x, consts=(qt,), iters=50) * 1e3
        event_ms = Timer(device)(lambda: ops.int4_matmul(x, qt))
        print(f"time_fn_scan K1 M=8 N=K=4096 bf16: {scan_ms:.4f} ms per call (50 dependent "
              f"calls in one CUDA graph, the carry's small kernels and a warm L2 included; "
              f"the graph's output equals the eager call's bit for bit) against {event_ms:.4f} "
              f"ms by CUDA events (L2 flushed), on {card_line}")

        main_row = next(r for r in results if r["name"] == "int4_matmul"
                        and r["shape"] == MAIN_SHAPE["int4_matmul"])
        rep = linear_roofline(8, 4096, 4096, chip=H100_SXM)
        if not np.isclose(rep.sol_latency_us / 1e3, main_row["bound_ms"], rtol=1e-9, atol=0):
            raise AssertionError(f"linear_roofline: {rep.sol_latency_us / 1e3} ms against phase "
                                 f"3's K1 bound {main_row['bound_ms']}")
        print(f"linear_roofline(8, 4096, 4096, H100_SXM): {rep.sol_latency_us:.4f} us "
              f"({rep.bound}-bound), phase 3's K1 bound {main_row['bound_ms'] * 1e3:.4f} us")

        src = torch.empty(1 << 30, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        times = []
        for i in range(12):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        gbps = 2 * (1 << 30) / (ms / 1e3) / 1e9
        print(f"copy probe: 1 GiB device to device in {ms:.4f} ms, {gbps:.1f} GB/s read + write "
              f"({100 * gbps / H100_SXM.hbm_gbps:.1f} % of the data sheet's "
              f"{H100_SXM.hbm_gbps:.0f} GB/s), on {card_line}")
        del src, dst


def persistence_and_utilities(card_line, ref, results, device="cuda"):
    """Phase 10."""
    t0 = time.perf_counter()
    cfg = flagship_model_config("layer2")
    params = SeededCheckpoint(cfg, device)
    native_packer(params, card_line)
    model, cfg = checkpoint_models(card_line, ref, device)
    elastic_decode(model, cfg, card_line, device)
    utilities(model, cfg, results, card_line, device)
    del model
    torch.cuda.empty_cache()
    fp4_phase(params, card_line, device)
    quantized_dense(device)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")


# --- phase 11: the parallel layer ------------------------------------------------
#
# One card: the world-size-1 NCCL group runs the sharded path end to end (every
# sum and gather over one rank: the same bits as the model's own forward), and
# the per-rank bodies of a D-way split run one after another and meet in the
# module's own summation code. Their bar against the single-card product is the
# kernels' bf16 bar (BF16_REL_TOL of the largest output): EP sums the D partials
# in bf16 in rank order where one combine sums a token's pairs, and TP's shards
# launch K1 at another N.


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _counted(fn, counts):
    """``fn()`` with the launch counters reset before and added to ``counts``
    after; raises if a plain version ran."""
    _reset_counts()
    out = fn()
    if _plain_calls():
        raise AssertionError(f"phase 11: a plain version ran {_plain_calls()} times")
    for k, v in _launch_counts().items():
        counts[k] = counts.get(k, 0) + v
    return out


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def sharded_step_vs_forward(model, cfg, mesh, name, counts, card_line, device="cuda", b=8,
                            prompt=8):
    """sharded_decode_step on the placed model against the model's own
    forward: an 8-token prefill and one decode step at batch 8, logits and
    caches bit for bit; on the card, wall and device ms per decode step of
    both."""
    placed = par.place_model(model, mesh)
    gen = torch.Generator(device=device).manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (b, prompt), generator=gen, device=device)
    positions = torch.arange(prompt, dtype=torch.int32, device=device)[None].expand(b, prompt)
    caches_m, caches_s = model.init_cache(cfg, b, 64), placed.init_cache(cfg, b, 64)
    with torch.no_grad():
        want, caches_m = model(tokens, caches_m, positions)
        got, caches_s = _counted(lambda: par.sharded_decode_step(placed, mesh, tokens, caches_s,
                                                                 positions), counts)
        nxt = want[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        pos = torch.full((b, 1), prompt, dtype=torch.int32, device=device)
        want1, caches_m = model(nxt, caches_m, pos)
        got1, caches_s = _counted(lambda: par.sharded_decode_step(placed, mesh, nxt, caches_s,
                                                                  pos), counts)
        _sync(device)
        same_caches = all(torch.equal(getattr(cm, f), getattr(cs, f))
                          for cm, cs in zip(caches_m, caches_s) for f in cm._FIELDS)
        if not (torch.equal(got, want) and torch.equal(got1, want1) and same_caches):
            raise AssertionError(f"sharded step [{name}]: differs from the model's forward "
                                 f"(prefill max|d| {(got.float() - want.float()).abs().max()}, "
                                 f"decode {(got1.float() - want1.float()).abs().max()}, caches "
                                 f"{'equal' if same_caches else 'differ'})")
        msg = (f"sharded step [{name}], mesh (data, expert) = (1, 1) on "
               f"{torch.distributed.get_backend()}: prefill {b} x {prompt} and one decode step "
               f"equal to the model's forward bit for bit (logits, caches)")
        if device != "cuda":
            print(msg)
            return
        steps = {"forward": lambda: model(nxt, caches_m, pos),
                 "sharded": lambda: par.sharded_decode_step(placed, mesh, nxt, caches_s, pos)}
        wall = {k: [] for k in steps}
        for _ in range(20):   # alternating, each step ended by a synchronize
            for k, fn in steps.items():
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall[k].append((time.perf_counter() - t0) * 1e3)
        dev = {}
        for k, fn in steps.items():
            with tempfile.TemporaryDirectory(prefix="f4b_trace_") as trace_dir:
                prof = device_op_times(lambda: [fn() for _ in range(10)], trace_dir=trace_dir)
            dev[k] = prof.total_ms / 10
    print(f"{msg}; decode step wall ms (median of 20) forward {statistics.median(wall['forward']):.3f}, "
          f"sharded {statistics.median(wall['sharded']):.3f}; device ms in kernels and copies "
          f"(10 steps traced) forward {dev['forward']:.4f}, sharded {dev['sharded']:.4f}, "
          f"on {card_line}")


def _expert_slice(qt, r, d):
    """Rank r's experts of a D-way split of a stacked QuantizedTensor."""
    e = qt.shape[0] // d
    return dataclasses.replace(qt, packed=qt.packed[r * e:(r + 1) * e],
                               scales=qt.scales[r * e:(r + 1) * e],
                               zero_points=qt.zero_points[r * e:(r + 1) * e],
                               shape=(e,) + tuple(qt.shape[1:]))


def _row_slice(qt, r, d):
    """Rank r's output rows of a D-way column-parallel split of [N, K]."""
    n = qt.out_dim // d
    return dataclasses.replace(qt, packed=qt.packed[r * n:(r + 1) * n],
                               scales=qt.scales[r * n:(r + 1) * n],
                               zero_points=qt.zero_points[r * n:(r + 1) * n],
                               shape=(n, qt.in_dim))


def _within_bar(what, got, want):
    err = (got.float() - want.float()).abs().max().item()
    tol = BF16_REL_TOL * want.float().abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{what}: max|d| {err} above {tol}")
    return err, tol


def split_bodies(model, pg, mesh, counts, device="cuda", t=8):
    """The per-rank bodies of a D-way split, D = 2 and 4, one after another:
    EP-replicated on the first block's gate stack (K2; K13 per group of 128)
    summed in rank order by the module's own summation code, and TP on expert
    0's 4096 -> 14336 gate weight (K1) concatenated in rank order, each
    against the single-card product; and the collective versions at world
    size 1, equal to it bit for bit."""
    gen = torch.Generator(device=device).manual_seed(12)
    qt = model.blocks[0].moe.w_gate.weight
    e, hidden = qt.shape[0], qt.in_dim
    x = torch.randn((t, hidden), generator=gen, device=device).bfloat16()
    logits = torch.randn((t, e), generator=gen, device=device)
    kw = dict(top_k=2, tile_m=16)
    with torch.no_grad():
        for label, stack in (("EP K2", qt), ("EP K13", pg.blocks[0].moe.w_gate.weight)):
            whole = _counted(lambda: par.moe_ep_replicated_body(0, 1, x, logits, stack, **kw),
                             counts)
            world1 = _counted(lambda: par.moe_ep_replicated(x, logits, stack, mesh,
                                                            axis="expert", **kw), counts)
            if not torch.equal(world1, whole):
                raise AssertionError(f"{label}: moe_ep_replicated at world size 1 differs")
            for d in (2, 4):
                parts = [_counted(lambda: par.moe_ep_replicated_body(
                    r, d, x, logits, _expert_slice(stack, r, d), **kw), counts) for r in range(d)]
                err, tol = _within_bar(f"{label} D={d}", par.sum_in_rank_order(parts), whole)
                print(f"{label} D={d}: {d} bodies (E_local {e // d}) summed in rank order vs "
                      f"the single-card product: max|d| {err:.5f} <= {tol:.5f}")
        w2d = dataclasses.replace(qt, packed=qt.packed[0], scales=qt.scales[0],
                                  zero_points=qt.zero_points[0], shape=tuple(qt.shape[1:]))
        whole = _counted(lambda: par.tp_int4_matmul_body(x, w2d), counts)
        world1 = _counted(lambda: par.tp_int4_matmul(x, w2d, mesh, axis="expert"), counts)
        if not torch.equal(world1, whole):
            raise AssertionError("TP K1: tp_int4_matmul at world size 1 differs")
        for d in (2, 4):
            parts = [_counted(lambda: par.tp_int4_matmul_body(x, _row_slice(w2d, r, d)),
                              counts) for r in range(d)]
            err, tol = _within_bar(f"TP K1 D={d}", torch.cat(parts, dim=-1), whole)
            print(f"TP K1 D={d}: {d} shards of N={w2d.out_dim // d} concatenated in rank order "
                  f"vs the single-card product: max|d| {err:.5f} <= {tol:.5f}")


def _prefill_last_logits(forward, caches, prompt, row, b, device, bucket=32, max_seq=256):
    """The last prompt position's logits of a chunked prefill of ``prompt`` in
    row ``row`` of a batch of ``b``, the other rows parked in the last bucket,
    as the engines run it (b = 1: the single-card engine's batch-1 forward)."""
    n = len(prompt)
    for c in range(-(-n // bucket)):
        chunk = prompt[c * bucket:(c + 1) * bucket]
        tokens = torch.zeros((b, bucket), dtype=torch.int32, device=device)
        tokens[row, :len(chunk)] = torch.tensor(chunk, dtype=torch.int32, device=device)
        starts = torch.full((b,), max_seq - bucket, dtype=torch.int32, device=device)
        starts[row] = c * bucket
        positions = starts[:, None] + torch.arange(bucket, dtype=torch.int32, device=device)
        logits = forward(tokens, caches, positions)
    return logits[row, len(chunk) - 1].float()


def mesh_step_host_costs(mesh, cfg, card_line, b=8, n=200):
    """Wall us per call, at world size 1, of what the mesh decode step adds
    to the model's forward: the fixed-order sum over `expert` of a [B, 1, H]
    bf16 partial and the local filter of a [B, 2] routing (once per MoE
    block each), and the logits gather over `data` (once a step); each over
    ``n`` calls ended by one synchronize."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    part = torch.randn((b, 1, cfg.num_heads * cfg.head_dim), generator=gen,
                       device="cuda").bfloat16()
    logits = torch.randn((b, 1, cfg.vocab_size), generator=gen, device="cuda").bfloat16()
    e = cfg.moe.num_experts
    idx = torch.randint(0, e, (b, 2), generator=gen, device="cuda", dtype=torch.int32)
    w = torch.rand((b, 2), generator=gen, device="cuda")
    calls = {"psum over expert": lambda: par.psum(part, mesh, "expert"),
             "local_routing": lambda: par.expert_parallel.local_routing(idx, w, 0, e),
             "logits gather over data": lambda: par.mesh.all_gather_dim(logits, mesh, "data", 0)}
    us = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) * 1e6 / n
    layers = cfg.num_layers
    per_step = (layers * (us["psum over expert"] + us["local_routing"])
                + us["logits gather over data"])
    print("mesh step host costs at world size 1, us per call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in us.items()) + f"; {layers} MoE blocks a step: "
        f"{per_step / 1e3:.3f} ms a decode step, on {card_line}")


def decode_ms_alternating(model, placed, cfg, mesh, card_line, rounds=3):
    """The single-card and the mesh engine on phase 4's 12 requests, serves
    alternating, ``rounds`` each: each serve's median decode ms/step, and
    the spread over the serves."""
    runs = {"single-card": [], "mesh": []}
    for _ in range(rounds):
        for name, m, kw in (("single-card", model, {}), ("mesh", placed, {"mesh": mesh})):
            eng = ServingEngine(m, cfg, num_slots=8, max_seq=256, prefill_bucket=32, **kw)
            for r in phase4_requests(cfg):
                eng.submit(r)
            runs[name].append(statistics.median(_serve_loop(eng)[0]))
    print("serve [mesh (1, 1)] vs single-card, " + "; ".join(
        f"{name}: decode ms/step (median of each serve) "
        f"{', '.join(f'{v:.3f}' for v in vals)}, spread {max(vals) - min(vals):.3f}"
        for name, vals in runs.items()) + f"; {rounds} serves each, alternating, on {card_line}")


def serve_mesh(model, cfg, mesh, ref, counts, card_line, device="cuda"):
    """ServingEngine(mesh=...) on phase 4's 12 requests against the
    single-card engine's tokens. Where they differ, the mesh engine's
    full-batch prefill (8 x 32 rows) went through K1's tall calls (above
    ops._mma._MMA_TALL_M rows: the warpgroup body where it takes the shape,
    else the tall tile) where the single-card prefill (32 rows) took the
    decode launch: the differing requests' prefill logits are then
    held to the model bar (MODEL_REL_TOL of their max, the first token in the
    single-card top-2)."""
    placed = par.place_model(model, mesh)
    launches, eng, _ = serve(placed, cfg, "mesh (1, 1)", card_line, mesh=mesh)
    _expect_launches("serve [mesh]", launches,
                     ("int4_matmul", "grouped_int4_matmul", "int4_attention"),
                     ("grouped_int4_matmul_ksplit", "paged_int4_attention"))
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v
    if device == "cuda":
        decode_ms_alternating(model, placed, cfg, mesh, card_line)
    got = eng.finished
    differ = [uid for uid in ref if got[uid] != ref[uid]]
    if not differ:
        print(f"serve [mesh (1, 1)]: all {len(ref)} requests' tokens equal the single-card "
              f"engine's")
        return
    first = {uid: next(i for i, (a, b) in enumerate(zip(got[uid], ref[uid])) if a != b)
             for uid in differ}
    print(f"serve [mesh (1, 1)]: {len(ref) - len(differ)} of {len(ref)} requests' tokens equal "
          f"the single-card engine's; uid: first differing token {first}")
    prompts = {r.uid: r.prompt for r in phase4_requests(cfg)}
    worst, same_as_model = 0.0, True
    with torch.no_grad():
        for uid in differ:
            want = _prefill_last_logits(lambda *a: model(*a)[0], model.init_cache(cfg, 1, 256),
                                        prompts[uid], 0, 1, device)
            mesh_fwd = lambda *a: par.sharded_decode_step(placed, mesh, *a)[0]   # noqa: E731
            have = _prefill_last_logits(mesh_fwd, placed.init_cache(cfg, 8, 256), prompts[uid],
                                        3, 8, device)
            # the model's own forward on the same full batch
            full = _prefill_last_logits(lambda *a: model(*a)[0], model.init_cache(cfg, 8, 256),
                                        prompts[uid], 3, 8, device)
            same_as_model &= torch.equal(have, full)
            err = (have - want).abs().max().item()
            tol = MODEL_REL_TOL * want.abs().max().item()
            worst = max(worst, err / tol)
            if err > tol or got[uid][0] not in want.topk(2).indices.tolist():
                raise AssertionError(f"serve [mesh]: uid {uid} prefill logits max|d| {err} "
                                     f"(tol {tol}), first token {got[uid][0]} not in the "
                                     f"single-card top-2 {want.topk(2).indices.tolist()}")
    gen = torch.Generator(device=device).manual_seed(13)
    x = torch.randn((8 * 32, cfg.num_heads * cfg.head_dim), generator=gen, device=device)
    wq = model.blocks[0].attn.wq.weight
    rows_same = torch.equal(ops.int4_matmul(x.bfloat16(), wq)[:32],
                            ops.int4_matmul(x[:32].bfloat16(), wq))
    tall = _linear_body("K1", True, torch.bfloat16, 0, 8 * 32, wq.out_dim, wq.in_dim)
    print(f"serve [mesh (1, 1)]: the differing requests' prefill logits within the model bar, "
          f"worst max|d|/tol {worst:.3f}, first tokens in the single-card top-2; the mesh "
          f"prefill's logits {'equal' if same_as_model else 'differ from'} the model's own "
          f"forward on the same 8-row batch bit for bit; K1's rows 0-31 at {8 * 32} rows (the "
          f"{'warpgroup body' if tall == 'wg' else 'tall tile'} above {_MMA_TALL_M} rows) "
          f"{'equal' if rows_same else 'differ from'} those of a 32-row call (the decode "
          f"launch)")


def parallel_layer(card_line, ref, device="cuda", scale="layer2"):
    """Phase 11: the parallel layer on one card. Returns the kernel launches
    of its parallel-path calls."""
    t0 = time.perf_counter()
    on_card = device == "cuda"
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                         device_type="cuda" if on_card else "cpu",
                         timeout=datetime.timedelta(seconds=120))
    counts: dict = {}
    try:
        mesh = par.make_mesh(("data", "expert"), (1, 1), device_type="cuda" if on_card else "cpu")
        model, cfg = build_layer2(device, scale)
        pg = as_per_group(model)
        for name, m in (("default", model), ("per_group", pg)):
            sharded_step_vs_forward(m, cfg, mesh, name, counts, card_line, device)
        if on_card:
            mesh_step_host_costs(mesh, cfg, card_line)
        serve_mesh(model, cfg, mesh, ref, counts, card_line, device)
        split_bodies(model, pg, mesh, counts, device)
        _sync(device)
    finally:
        torch.distributed.destroy_process_group()
    missing = [k for k in ("int4_matmul", "grouped_int4_matmul", "int4_attention",
                           "grouped_int4_matmul_per_group") if not counts.get(k)]
    if missing:
        raise AssertionError(f"phase 11: never launched {missing}: {counts}")
    print(f"phase 11: kernel launches {dict((k, v) for k, v in counts.items() if v)}, no plain "
          f"version; {time.perf_counter() - t0:.1f} s")
    return counts


# --- phase 12: the graft entry points -------------------------------------------
#
# graft_entry.entry() and dryrun_multichip(n), the port's twins of the root's
# __graft_entry__.py. The twin's ranks are processes of their own (NCCL takes
# one rank per card), so their launches come back in each rank's report. Its
# geometry is JAX's and tiny; the a2a, dropless and ring EP strategies also
# run here at layer2's width on a world-size-1 group, against the single-card
# grouped product.

_PATH_KERNELS = ("int4_matmul", "grouped_int4_matmul", "int4_attention")   # K1, K2, K3


def _add(counts, launches):
    for k, v in launches.items():
        counts[k] = counts.get(k, 0) + v


def entry_on_card(card_line, counts):
    """entry() with no device: the tiny model drawn on the CPU and copied to
    the card; its step's logits against a CPU copy's within the model bar,
    K1, K2 and K3 launched and no plain version."""
    fn, (tokens, caches, positions) = entry()
    cfg = flagship_model_config("tiny")
    cpu = copy.deepcopy(fn.args[0]).cpu()
    ref = decode_step(cpu, tokens.cpu(), cpu.init_cache(cfg, 2, 32), positions.cpu()).float()
    _reset_counts()
    got = fn(tokens, caches, positions)
    torch.cuda.synchronize()
    launches = _launch_counts()
    _expect_launches("entry()", launches, _PATH_KERNELS, ())
    _add(counts, launches)
    got = got.float().cpu()
    err = (got - ref).abs().max().item()
    tol = MODEL_REL_TOL * ref.abs().max().item()
    top2 = ref[:, -1].topk(2, dim=-1).indices
    nxt = got[:, -1].argmax(dim=-1)
    if got.shape != (2, 1, cfg.vocab_size) or not (err <= tol) or not all(
            nxt[i] in top2[i] for i in range(2)):
        raise AssertionError(f"entry(): logits {tuple(got.shape)} max|d| {err} (tol {tol}), "
                             f"argmax {nxt.tolist()} vs CPU top-2 {top2.tolist()}")
    print(f"entry() on the card: logits {tuple(got.shape)} vs a CPU copy max|d| {err:.5f} <= "
          f"{tol:.5f}, argmax in the CPU top-2; launches "
          f"{dict((k, v) for k, v in launches.items() if v)}, no plain version, on {card_line}")


def multichip_twin(card_line, counts):
    """dryrun_multichip over every card (a power of two dividing 16): each
    rank's checks beside their bars, its launches and seconds."""
    n = max(d for d in (1, 2, 4, 8, 16) if d <= torch.cuda.device_count())
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = dryrun_multichip(n)
    wall = time.perf_counter() - t0
    for rep in reports:
        for c in rep["checks"]:
            if c["max_abs_diff"] is None:
                verdict = f"{c['requests']} requests, {c['tokens_each']} tokens each"
            elif c["bar"] is None:
                verdict = f"max|d| {c['max_abs_diff']} (bit for bit)"
            else:
                verdict = f"max|d| {c['max_abs_diff']:.3e} < {c['bar']}"
            print(f"dryrun_multichip({n}) rank {rep['rank']} part {c['part']} {c['name']}: "
                  f"{verdict}")
        missing = [k for k in _PATH_KERNELS if not rep["launches"][k]]
        if missing or rep["plain_calls"]:
            raise AssertionError(f"dryrun_multichip rank {rep['rank']}: never launched {missing}, "
                                 f"{rep['plain_calls']} plain-version calls")
        _add(counts, rep["launches"])
        print(f"dryrun_multichip({n}) rank {rep['rank']} on {rep['device']} ({rep['backend']}): "
              f"launches {dict((k, v) for k, v in rep['launches'].items() if v)}, plain calls "
              f"{rep['plain_calls']}; parts {rep['total_seconds']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in rep["seconds"].items()) + ")")
    print(f"dryrun_multichip({n}): {wall:.1f} s wall with the ranks' start, on {card_line}")


def full_width_ep(card_line, counts, e=8, ffn=14336, hidden=4096, t=8, n=50):
    """moe_ep_replicated, moe_ep_a2a (capacity factor 2: no pair drops at one
    rank), moe_ep_a2a_dropless and moe_ep_ring on a world-size-1 NCCL group
    at layer2's gate stack (8 experts, 4096 -> 14336, bf16) and T=8 decode
    rows, each against the single-card grouped product
    (moe_ep_replicated_body on the whole stack) within the bf16 bar; wall ms
    a call over ``n`` calls ended by one synchronize."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    qt = quantize(torch.randn((e, ffn, hidden), generator=gen, device="cuda") * hidden ** -0.5,
                  layout="planar")
    x = torch.randn((t, hidden), generator=gen, device="cuda").bfloat16()
    logits = torch.randn((t, e), generator=gen, device="cuda")
    kw = dict(top_k=2, tile_m=16)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device_type="cuda",
                         timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh(("expert",), (1,), device_type="cuda")
        calls = {"moe_ep_replicated": lambda: par.moe_ep_replicated(x, logits, qt, mesh, **kw),
                 "moe_ep_a2a": lambda: par.moe_ep_a2a(x, logits, qt, mesh, **kw),
                 "moe_ep_a2a_dropless": lambda: par.moe_ep_a2a_dropless(x, logits, qt, mesh, **kw),
                 "moe_ep_ring": lambda: par.moe_ep_ring(x, logits, qt, mesh, **kw)}
        with torch.no_grad():
            whole = par.moe_ep_replicated_body(0, 1, x, logits, qt, **kw)
            for name, fn in calls.items():
                _reset_counts()
                got = fn()
                torch.cuda.synchronize()
                launches = _launch_counts()
                _expect_launches(f"full width {name}", launches, ("grouped_int4_matmul",), ())
                _add(counts, launches)
                err, tol = _within_bar(f"full width {name}", got, whole)
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / n
                print(f"full width {name} at world size 1 ({e} experts {hidden} -> {ffn}, T={t}, "
                      f"bf16): max|d| {err:.5f} <= {tol:.5f} vs the single-card grouped product"
                      f"{' (bit for bit)' if torch.equal(got, whole) else ''}; {ms:.3f} ms a call "
                      f"(wall, {n} calls), on {card_line}")
    finally:
        torch.distributed.destroy_process_group()


def graft_entry_phase(card_line):
    """Phase 12. Returns the kernel launches of its three parts."""
    t0 = time.perf_counter()
    counts: dict = {}
    entry_on_card(card_line, counts)
    multichip_twin(card_line, counts)
    full_width_ep(card_line, counts)
    print(f"phase 12: kernel launches {dict((k, v) for k, v in counts.items() if v)}, no plain "
          f"version; {time.perf_counter() - t0:.1f} s")
    return counts


# --- phase 13: the bench twin ------------------------------------------------------


def bench_step_launches(mode: str, layers: int) -> dict:
    """What one captured decode step of an INT4 loop launches, by counter:
    5 linears a layer (q, k, v, o, router) and the lm_head, 3 expert
    projections and one attention a layer; nothing for the dense twins."""
    linears, experts = 5 * layers + 1, 3 * layers
    return {"kernel": {"int4_matmul": linears, "grouped_int4_matmul": experts,
                       "int4_attention": layers},
            "u4_turbo": {"int4_matmul_a8_fused": linears, "grouped_int4_matmul_a8": experts,
                         "int4_attention": layers},
            "xla_turbo": {"int8_linear": linears, "grouped_int4_matmul": experts,
                          "int4_attention": layers}}.get(mode, {})


# The main kernel of each counted launch of the bench loops, as the profiler
# names it: K1 and K2 (the linear body), K5 and K10 (the int8 body), K3 (the
# attention body); first and second passes have other names.
_MAIN_KERNELS = ("int4_mma_kernel", "int8_mma_kernel", "int4_attention_mma_kernel")


def traced_replay(loop, tok0) -> tuple:
    """One replay of ``loop`` under torch.profiler inside annotate("loop"):
    the range's device ms per step, and the main kernels the trace holds,
    which must be as many as the graph's counted launches."""
    def replay():
        loop.tok0.copy_(tok0)
        with annotate("loop"):
            loop.graph.replay()
        loop.toks.cpu()

    with tempfile.TemporaryDirectory(prefix="f4b_trace_") as trace_dir:
        prof = device_op_times(replay, trace_dir=trace_dir)
    seen = sum(t.count for name, t in prof.by_op.items() if any(k in name for k in _MAIN_KERNELS))
    # the ``*_wg`` and ``*_window`` counters count a share of K2's, K13's,
    # K7's, K3's and K3''s launches again
    launched = sum(v for k, v in loop.launches.items()
                   if k in ops.launch_counts() and not k.endswith(("_wg", "_window")))
    if seen != launched:
        raise AssertionError(f"traced replay: {seen} main kernels in the trace, the graph "
                             f"launched {launched}")
    return prof.main_module_ms("loop") / loop.steps, seen


def _cache_tensors(caches) -> list:
    return [getattr(c, f) for c in caches
            for f in getattr(c, "_FIELDS", ("k", "v", "lengths"))]


@contextlib.contextmanager
def _uncounted():
    """Launches and plain calls made inside are not counted: every counter
    is put back as it was on the way out."""
    saved = ([(fn, attr, getattr(fn, attr)) for _, fn, attr in ops._LAUNCH_COUNTERS]
             + [(fn, "calls", fn.calls) for fn in ops._REFERENCES + ops._PATH_CALLS])
    try:
        yield
    finally:
        for fn, attr, n in saved:
            setattr(fn, attr, n)


def path_kernels_vs_plain(name, loop, results, gen):
    """The default mode's kernels against their plain versions at the shapes
    an INT4 loop gives them: one more eager decode step (at position
    ``steps``, on the caches the loops filled) in which each K1 call (every
    linear and the lm_head) and each K2 call (gate, up, down) is made again
    through its wrapper and held against its plain version on the same
    inputs, then K3 on each layer's cache after that step for a random
    query; the bf16 bars of phase 3. Each shape's worst max|d| joins the
    kernel's rows of ``results`` (``max_abs_err`` of the kernels line).
    Nothing here is counted."""
    worst = {}

    def hold(kernel, shape, y, ref, tol):
        err = (y.float() - ref.float()).abs().max().item()
        if not torch.isfinite(y).all() or not err <= tol:
            raise AssertionError(f"bench twin {name}: {kernel} {shape} max|d| {err} > {tol}")
        key = (kernel, shape)
        worst[key] = max(worst.get(key, (0.0, tol)), (err, tol), key=lambda e: e[0] / e[1])

    def linear(mod, args, out):
        x, w = args[0], mod.weight
        if mod.activation != "bf16" or w.granularity != "per_row" or w.layout != "planar":
            raise AssertionError(f"bench twin {name}: a linear off K1 ({mod.activation}, "
                                 f"{w.granularity}, {w.layout})")
        ref = ops.int4_matmul_reference(x, w)
        hold("int4_matmul", f"M={x.numel() // x.shape[-1]} N={w.out_dim} K={w.in_dim} bf16",
             ops.int4_matmul(x, w), ref, BF16_REL_TOL * ref.float().abs().max().item())

    def grouped(mod, args, kwargs, out):
        (xs, gids), tile_m, w = args, kwargs["tile_m"], mod.weight
        ref = ops.grouped_int4_matmul_reference(xs, gids, w, tile_m=tile_m)
        hold("grouped_int4_matmul",
             f"T_pad={xs.shape[0]} tile_m={tile_m} N={w.shape[1]} K={w.shape[2]} bf16",
             ops.grouped_int4_matmul(xs, gids, w, tile_m=tile_m), ref,
             BF16_REL_TOL * ref.float().abs().max().item())

    modules = list(loop.model.modules())
    hooks = ([m.register_forward_hook(linear) for m in modules if isinstance(m, QuantizedLinear)]
             + [m.register_forward_hook(grouped, with_kwargs=True)
                for m in modules if isinstance(m, MoEINT4)])
    with _uncounted():
        try:
            tok = torch.full_like(loop.pos0, 11)
            bench.decode_loop(loop.model, loop.caches, tok, loop.pos0 + loop.steps, 1)
        finally:
            for h in hooks:
                h.remove()
        for cache in loop.caches:
            b, h_kv, _, d = cache.k_packed.shape
            hq = loop.model.blocks[0].attn.num_heads
            q = torch.randn((b, hq, d), generator=gen, device=cache.lengths.device).bfloat16()
            ref = ops.int4_attention_reference(q[:, :, None], cache, cache.lengths - 1)[:, :, 0]
            hold("int4_attention", f"decode B={b} hq={hq} h_kv={h_kv} S={cache.max_seq} "
                 f"length {loop.steps + 1}", ops.int4_decode_attention(q, cache), ref,
                 ATTN_ABS_TOL)
    if {k for k, _ in worst} != {"int4_matmul", "grouped_int4_matmul", "int4_attention"}:
        raise AssertionError(f"bench twin {name}: held only {sorted(worst)}")
    for (kernel, shape), (err, tol) in worst.items():
        results.append(dict(name=kernel, shape=f"bench {name} {shape}", err=err))
        print(f"    bench twin {name}: {kernel:20s} {shape:44s} max|d| {err:.3e} (tol "
              f"{tol:.3e}) ok")


def bench_twin(card_line, results):
    """Phase 13: bench.run() at full geometry. For each of its seven loops
    the graph's tokens from tok0 = 7 must equal the eager decode_loop's, an
    INT4 loop's caches after a replay must hold the eager loop's bytes, and
    the graph must hold bench_step_launches a step and no plain version; the
    default mode's loops hold K1, K2 and K3 against their plain versions at
    the loop's shapes (path_kernels_vs_plain). Returns the phase's kernel
    launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)

    def check(name, loop, seconds, device_ms):
        scale, mode = name.split()
        eager_s = bench.bench_eager(loop.model, loop.caches, steps=loop.steps)
        tok0 = torch.full_like(loop.pos0, 7)
        want = bench.decode_loop(loop.model, loop.caches, tok0, loop.pos0, loop.steps)
        eager_caches = [t.clone() for t in _cache_tensors(loop.caches)]
        got = loop(tok0)
        same_caches = all(torch.equal(a, b) for a, b in zip(eager_caches,
                                                            _cache_tensors(loop.caches)))
        int4 = mode in ("kernel", "u4_turbo", "xla_turbo")
        per_step = bench_step_launches(mode, flagship_model_config(scale).num_layers)
        launches = {k: n * loop.steps for k, n in per_step.items()}
        if not torch.equal(got, want) or (int4 and not same_caches) or loop.launches != launches:
            raise AssertionError(
                f"bench twin {name}: graph tokens equal eager {torch.equal(got, want)}, caches "
                f"equal {same_caches}; the graph launched {loop.launches}, want {launches}")
        traced_ms, seen = traced_replay(loop, tok0)
        print(f"bench twin {name}: graph {seconds * 1e3:.4f} ms/step wall, {device_ms:.4f} device "
              f"(CUDA events), {traced_ms:.4f} under torch.profiler (range 'loop', {seen} main "
              f"kernels == the graph's launches); captured and instantiated in "
              f"{loop.capture_seconds:.2f} s, first (untimed) replay "
              f"{loop.first_replay_seconds * 1e3 / loop.steps:.4f} ms/step; eager "
              f"{eager_s * 1e3:.4f} ms/step wall; graph tokens == eager tokens from tok0 = 7 "
              f"({tuple(got.shape)}), caches after the replay "
              f"{'==' if same_caches else '!='} the eager loop's; a captured step launches "
              f"{per_step or 'no counted kernel'}, no plain version, on {card_line}", flush=True)
        if mode == "kernel":
            path_kernels_vs_plain(name, loop, results, gen)

    _reset_counts()
    result = bench.run(on_loop=check)
    launches = _launch_counts()
    _expect_launches("bench twin", launches,
                     ("int4_matmul", "grouped_int4_matmul", "int4_attention",
                      "int4_matmul_a8_fused", "grouped_int4_matmul_a8"), ())
    device_keys = ("int4_kernel_device_ms", "int4_u4_turbo_device_ms", "bf16_strong_device_ms",
                   "vs_strong_dense_device")
    missing = [k for k in device_keys if not isinstance(result[k], float)]
    if missing or not ops.int8_linear.calls or result["backend"] != "gpu":
        raise AssertionError(f"bench twin: device ms missing {missing}, int8_linear calls "
                             f"{ops.int8_linear.calls}, backend {result['backend']}")
    print(json.dumps(result))
    print(f"phase 13: kernel launches {dict((k, v) for k, v in launches.items() if v)}, "
          f"int8_linear {ops.int8_linear.calls}, no plain version; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    card_line = require_card()
    build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        print(f"kernels vs plain versions (times: median, L2 flushed, on {card_line}):")
        results = check_kernels()
        window_launches = check_window_attention(timer=Timer("cuda"), results=results)
        mla_launches = check_mla_attention(timer=Timer("cuda"), results=results)
    model, cfg = build_layer2()
    pg_kernels = tuple(fn.__name__ for fn in _PG_OPS)
    launches, eng, _ = serve(model, cfg, "default", card_line)
    _expect_launches("serve [default]", launches,
                     ("int4_matmul", "grouped_int4_matmul", "int4_attention"),
                     ("int4_matmul_a8_fused", "grouped_int4_matmul_a8", "paged_int4_attention",
                      "grouped_int4_matmul_ksplit", "int4_matmul_per_group_planar",
                      "grouped_int4_matmul_per_group_planar") + pg_kernels)
    launches["mla_attention"] = mla_launches["mla_attention"]
    ref = dict(eng.finished)
    launches["paged_int4_attention"] = serve_paged(model, cfg, ref, card_line)[
        "paged_int4_attention"]
    serve_blocks(model, cfg, ref, card_line)
    serve_speculative(model, cfg, ref, card_line)
    launches_u4, _, _ = serve(as_u4_turbo(model), cfg, "u4_turbo", card_line)
    _expect_launches("serve [u4_turbo]", launches_u4,
                     ("int4_matmul_a8_fused", "grouped_int4_matmul_a8", "int4_attention"),
                     ("int4_matmul", "grouped_int4_matmul") + pg_kernels)
    for name in ("int4_matmul_a8_fused", "grouped_int4_matmul_a8"):
        launches[name] = launches_u4[name]
    t0 = time.perf_counter()
    pg = as_per_group(model)       # requantized on the card, per group of 128
    torch.cuda.synchronize()
    print(f"as_per_group(layer2): {time.perf_counter() - t0:.2f} s")
    # per_group: K7 for every linear but the router (K1), K13 for the experts
    launches_pg, _, _ = serve(pg, cfg, "per_group", card_line)
    _expect_launches("serve [per_group]", launches_pg,
                     ("int4_matmul_per_group", "grouped_int4_matmul_per_group",
                      "int4_attention", "int4_matmul"),
                     ("grouped_int4_matmul", "int4_matmul_per_group_a8",
                      "grouped_int4_matmul_per_group_a8"))
    # pg_turbo: K8 for every linear but the router (K5), K14 for the experts
    launches_pgt, _, _ = serve(as_turbo(pg), cfg, "pg_turbo", card_line)
    _expect_launches("serve [pg_turbo]", launches_pgt,
                     ("int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8",
                      "int4_attention", "int4_matmul_a8_fused"),
                     ("grouped_int4_matmul", "grouped_int4_matmul_a8", "int4_matmul_per_group",
                      "grouped_int4_matmul_per_group"))
    for name, runs in (("int4_matmul_per_group", launches_pg),
                       ("grouped_int4_matmul_per_group", launches_pg),
                       ("int4_matmul_per_group_a8", launches_pgt),
                       ("grouped_int4_matmul_per_group_a8", launches_pgt)):
        launches[name] = runs[name]
    launches_ops = op_entry_points()
    for name in ("int4_matmul_a8", "grouped_int4_matmul_a8_fused", "grouped_int4_matmul_ksplit"):
        launches[name] = launches_ops[name]
    long_prefill(model, pg, cfg)
    del model, pg
    torch.cuda.empty_cache()
    converted = full_width_conversion(card_line)
    for name in ("int4_matmul_per_group_planar", "grouped_int4_matmul_per_group_planar"):
        launches[name] = converted["per_group128"][name]
    trained_checkpoint(card_line)
    for mode, convert in (("kernel", None), ("u4_turbo", as_u4_turbo), ("turbo", as_turbo),
                          ("xla_turbo", as_xla_turbo), ("per_group", as_per_group),
                          ("pg_turbo", as_pg_turbo)):
        whole_model(mode=mode, convert=convert)
    whole_model(paged=True)
    persistence_and_utilities(card_line, ref, results)
    parallel_launches = parallel_layer(card_line, ref)
    graft_launches = graft_entry_phase(card_line)
    bench_launches = bench_twin(card_line, results)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in results if r["name"] == name]
        main_row = next(r for r in rows if r["shape"] == MAIN_SHAPE[name])
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name],
                            parallel_launches=parallel_launches.get(name, 0),
                            graft_launches=graft_launches.get(name, 0),
                            bench_launches=bench_launches.get(name, 0),
                            max_abs_err=max(r["err"] for r in rows),
                            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                            library_ms=main_row["library_ms"]))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "window_launches": window_launches}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
