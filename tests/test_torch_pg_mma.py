"""K7 on the tensor-core body (``csrc/int4_mma.cuh``, its GroupFold policy),
in what the CPU can check: the raw-code register values, a plain-torch model
of the body's per-chunk fold held against the JAX package's K7 in interpret
mode, the difference from K6's numerics, and the launch choice.

The model repeats the body's arithmetic where it is fixed: the raw codes
(low half q in [0, 15], high half q - 8 in [-8, 7], no zero point and no
scale), per chunk of 64 packed bytes the two partial dots P_lo, P_hi and
the sums X of x over the chunk's columns (8 vectors of 8 summed as a tree,
then in order), the fold ``acc += s_lo*P_lo; acc += c_lo*X_lo; acc +=
s_hi*P_hi; acc += c_hi*X_hi`` in chunk order within each warp's slice of K,
the warps of a CTA added in order, then the CTAs along K in order (the
launch shape of ``_fold_mma_launch``). Where it is not (the order in which
the tensor cores sum a 16-wide step, the FMA's single rounding), the model
sums exactly and rounds once, and multiplies then adds.

Tolerances: the register values are held bit for bit; the model against
JAX's interpret-mode K7 at 1e-3 of the largest output in f32 and 2e-2 in
bf16 (one bf16 rounding of each side, and the f32 sums in another order).
"""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fused4bit_tpu.ops.int4_matmul import int4_matmul_per_group as jax_pg
from fused4bit_tpu.quant.core import quantize as jax_quantize
from fused4bit_tpu_torch.ops._mma import _FOLD_GS, _fold_mma_launch, _mma_launch, _mma_tall_launch
from fused4bit_tpu_torch.ops.int4_matmul import planar_pg_weight
from fused4bit_tpu_torch.quant import planar_groups_to_planar, unpack_planar

im = importlib.import_module("fused4bit_tpu_torch.ops.int4_matmul")
BYTES = torch.arange(256, dtype=torch.int32)
SMS = 132                      # the H100's SMs
CHUNK = 64                     # packed bytes per chunk (8 k steps of the body)


def _bf16_bits(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int16).view(torch.bfloat16)


def k7_codes(p: torch.Tensor):
    """The body's raw-code operand A for bytes ``p`` (int32 0..255), as
    (lo, hi) bf16: ``0x4300 | (p & 0xF)`` minus bf16 128 and ``0x4308 ^
    (p >> 4 & 0xF)`` minus bf16 136, each ``__hsub2`` one bf16 subtraction."""
    lo = _bf16_bits((p & 0xF) | 0x4300) - torch.tensor(128.0, dtype=torch.bfloat16)
    hi = _bf16_bits(((p >> 4) & 0xF) ^ 0x4308) - torch.tensor(136.0, dtype=torch.bfloat16)
    return lo, hi


def test_k7_register_codes_are_the_raw_codes():
    """All 256 bytes: the low value is the low nibble's code, the high value
    the high nibble's code minus 8, which is the TPU kernel's
    int8(p & 0xF0) / 16 (its vhi, with s_hi / 16 as the multiplier) exactly;
    no zero point and no scale enter."""
    lo, hi = k7_codes(BYTES)
    codes = unpack_planar(BYTES.to(torch.uint8)[None, :]).float()[0]     # [512]: lo, hi halves
    assert torch.equal(lo.float(), codes[:256])
    assert torch.equal(hi.float(), codes[256:] - 8)
    vhi = (BYTES & 0xF0).to(torch.uint8).view(torch.int8).float()
    assert torch.equal(hi.float(), vhi / 16)


def _tree_sum8(v: torch.Tensor) -> torch.Tensor:
    """((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)) over the last dim of 8, f32."""
    a = [v[..., i] for i in range(8)]
    return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]))


def _chunk_sums(x: torch.Tensor) -> torch.Tensor:
    """X of each 64-column chunk of x [M, C*64] (f32), in the body's order:
    the 8 vectors of 8 as trees, then added in order."""
    v = x.float().reshape(x.shape[0], -1, 8, 8)                          # [M, chunks, vec, 8]
    t = _tree_sum8(v)                                                    # [M, chunks, 8]
    s = torch.zeros(t.shape[:2])
    for u in range(8):
        s = s + t[..., u]
    return s


def k7_fold_model(x: torch.Tensor, packed3: torch.Tensor, scales: torch.Tensor,
                  zps: torch.Tensor, launch: tuple) -> torch.Tensor:
    """The tensor-core K7 in plain torch, f32 out: x [M, K] (its values as
    the kernel stages them), planar_groups bytes [Gh, N, gs], scales and zero
    points [N, 2Gh], and the launch shape ``(ws, kw, splits)`` (k steps per
    warp, warps along K per CTA, CTAs along K; 8 k steps per chunk)."""
    ws, kw, splits = launch
    m, k = x.shape
    gh, n, gs = packed3.shape
    kh = gh * gs
    chunks = kh // CHUNK
    codes = unpack_planar(planar_groups_to_planar(packed3)).double()     # [N, K]
    q_lo, q_hi = codes[:, :kh], codes[:, kh:] - 8.0                      # the raw codes
    xd = x.double()
    x_lo, x_hi = _chunk_sums(x[:, :kh]), _chunk_sums(x[:, kh:])          # [M, chunks]
    s, z = scales.float(), zps.float()

    def fold(acc, c):
        cols = slice(c * CHUNK, (c + 1) * CHUNK)
        g = c * CHUNK // gs                                              # the chunk's group
        p_lo = (xd[:, :kh][:, cols] @ q_lo[:, cols].t()).float()        # exact, rounded once
        p_hi = (xd[:, kh:][:, cols] @ q_hi[:, cols].t()).float()
        s_lo, s_hi = s[:, g], s[:, gh + g]
        c_lo, c_hi = (-s_lo) * z[:, g], s_hi * (8.0 - z[:, gh + g])
        acc = acc + s_lo * p_lo
        acc = acc + c_lo * x_lo[:, c:c + 1]
        acc = acc + s_hi * p_hi
        return acc + c_hi * x_hi[:, c:c + 1]

    per_warp = ws // 8                                                   # chunks of a warp's slice
    y = torch.zeros((m, n))
    for split in range(splits):                                          # CTAs along K, in order
        cta = torch.zeros((m, n))
        for w in range(kw):                                              # the CTA's warps, in order
            acc = torch.zeros((m, n))
            first = (split * kw + w) * per_warp
            for c in range(first, min(first + per_warp, chunks)):
                acc = fold(acc, c)
            cta = cta + acc
        y = y + cta
    return y


def _jax_pg(w, gs):
    return jax_quantize(jnp.asarray(w), granularity="per_group", layout="planar_groups",
                        group_size=gs)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gs", [128, 64])
@pytest.mark.parametrize("m,launch", [(3, None), (40, (16, 1, 2))])
def test_k7_fold_model_matches_jax_kernel(rng, m, launch, gs, dtype):
    """The model against JAX's interpret-mode K7 on the same bytes, for a
    384 x 512 weight at the launch rule's shape (8 warps along K, one chunk
    each) and at 2 CTAs along K of one warp with 2 chunks."""
    n, k = 384, 512
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref_qt = _jax_pg(w, gs)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jax_pg(jx, ref_qt).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))           # the staged values
    launch = launch or _fold_mma_launch(n, k, SMS)
    y = k7_fold_model(xt, _t(ref_qt.packed), _t(ref_qt.scales), _t(ref_qt.zero_points), launch)
    if dtype == "bfloat16":
        y = y.bfloat16().float()
    tol = {"float32": 1e-3, "bfloat16": 2e-2}[dtype]
    assert np.max(np.abs(y.numpy() - ref)) <= tol * np.max(np.abs(ref))


def test_k7_fold_is_not_k6_dequantization(rng):
    """One-hot rows of x read the weight's columns. K7 folds the f32 scale
    into f32 sums, so its columns are s * (q - zp) to f32 precision, as JAX's
    K7 gives them; K6 rounds the scale and the product to bf16
    (``planar_pg_weight``), 2^-9 off. The model must be K7's, not K6's."""
    n, k, gs = 16, 256, 128
    w = rng.standard_normal((n, k)).astype(np.float32) * k ** -0.5
    ref_qt = _jax_pg(w, gs)
    eye = np.eye(k, dtype=np.float32)
    cols = np.asarray(jax_pg(jnp.asarray(eye), ref_qt)).T                # [N, K]
    p3, s, z = _t(ref_qt.packed), _t(ref_qt.scales), _t(ref_qt.zero_points)
    got = k7_fold_model(torch.from_numpy(eye), p3, s, z, (8, 1, 2)).numpy().T
    k6 = planar_pg_weight(planar_groups_to_planar(p3), s, z, gs, torch.bfloat16).numpy()
    scale = np.max(np.abs(cols))
    assert np.max(np.abs(got - cols)) <= 1e-6 * scale
    assert np.max(np.abs(k6 - cols)) > 1e-4 * scale


def test_k7_body_is_chosen_by_dtype_and_group_size_only():
    """The tensor-core body for bf16 activations at gs % 64 == 0, the
    CUDA-core loop for f32 activations and for the other group sizes
    planar_groups takes (gs % 16 == 0), at decode and the verify's rows; the
    choice reads the call's kernel, device, type, group size and shape."""
    assert set(inspect.signature(im._body).parameters) <= {
        "kernel", "cuda", "dtype", "group_size", "m", "n", "k", "prefill_threshold"}
    assert _FOLD_GS == CHUNK
    for m in (8, 40):
        for gs in (64, 128, 256, 512):
            assert im._body("K7", True, torch.bfloat16, gs, m, 4096, 4096) == "mma"
            assert im._body("K7", True, torch.float32, gs, m, 4096, 4096) == "rows"
        for gs in (16, 32, 48, 80, 96, 160):
            assert im._body("K7", True, torch.bfloat16, gs, m, 4096, 4096) == "rows"


# The K7 linears of `layer2` in the per_group mode: q and o, k and v, the LM
# head (the router stays per row, on K1); and deeper or odd shapes.
LAYER2_K7 = [(4096, 4096), (1024, 4096), (8192, 4096)]


@pytest.mark.parametrize("n,k", LAYER2_K7 + [(4096, 14336), (8, 4096), (384, 512), (96, 256)])
def test_fold_launch_gives_whole_chunks_and_groups(n, k):
    """K7's decode shape reads (N, K, SMs) only, gives every warp whole
    chunks (its fold point), covers K with no CTA beyond it, and at the
    layer2 shapes is K1's shape, with every CTA's range whole groups of 128
    (16 k steps); the prefill shape splits K in whole stages of 32 steps."""
    assert list(inspect.signature(_fold_mma_launch).parameters) == ["n", "k", "sms"]
    ws, kw, splits = _fold_mma_launch(n, k, SMS)
    steps = 8 * -(-(k // 2) // CHUNK)
    assert ws % 8 == 0 and ws <= 32 and kw in (1, 2, 4, 8)
    assert (splits - 1) * kw * ws < steps <= splits * kw * ws
    if (n, k) in LAYER2_K7:
        assert (ws, kw, splits) == _mma_launch(n, k, SMS)
        assert (kw * ws) % 16 == 0
    for m in (65, 640):
        tall_ws, _, _ = _mma_tall_launch(n, k, m, SMS)
        assert tall_ws % 32 == 0


@pytest.mark.parametrize("n,k", LAYER2_K7)
def test_fold_model_covers_each_chunk_once(n, k):
    """The model's walk over the launch shape (CTAs along K, warps, chunks)
    visits every chunk of K/2 exactly once, in order."""
    ws, kw, splits = _fold_mma_launch(n, k, SMS)
    chunks = (k // 2) // CHUNK
    seen = [c for split in range(splits) for w in range(kw)
            for c in range((split * kw + w) * (ws // 8),
                           min((split * kw + w + 1) * (ws // 8), chunks))]
    assert seen == list(range(chunks))

