"""INT4 weight-only linear, ``x @ dequant(W)^T``, over kernels K1, K4, K5,
K6, K7 and K8.

Counterpart of ``fused4bit_tpu/ops/int4_matmul.py``. Each wrapper checks its
weights' format, names the body its call runs (:func:`_body`), then runs the
front end shared with ``grouped_matmul`` (``_front``) and the body's
launcher: the tensor-core body of ``csrc/int4_mma.cuh`` (``_mma``), the
warpgroup body of ``csrc/grouped_wgmma.cu`` (``_wg``), the int8 tensor-core
body of ``csrc/int8_mma.cuh`` (``_int8``) or the CUDA-core loops of
``csrc/int4_rows*.cuh`` (``_rows``). On a CPU tensor it runs the plain
version instead.

* ``int4_matmul`` (w4a16): K1 through ``csrc/int4_matmul.cu`` (the port of
  the TPU kernel ``_int4_matmul_kernel``), bf16 from
  :data:`WG_MIN_LINEAR_ROWS` rows on the warpgroup body; plain version
  :func:`int4_matmul_reference`. Above ``prefill_threshold`` rows, as in the
  JAX package, the product is computed outside any kernel: dequantize once,
  then a dense matmul.
* ``int4_matmul_a8`` (w4a8): per-row int8 activations and an exact integer
  dot, K4 (the port of ``_int4_a8_kernel``, which takes activations
  quantized by the host quantizer, a division by 127, see
  :func:`~.int8_xla._quantize_acts`) or K5 (the port of
  ``_int4_a8_fused_kernel``, which quantizes with XLA's folded f32(1/127)):
  both the int8 body as a one-expert stack, K10's arithmetic, its first pass
  quantizing in the kernel's own arithmetic. Plain version
  :func:`int4_matmul_a8_reference`.
* ``int4_matmul_per_group`` (w4a16, per-group weights), at every row count:
  in the planar_groups layout K7 in ``csrc/int4_matmul_pg.cu`` (the port of
  ``_int4_group_bp_kernel``), plain version
  :func:`int4_matmul_per_group_reference`; in the planar layout (what
  ``models.convert`` produces) K6 in ``csrc/int4_matmul.cu`` (the port of
  ``_int4_group_kernel``), plain version
  :func:`int4_matmul_per_group_planar_reference`.
* ``int4_matmul_per_group_a8`` (w4a8, the same weights): the activations are
  quantized before the main kernel, as the TPU wrapper does, then K8 (the
  port of ``_int4_group_bp_a8_kernel``). Plain version
  :func:`int4_matmul_per_group_a8_reference`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize, unpack_planar
from ..quant.reference import full_precision, reference_linear_qt
from ..utils.profiling import span
from . import _front, _int8, _mma, _rows, _wg
from .int8_xla import _quantize_acts

__all__ = [
    "int4_matmul", "int4_matmul_reference", "int4_matmul_a8", "int4_matmul_a8_reference",
    "int4_matmul_per_group", "int4_matmul_per_group_reference",
    "int4_matmul_per_group_planar_reference",
    "int4_matmul_per_group_a8", "int4_matmul_per_group_a8_reference", "quantized_linear",
]

# The JAX fuse gate (int4_matmul.py:1289-1299), kept as it stands: fuse the
# quantization at K <= 2 * _SHALLOW_KH while the raw-x block and its i8 copy
# fit 4 MiB. On the TPU it weighs quantizing inside the kernel against
# before it; on the card K4 and K5 both quantize in the int8 body's first
# pass, so that trade is gone. It stays JAX's because it picks the
# quantizer's arithmetic (K4 divides by 127, K5 multiplies by f32(1/127)),
# and with it the bits JAX gives.
_SHALLOW_KH = 3072
# K1's row threshold, measured on the H100 (scripts/linear_sweep.py): the
# largest M it sweeps below every shape's crossover, the first M at which
# dequantize + matmul beats the kernel (the warpgroup body at N % 128 == 0,
# else the tall tile), at the `layer2` and Mixtral-8x7B linears. The body
# beats the dense path at every M swept (65-4096 rows; 5.3x at 576 on q,
# 1.7x at 4096 on the LM head); the router (N=8, the tall tile) first loses
# at 4096 rows (PERF.md section 6).
PREFILL_THRESHOLD = 2048
# Rows of x from which a bf16 K1 or K7 call runs the warpgroup body, measured:
# scripts/linear_sweep.py (K1) and --pg (K7) on an H100 80GB HBM3 at 700 W
# time the body against the tall tile at 65 rows and above, and the body
# wins at every linear from 65 (K7 1.3-2.5x; PERF.md section 6 has the
# readings). Below 65 K1 and K7 keep their decode tile.
WG_MIN_LINEAR_ROWS = 65

_BODIES = {"mma": _mma, "wg": _wg, "int8": _int8, "rows": _rows}
# each kernel's launch counter on its wrapper
_COUNTERS = {"K1": "launches", "K4": "launches", "K5": "fused_launches",
             "K6": "planar_launches", "K7": "launches", "K8": "launches"}


def _body(kernel: str, cuda: bool, dtype: torch.dtype, group_size: int, m: int, n: int, k: int,
          prefill_threshold: int = PREFILL_THRESHOLD) -> str:
    """The body a linear call runs, named from its kernel (which stands for
    the weights' format: K1 and K4/K5 per row, K6 planar per group, K7
    planar_groups, K8 its w4a8 twin), device, activations' type, group size
    and shape alone:

    * ``"dense"``: K1 above ``prefill_threshold`` rows, on either device;
    * ``"plain"``: a CPU tensor, the plain version;
    * ``"int8"``: K4 and K5, and K8 at ``gs % 32 == 0`` (a chunk of 32 or
      64 packed bytes never straddles a group);
    * ``"rows"``: f32 x on the other kernels (an f32 tensor-core product
      would be TF32), K8 at the other multiples of 16, K7 at those off 64;
    * ``"wg"``: K1 and K7 from :data:`WG_MIN_LINEAR_ROWS` rows (above
      ``_mma._MMA_TALL_M``: never at decode or the verify, whose decode tile
      they keep) where the warpgroup body takes the format and shape;
    * ``"mma"``: else (bf16 K1, K6, and K7 at ``gs % 64 == 0``), on the
      decode or tall tile that ``_mma._tile_rows`` gives M."""
    if kernel == "K1" and m > prefill_threshold:
        return "dense"
    if not cuda:
        return "plain"
    if kernel in ("K4", "K5") or kernel == "K8" and group_size % 32 == 0:
        return "int8"
    if dtype != torch.bfloat16 or kernel == "K8" or kernel == "K7" and group_size % _mma._FOLD_GS:
        return "rows"
    if kernel in ("K1", "K7") and m >= WG_MIN_LINEAR_ROWS and _wg._wg_takes(dtype, group_size,
                                                                            n, k):
        return "wg"
    return "mma"


def _dense(x2: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    with span("linear.dense"):
        wd = dequantize(qt, dtype=x2.dtype)
        return torch.matmul(x2, wd.t())


def _run(wrapper, kernel: str, x: torch.Tensor, qt: QuantizedTensor, plain,
         prefill_threshold: int = PREFILL_THRESHOLD) -> torch.Tensor:
    """A call of ``kernel`` from ``wrapper``, its weights' format checked:
    the body :func:`_body` names, the front end, then the body's launch,
    counted on the wrapper; or the dense path, or ``plain(x2, qt)``.
    [..., N] out."""
    n, k = qt.out_dim, qt.in_dim
    body = _body(kernel, x.is_cuda, x.dtype, qt.group_size, x.numel() // k, n, k,
                 prefill_threshold)
    x2, y = _front._prepare(kernel, x, qt, body,
                          functools.partial(_dense if body == "dense" else plain, qt=qt))
    if y is None:
        y = _BODIES[body]._launch(x2, qt, kernel)
        setattr(wrapper, _COUNTERS[kernel], getattr(wrapper, _COUNTERS[kernel]) + 1)
        if body == "wg":
            wrapper.wg_launches += 1
    return y.reshape(*x.shape[:-1], n)


def int4_matmul_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K1: dequantize, then a float32 matmul; x.dtype out.
    Any format: it is also the golden path of the formats no kernel takes
    (per_tensor, the interleaved and block_planar layouts; ``QuantizedLinear``,
    as in JAX)."""
    int4_matmul_reference.calls += 1
    return reference_linear_qt(x, qt, dtype=x.dtype)


int4_matmul_reference.calls = 0


def int4_matmul(
    x: torch.Tensor, qt: QuantizedTensor, *, prefill_threshold: int = PREFILL_THRESHOLD
) -> torch.Tensor:
    """``x @ dequant(qt)^T`` without materializing the dense weight.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N]
    in x.dtype. Rows above ``prefill_threshold`` dequantize once and run a
    dense matmul in x.dtype with float32 accumulation.
    """
    _front._check_per_row(qt)
    return _run(int4_matmul, "K1", x, qt, int4_matmul_reference, prefill_threshold)


int4_matmul.launches = 0
int4_matmul.wg_launches = 0  # of which on the warpgroup body


def quantized_linear(x: torch.Tensor, qt: QuantizedTensor, **kw) -> torch.Tensor:
    """:func:`int4_matmul` under the reference library's forward name."""
    return int4_matmul(x, qt, **kw)


def int4_matmul_a8_reference(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: bool = False
) -> torch.Tensor:
    """Plain version of K4 and K5: quantize (with K5's quantizer when
    ``fuse_quant``, see :func:`~.int8_xla._quantize_acts`), exact dot, JAX's
    epilogue; x.dtype out."""
    int4_matmul_a8_reference.calls += 1
    xq, sx = _quantize_acts(x, fused=fuse_quant)
    return _int8._a8_product(xq, sx, qt.packed, qt.scales, qt.zero_points).to(x.dtype)


int4_matmul_a8_reference.calls = 0


def int4_matmul_a8(
    x: torch.Tensor, qt: QuantizedTensor, *, fuse_quant: Optional[bool] = None
) -> torch.Tensor:
    """w4a8 linear: per-row int8 activations, exact integer dot.

    x: [..., K] (bf16 or f32); qt: per_row planar [N, K]. Returns [..., N] in
    x.dtype, at every row count (no dequantize fallback, as in JAX).
    ``fuse_quant``: quantize as the TPU kernel that quantizes inside itself
    does (K5: XLA's folded multiply by f32(1/127)) rather than as the host
    quantizer (K4: a division by 127); None applies the JAX gate. On the
    card both run the int8 body's first pass in that arithmetic, then its
    main kernel. On a CPU tensor the plain version runs with the quantizer
    of the kernel that ``fuse_quant`` picks.
    """
    _front._check_per_row(qt)
    k = qt.in_dim
    if fuse_quant is None:
        tile_m = min(-(-max(x.numel() // k, 1) // 32) * 32, 256)
        fuse_quant = (k <= 2 * _SHALLOW_KH
                      and tile_m * k * (x.element_size() + 1) <= 4 * 1024 * 1024)
    return _run(int4_matmul_a8, "K5" if fuse_quant else "K4", x, qt,
                functools.partial(int4_matmul_a8_reference, fuse_quant=fuse_quant))


int4_matmul_a8.launches = 0        # K4
int4_matmul_a8.fused_launches = 0  # K5


# --- per-group weights: K7 (w4a16) and K8 (w4a8) on planar_groups, K6 on planar ---


def int4_matmul_per_group_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K7: dequantize, then a float32 matmul; x.dtype out.
    Any per_group weight: it is also the golden path of the per-group group
    sizes no kernel serves (``QuantizedLinear``, as in JAX)."""
    int4_matmul_per_group_reference.calls += 1
    return reference_linear_qt(x, qt, dtype=x.dtype)


int4_matmul_per_group_reference.calls = 0


def planar_pg_weight(packed: torch.Tensor, scales: torch.Tensor, zero_points: torch.Tensor,
                     group_size: int, dtype: torch.dtype) -> torch.Tensor:
    """The planar per-group weight [..., N, K] as K6 and K12 dequantize it,
    held in f32: ``dtype(dtype(s) * (q - zp))``, the scale rounded to the
    compute type ``dtype``, then the product (exact in f32 for a bf16 scale)
    rounded to it. In bf16 that is two roundings, which is not
    :func:`~..quant.core.dequantize` (one f32 rounding)."""
    q = unpack_planar(packed).float()                                  # [..., N, K]
    qg = q.reshape(*q.shape[:-1], q.shape[-1] // group_size, group_size)
    s = scales.to(dtype).float()[..., None]
    w = (s * (qg - zero_points.float()[..., None])).to(dtype).float()
    return w.reshape(q.shape)


def int4_matmul_per_group_planar_reference(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Plain version of K6: the weight dequantized to the compute type as the
    TPU kernel does (:func:`planar_pg_weight`), then a float32 matmul;
    x.dtype out."""
    int4_matmul_per_group_planar_reference.calls += 1
    w = planar_pg_weight(qt.packed, qt.scales, qt.zero_points, qt.group_size,
                         _front._compute_dtype(x))
    with full_precision():
        y = torch.matmul(x.float(), w.transpose(-1, -2))
    return y.to(x.dtype)


int4_matmul_per_group_planar_reference.calls = 0


def int4_matmul_per_group(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt)^T`` for per-group weights, at every row count (the
    JAX per-group linear has no dequantize fallback).

    x: [..., K] (bf16 or f32); qt: per_group [N, K], planar_groups (K7) or
    planar with ``gs % 128 == 0`` (K6). Returns [..., N] in x.dtype.
    """
    _front._check_per_group(qt)
    if qt.layout == "planar":
        return _run(int4_matmul_per_group, "K6", x, qt, int4_matmul_per_group_planar_reference)
    return _run(int4_matmul_per_group, "K7", x, qt, int4_matmul_per_group_reference)


int4_matmul_per_group.launches = 0         # K7
int4_matmul_per_group.planar_launches = 0  # K6
int4_matmul_per_group.wg_launches = 0      # of K7's, on the warpgroup body


def int4_matmul_per_group_a8_reference(x: torch.Tensor, qt: QuantizedTensor, *,
                                       launch: Optional[tuple] = None) -> torch.Tensor:
    """Plain version of K8: the TPU wrapper's activation quantizer, then the
    product in the order of the body K8 runs on the card (:func:`_body`): on
    the int8 body its fold at ``launch``, by default its rule's shape, which
    reads no M (``_int8._fold_plain``); on the CUDA-core loop its per-run
    fold (``_rows._pg_a8_product``); x.dtype out."""
    int4_matmul_per_group_a8_reference.calls += 1
    n, k = qt.shape
    gs = qt.group_size
    xq, sx = _quantize_acts(x, fused=True)
    product = (_int8._fold_plain(x, "K8", n, k, gs, launch)
               if _body("K8", True, x.dtype, gs, x.shape[0], n, k) == "int8"
               else _rows._pg_a8_product)
    return product(xq, sx, qt.packed, qt.scales, qt.zero_points).to(x.dtype)


int4_matmul_per_group_a8_reference.calls = 0


def int4_matmul_per_group_a8(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """w4a8 linear for per-group weights: per-row int8 activations, exact
    integer partials per run, at every row count.

    x: [..., K] (bf16 or f32); qt: per_group planar_groups [N, K] with
    ``127 * 128 * gs < 2**24``. Returns [..., N] in x.dtype. The activations
    are quantized before the main kernel with the TPU wrapper's quantizer,
    which XLA compiles with ``amax / 127.0`` folded into a multiply by
    f32(1/127) (``_quantize_acts(x, fused=True)``): on the int8 body by its
    first pass, on the CUDA-core loop by the host quantizer (:func:`_body`
    says which).
    """
    _front._check_per_group(qt, a8=True)
    return _run(int4_matmul_per_group_a8, "K8", x, qt, int4_matmul_per_group_a8_reference)


int4_matmul_per_group_a8.launches = 0  # K8
