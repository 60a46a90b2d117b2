"""Grouped INT4 product for the MoE experts, over kernels K2, K9, K10, K11,
K12, K13 and K14.

Counterpart of ``fused4bit_tpu/ops/grouped_matmul.py``:
``out[t] = x_sorted[t] @ dequant(W[tile_group_ids[t // tile_m]])^T`` over
tokens sorted by expert, each expert's group zero-padded to a multiple of
``tile_m``. Each wrapper launches once on a CUDA tensor, with no host loop
and no device-to-host sync, and runs its plain version on a CPU tensor. As in
``int4_matmul``, it checks its weights' format, names the body its call runs
(:func:`_body`), then runs the shared front end (``_front``) and the body's
launcher (``_mma``, ``_wg``, ``_int8`` or ``_rows``):

* ``grouped_int4_matmul`` (w4a16): ``csrc/grouped_matmul.cu``, K2 (the port
  of the TPU kernel ``_grouped_kernel``), or with ``mode="ksplit"`` K9 (the
  port of ``_grouped_ksplit_kernel``), K split across CTAs, the ordered
  second pass adding them;
* ``grouped_int4_matmul_a8`` (w4a8, per-row int8 activations, exact integer
  dot): ``csrc/grouped_matmul_a8.cu``, K10 (the port of
  ``_grouped_a8_kernel``) and K11 (the port of ``_grouped_a8_fused_kernel``),
  both on the int8 body after a first pass that quantizes the rows: K10 with
  the host quantizer's division by 127, K11 with XLA's folded multiply by
  f32(1/127);
* ``grouped_int4_matmul_per_group`` (w4a16, per-group experts): in the
  planar_groups layout ``csrc/grouped_matmul_pg.cu``, K13 (the port of
  ``_grouped_pg_bp_kernel``); in the planar layout (what ``models.convert``
  produces) ``csrc/grouped_matmul.cu``, K12 (the port of
  ``_grouped_pg_kernel``, under K6's arithmetic);
* ``grouped_int4_matmul_per_group_a8`` (w4a8, the same experts): K14 (the
  port of ``_grouped_pg_bp_a8_kernel``) on activations quantized before the
  main kernel, as the TPU wrapper does.

The bodies' launch rules read the weights' shape, the group size and the
SM count, never the routing; bf16 K2 and K13 calls of at least
:data:`WG_MIN_EXPERT_ROWS` routed rows an expert run the warpgroup body.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..quant.core import QuantizedTensor, dequantize
from ..quant.reference import full_precision
from . import _front, _int8, _mma, _rows, _wg
from .int4_matmul import planar_pg_weight
from .int8_xla import _quantize_acts

__all__ = [
    "grouped_int4_matmul", "grouped_int4_matmul_reference",
    "grouped_int4_matmul_a8", "grouped_int4_matmul_a8_reference",
    "grouped_int4_matmul_per_group", "grouped_int4_matmul_per_group_reference",
    "grouped_int4_matmul_per_group_planar_reference",
    "grouped_int4_matmul_per_group_a8", "grouped_int4_matmul_per_group_a8_reference",
]

# grouped_int4_matmul's modes: None, "n_inner", "m_inner" and "x_resident"
# are the TPU kernel's VMEM schedules of one computation (K2 here);
# "ksplit" is K9.
MODES = (None, "n_inner", "m_inner", "x_resident", "ksplit")
# Routed rows an expert from which a bf16 K2 or K13 call runs the warpgroup
# body: ``T_pad - E * tile_m`` (a dropless plan's T_pad less the tile of
# padding it gives each expert, fixed at capture) over E. Measured on the
# H100 (scripts/grouped_mma_sweep.py --crossover; PERF.md) at 8 experts
# top-2 (the benchmark cells' widths), 16 top-2 and 64 top-8: at 24 rows an
# expert the body is the faster in every projection (1.2-1.6x), at 20 too
# (16 and 64 experts), at 16 in all but K13 at 64 experts, and from 12 rows
# down it loses, by up to 1.9x. There an expert's rows fit one tile, its
# weights stream once on either body, and the old body's split of K across
# many CTAs fills the card: decode (T=8) and the self-draft verify (T=40)
# stay on it at 8 to 128 experts.
WG_MIN_EXPERT_ROWS = 24

_BODIES = {"mma": _mma, "wg": _wg, "int8": _int8, "rows": _rows}
# each kernel's launch counter on its wrapper
_COUNTERS = {"K2": "launches", "K9": "ksplit_launches", "K10": "launches",
             "K11": "fused_launches", "K12": "planar_launches", "K13": "launches",
             "K14": "launches"}


def _body(kernel: str, cuda: bool, dtype: torch.dtype, group_size: int, t_pad: int, e: int,
          tile_m: int, n: int, k: int) -> str:
    """The body a grouped call runs, named from its kernel (which stands for
    the weights' format: K2 per row, K9 its K-split twin, K10/K11 w4a8 per
    row, K12 planar per group, K13 planar_groups, K14 its w4a8 twin),
    device, activations' type, group size, T_pad, E, tile_m, N and K alone:
    never the tile map's contents or the routing, so a CUDA graph replays
    the body its capture chose.

    * ``"plain"``: a CPU tensor, the plain version;
    * ``"int8"``: K10 and K11, and K14 at ``gs % 32 == 0``;
    * ``"rows"``: f32 x on the other kernels, K14 at the other multiples of
      16, K13 at those off 64 (as K7);
    * ``"wg"``: K2 and K13 from :data:`WG_MIN_EXPERT_ROWS` rows an expert
      beyond the padding (``t_pad - e * tile_m >= e * WG_MIN_EXPERT_ROWS``)
      where the warpgroup body takes the format and shape;
    * ``"mma"``: else (bf16 K2, K9 at its own launch, K12, and K13 at
      ``gs % 64 == 0``), on the decode or tall tile that
      ``_mma._tile_rows`` gives tile_m."""
    if not cuda:
        return "plain"
    if kernel in ("K10", "K11") or kernel == "K14" and group_size % 32 == 0:
        return "int8"
    if dtype != torch.bfloat16 or kernel == "K14" or kernel == "K13" and group_size % _mma._FOLD_GS:
        return "rows"
    if (kernel in ("K2", "K13") and t_pad - e * tile_m >= e * WG_MIN_EXPERT_ROWS
            and _wg._wg_takes(dtype, group_size, n, k)):
        return "wg"
    return "mma"


def _check(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int, *,
           per_group: bool = False, a8: bool = False) -> None:
    """A wrapper's format checks, made before the CPU/CUDA split: per_row
    planar weights or (``per_group``) ``_front._check_per_group``'s, and for
    int8 (``a8``) a tile_m in multiples of 32; then :func:`_check_tiles`."""
    if a8 and tile_m % 32 != 0:
        raise ValueError(f"tile_m={tile_m} must be a multiple of 32 for int8")
    if per_group:
        _front._check_per_group(qt, a8=a8)
    else:
        _front._check_per_row(qt)
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)


def _check_tiles(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int):
    if len(qt.shape) != 3:
        raise ValueError(f"expected stacked [E, N, K] weights, got {qt.shape}")
    t_pad, k = x_sorted.shape
    if k != qt.shape[2]:
        raise ValueError(f"x K={k} != weight K={qt.shape[2]}")
    if t_pad % tile_m != 0 or tile_group_ids.shape != (t_pad // tile_m,):
        raise ValueError(
            f"T_pad={t_pad} must be tile_group_ids.numel()={tile_group_ids.numel()} "
            f"tiles of tile_m={tile_m}"
        )


def _run(wrapper, kernel: str, x_sorted: torch.Tensor, tile_group_ids: torch.Tensor,
         qt: QuantizedTensor, tile_m: int, plain) -> torch.Tensor:
    """A call of ``kernel`` from ``wrapper``, its weights' format checked:
    the body :func:`_body` names, the front end, then the body's launch,
    counted on the wrapper; or the plain version ``plain``."""
    e, n, k = qt.shape
    body = _body(kernel, x_sorted.is_cuda, x_sorted.dtype, qt.group_size, x_sorted.shape[0], e,
                 tile_m, n, k)
    xs, y = _front._prepare(kernel, x_sorted, qt, body,
                          functools.partial(plain, tile_group_ids=tile_group_ids, qt=qt,
                                            tile_m=tile_m),
                          gids=tile_group_ids, tile_m=tile_m)
    if y is None:
        y = _BODIES[body]._launch(xs, qt, kernel, gids=tile_group_ids, tile_m=tile_m)
        setattr(wrapper, _COUNTERS[kernel], getattr(wrapper, _COUNTERS[kernel]) + 1)
        if body == "wg":
            wrapper.wg_launches += 1
    return y


def _grouped_golden(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int,
                    weight=dequantize) -> torch.Tensor:
    """Per expert, dequantize (``weight`` of the expert's QuantizedTensor,
    f32 [N, K]) and run a float32 matmul over that expert's tiles; x.dtype
    out."""
    e, n, k = qt.shape
    xt = x_sorted.reshape(-1, tile_m, k).float()
    out = torch.zeros((xt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        w = weight(dataclasses.replace(
            qt, packed=qt.packed[ex], scales=qt.scales[ex],
            zero_points=qt.zero_points[ex], shape=(n, k),
        ))
        with full_precision():
            out[tiles] = torch.matmul(xt[tiles], w.t())
    return out.reshape(-1, n).to(x_sorted.dtype)


def _grouped_a8_golden(x_sorted, tile_group_ids, qt: QuantizedTensor, tile_m: int,
                       fused: bool, product) -> torch.Tensor:
    """Quantize the rows (the fused quantizer, or the host one; see
    :func:`~.int8_xla._quantize_acts`), then per expert ``product(xq, sx,
    packed, scales, zero_points)`` (f32) over that expert's tiles; x.dtype
    out."""
    e, n, k = qt.shape
    xq, sx = _quantize_acts(x_sorted, fused=fused)
    xqt, sxt = xq.reshape(-1, tile_m, k), sx.reshape(-1, tile_m, 1)
    out = torch.zeros((xqt.shape[0], tile_m, n), dtype=torch.float32, device=x_sorted.device)
    for ex in range(e):
        tiles = (tile_group_ids == ex).nonzero().flatten()
        if tiles.numel() == 0:
            continue
        y = product(xqt[tiles].reshape(-1, k), sxt[tiles].reshape(-1, 1),
                    qt.packed[ex], qt.scales[ex], qt.zero_points[ex])
        out[tiles] = y.reshape(-1, tile_m, n)
    return out.reshape(-1, n).to(x_sorted.dtype)


def grouped_int4_matmul_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K2: per expert, dequantize and run a float32 matmul
    over that expert's tiles; x.dtype out. Any format: it is also the golden
    path of the formats no grouped kernel takes (per_tensor, the interleaved
    and block_planar layouts; ``MoEINT4``, as in JAX)."""
    grouped_int4_matmul_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m)


grouped_int4_matmul_reference.calls = 0


def grouped_int4_matmul(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
    mode: Optional[str] = None,
) -> torch.Tensor:
    """Grouped ``x @ dequant(W[g])^T`` over tile-aligned token groups.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_row planar [E, N, K]. Returns [T_pad, N] in x.dtype.
    K2 runs bf16 x on the tensor-core body, or from
    :data:`WG_MIN_EXPERT_ROWS` rows an expert on the warpgroup body
    (:func:`_body`), f32 x on the CUDA-core loop.

    ``mode``, as in JAX: ``"ksplit"`` launches K9, the same function as K2
    with its f32 sums in another order: bf16 x on the tensor-core body at
    ``_mma._ksplit_mma_launch``'s shape (K split across CTAs, their f32
    partials added in a fixed order by the second pass), f32 x on the
    CUDA-core loop split over K (``_rows._ksplit_splits``).
    ``None``, ``"n_inner"``, ``"m_inner"`` and ``"x_resident"`` launch K2: on the TPU
    they are VMEM schedules of one computation picked by a TPU traffic
    model, which is TPU tuning and not ported. Any other mode raises
    ValueError. On a CPU tensor every mode runs K2's plain version (K9
    computes the same function).
    """
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} is not one of {MODES}")
    _check(x_sorted, tile_group_ids, qt, tile_m)
    return _run(grouped_int4_matmul, "K9" if mode == "ksplit" else "K2", x_sorted,
                tile_group_ids, qt, tile_m, grouped_int4_matmul_reference)


grouped_int4_matmul.launches = 0         # K2, either body
grouped_int4_matmul.wg_launches = 0      # of which on the warpgroup body
grouped_int4_matmul.ksplit_launches = 0  # K9


def grouped_int4_matmul_a8_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 32, fuse_quant: bool = False,
) -> torch.Tensor:
    """Plain version of K10 and K11: quantize (with K11's quantizer when
    ``fuse_quant``, see :func:`~.int8_xla._quantize_acts`), then per expert
    the exact dot and JAX's epilogue over that expert's tiles; x.dtype out."""
    grouped_int4_matmul_a8_reference.calls += 1
    _check(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    return _grouped_a8_golden(x_sorted, tile_group_ids, qt, tile_m, fuse_quant,
                              _int8._a8_product)


grouped_int4_matmul_a8_reference.calls = 0


def grouped_int4_matmul_a8(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 32,
    fuse_quant: Optional[bool] = None,
) -> torch.Tensor:
    """w4a8 grouped ``x @ dequant(W[g])^T`` over tile-aligned token groups.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_row planar [E, N, K]; tile_m a multiple of 32. Returns
    [T_pad, N] in x.dtype. ``fuse_quant``: quantize as the TPU kernel that
    quantizes inside itself does (K11: XLA's folded multiply by f32(1/127))
    rather than as the host quantizer (K10: a division by 127); on the card
    both run the int8 body's first pass in that arithmetic, then its main
    kernel. None means False, as in JAX. On a CPU tensor the plain version
    runs with the quantizer of the kernel it picks.
    """
    fuse_quant = bool(fuse_quant)
    _check(x_sorted, tile_group_ids, qt, tile_m, a8=True)
    return _run(grouped_int4_matmul_a8, "K11" if fuse_quant else "K10", x_sorted, tile_group_ids,
                qt, tile_m, functools.partial(grouped_int4_matmul_a8_reference,
                                              fuse_quant=fuse_quant))


grouped_int4_matmul_a8.launches = 0        # K10
grouped_int4_matmul_a8.fused_launches = 0  # K11


# --- per-group experts: K12 (planar), K13 (w4a16) and K14 (w4a8) on planar_groups ---


def grouped_int4_matmul_per_group_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K13: per expert, dequantize and run a float32 matmul
    over that expert's tiles; x.dtype out. Any per_group stack: it is also
    the golden path of the per-group group sizes no kernel serves
    (``MoEINT4``, as in JAX)."""
    grouped_int4_matmul_per_group_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m)


grouped_int4_matmul_per_group_reference.calls = 0


def grouped_int4_matmul_per_group_planar_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64,
) -> torch.Tensor:
    """Plain version of K12: per expert, the weight dequantized to the
    compute type as the TPU kernel does (``int4_matmul.planar_pg_weight``),
    then a float32 matmul over that expert's tiles; x.dtype out."""
    grouped_int4_matmul_per_group_planar_reference.calls += 1
    _check_tiles(x_sorted, tile_group_ids, qt, tile_m)
    cd = _front._compute_dtype(x_sorted)
    return _grouped_golden(x_sorted, tile_group_ids, qt, tile_m, weight=lambda q: planar_pg_weight(
        q.packed, q.scales, q.zero_points, q.group_size, cd))


grouped_int4_matmul_per_group_planar_reference.calls = 0


def grouped_int4_matmul_per_group(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
) -> torch.Tensor:
    """Grouped ``x @ dequant(W[g])^T`` over per-group experts.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_group [E, N, K], planar_groups with gs a multiple of 16
    dividing K/2 (K13) or planar with gs a multiple of 128 dividing K/2 (K12;
    see ``_front._check_per_group``). Returns [T_pad, N] in x.dtype.
    K13 runs on the tensor-core body where K7 does (bf16 x, ``gs % 64 ==
    0``; from :data:`WG_MIN_EXPERT_ROWS` rows an expert the warpgroup body),
    else on the CUDA-core loop; K12 on the tensor-core body for bf16 x, on
    the CUDA-core loop for f32 x (:func:`_body`).
    """
    _check(x_sorted, tile_group_ids, qt, tile_m, per_group=True)
    if qt.layout == "planar":
        return _run(grouped_int4_matmul_per_group, "K12", x_sorted, tile_group_ids, qt, tile_m,
                    grouped_int4_matmul_per_group_planar_reference)
    return _run(grouped_int4_matmul_per_group, "K13", x_sorted, tile_group_ids, qt, tile_m,
                grouped_int4_matmul_per_group_reference)


grouped_int4_matmul_per_group.launches = 0         # K13, any body
grouped_int4_matmul_per_group.wg_launches = 0      # of which on the warpgroup body
grouped_int4_matmul_per_group.planar_launches = 0  # K12


def grouped_int4_matmul_per_group_a8_reference(
    x_sorted: torch.Tensor, tile_group_ids: torch.Tensor, qt: QuantizedTensor,
    *, tile_m: int = 64, launch: Optional[tuple] = None,
) -> torch.Tensor:
    """Plain version of K14: the TPU wrapper's quantizer, then per expert,
    over that expert's tiles, the order of the body K14 runs on the card
    (:func:`_body`): on the int8 body its fold at the launch shape
    ``launch``, by default its rule's (``_int8._fold_plain``); on the
    CUDA-core loop its per-run fold (``_rows._pg_a8_product``); x.dtype
    out."""
    grouped_int4_matmul_per_group_a8_reference.calls += 1
    _check(x_sorted, tile_group_ids, qt, tile_m, per_group=True, a8=True)
    e, n, k = qt.shape
    gs = qt.group_size
    on_int8 = _body("K14", True, x_sorted.dtype, gs, x_sorted.shape[0], e, tile_m, n, k) == "int8"
    product = (_int8._fold_plain(x_sorted, "K14", n, k, gs, launch) if on_int8
               else _rows._pg_a8_product)
    return _grouped_a8_golden(x_sorted, tile_group_ids, qt, tile_m, True, product)


grouped_int4_matmul_per_group_a8_reference.calls = 0


def grouped_int4_matmul_per_group_a8(
    x_sorted: torch.Tensor,
    tile_group_ids: torch.Tensor,
    qt: QuantizedTensor,
    *,
    tile_m: int = 64,
) -> torch.Tensor:
    """w4a8 grouped ``x @ dequant(W[g])^T`` over per-group experts.

    x_sorted: [T_pad, K] bf16 or f32; tile_group_ids: [T_pad // tile_m] i32;
    qt: stacked per_group planar_groups [E, N, K] with ``127*128*gs < 2**24``;
    tile_m a multiple of 32. Returns [T_pad, N] in x.dtype. The activations
    are quantized before the main kernel with the TPU wrapper's quantizer
    (``_quantize_acts(x, fused=True)``, see ``int4_matmul_per_group_a8``):
    at ``gs % 32 == 0`` by the int8 body's first pass, which then runs the
    per-group fold of ``_int8._pg_a8_fold_product``; at other group sizes by
    the host quantizer, then the CUDA-core loop of ``_rows._pg_a8_product``
    (:func:`_body` says which, as ``int4_matmul._body`` does for K8).
    """
    _check(x_sorted, tile_group_ids, qt, tile_m, per_group=True, a8=True)
    return _run(grouped_int4_matmul_per_group_a8, "K14", x_sorted, tile_group_ids, qt, tile_m,
                grouped_int4_matmul_per_group_a8_reference)


grouped_int4_matmul_per_group_a8.launches = 0  # K14
