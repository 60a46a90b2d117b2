"""Sharding rules for quantized tensors (tensor and expert parallelism).

Counterpart of ``fused4bit_tpu/parallel/sharding.py``. JAX places a global
array with a ``NamedSharding``; here each rank holds its own slice, and a
rule names which tensor dim is split over which mesh axis: :class:`Shard`
(``None``: replicated). Scales and zero points split with the dim they
describe: per-row metadata and per-group ``[N, G]`` with the N dim, per
expert metadata with the E dim. Slices are contiguous and live on the rank's
device (:func:`~.mesh.local_device`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..quant.core import QuantizedTensor
from .mesh import all_gather_dim, axis_index, axis_size, local_device

__all__ = [
    "Shard",
    "shard_tensor",
    "unshard_tensor",
    "shard_qt_out_dim",
    "shard_qt_experts",
    "replicate",
    "qt_pspec_out_dim",
    "qt_pspec_experts",
]


class Shard(NamedTuple):
    """Tensor dim ``dim`` is split over mesh axis ``axis`` in equal,
    contiguous chunks, chunk i on the rank at coordinate i."""

    axis: str
    dim: int


def qt_pspec_out_dim(axis: str = "model") -> dict:
    """The rule for a [N, K] QuantizedTensor column-parallel over N: packed
    [..., N, K/2] (planar_groups [Gh, N, gs]) on its N dim, scales/zps [N]
    (per_group [N, G]) on dim 0."""
    return dict(packed=Shard(axis, -2), scales=Shard(axis, 0), zero_points=Shard(axis, 0))


def qt_pspec_experts(axis: str = "expert") -> dict:
    """The rule for stacked [E, N, K] expert weights split over E."""
    return dict(packed=Shard(axis, 0), scales=Shard(axis, 0), zero_points=Shard(axis, 0))


def shard_tensor(t: torch.Tensor, mesh: DeviceMesh, spec: Optional[Shard]) -> torch.Tensor:
    """This rank's slice of ``t`` under ``spec``, on the rank's device.
    Raises ``ValueError`` when the axis size does not divide the dim."""
    device = local_device(mesh)
    if spec is None:
        return t.to(device)
    n = axis_size(mesh, spec.axis)
    size = t.shape[spec.dim]
    if size % n:
        raise ValueError(f"dim {spec.dim} of size {size} not divisible by mesh axis "
                         f"{spec.axis!r} of size {n}")
    chunk = size // n
    return t.narrow(spec.dim, axis_index(mesh, spec.axis) * chunk, chunk).contiguous().to(device)


def unshard_tensor(t: torch.Tensor, mesh: DeviceMesh, spec: Optional[Shard]) -> torch.Tensor:
    """The whole tensor from every rank's slice (a collective over
    ``spec.axis``; ``spec`` None: ``t`` itself)."""
    if spec is None:
        return t
    return all_gather_dim(t, mesh, spec.axis, spec.dim % t.dim())


def _place(qt: QuantizedTensor, mesh: DeviceMesh, specs: dict, shape) -> QuantizedTensor:
    def put(a, spec):
        # a per_tensor scalar describes no split dim: every rank keeps it
        return shard_tensor(a, mesh, spec if a.dim() else None)

    return dataclasses.replace(qt, packed=put(qt.packed, specs["packed"]),
                               scales=put(qt.scales, specs["scales"]),
                               zero_points=put(qt.zero_points, specs["zero_points"]),
                               shape=shape)


def shard_qt_out_dim(qt: QuantizedTensor, mesh: DeviceMesh, axis: str = "model") -> QuantizedTensor:
    """Column-parallel placement: this rank's rows of the output dim, a
    QuantizedTensor of shape [N / D, K]."""
    n = axis_size(mesh, axis)
    if qt.out_dim % n:
        raise ValueError(f"N={qt.out_dim} not divisible by mesh axis {axis!r} of size {n}")
    return _place(qt, mesh, qt_pspec_out_dim(axis),
                  tuple(qt.shape[:-2]) + (qt.out_dim // n, qt.in_dim))


def shard_qt_experts(qt: QuantizedTensor, mesh: DeviceMesh, axis: str = "expert") -> QuantizedTensor:
    """Expert-parallel placement of stacked [E, N, K] weights: this rank's
    E / D experts, a QuantizedTensor of shape [E / D, N, K]."""
    n = axis_size(mesh, axis)
    if qt.shape[0] % n:
        raise ValueError(f"num_experts={qt.shape[0]} not divisible by mesh axis {axis!r} "
                         f"of size {n}")
    return _place(qt, mesh, qt_pspec_experts(axis), (qt.shape[0] // n,) + tuple(qt.shape[1:]))


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """``tree`` (a tensor, module, dataclass, or dicts, lists and tuples of
    them) whole on the rank's device."""
    device = local_device(mesh)
    if isinstance(tree, (torch.Tensor, nn.Module)):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: replicate(getattr(tree, f.name), mesh)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree
