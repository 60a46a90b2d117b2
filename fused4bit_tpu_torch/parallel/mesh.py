"""Device meshes over ``torch.distributed``, and the collectives the parallel
layer runs on them.

Counterpart of ``fused4bit_tpu/parallel/mesh.py``. JAX names a mesh of
devices and compiles collectives into one SPMD program; here every rank is a
process (one device each) and a ``DeviceMesh`` with named dims stands for
``jax.sharding.Mesh``. The process group must exist first
(:func:`~.multihost.initialize`): NCCL for CUDA tensors, gloo for CPU ones.

Sums over ranks (JAX's ``psum``) are an all-gather of the partials followed
by a sum in rank order, in the partials' dtype: the result does not depend on
the backend's reduction order or chunking and is the same bits on every
rank, which the replicated serving scheduler needs (two ranks that argmax
different logits diverge).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "make_mesh", "best_mesh_shape", "axis_size", "axis_index", "axis_group",
    "local_device", "all_gather_ordered", "sum_in_rank_order", "psum", "all_gather_dim",
    "all_to_all", "ring_shift",
]


def best_mesh_shape(n: int, num_axes: int = 2) -> Tuple[int, ...]:
    """Factor n devices into a near-square mesh shape (largest factors last)."""
    if num_axes == 1:
        return (n,)
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    if num_axes == 2:
        return (a, n // a)
    rest = best_mesh_shape(n // a, num_axes - 1)
    return (a, *rest)


def make_mesh(
    axis_names: Sequence[str] = ("data", "expert", "model"),
    shape: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """A named mesh over every rank of the process group.

    Default axes: ('data', 'expert', 'model'): DP batches over `data`,
    experts shard over `expert`, TP shards over `model`. With no `shape`,
    every rank goes to `expert` (the first axis when there is none) and the
    other axes are 1. ``device_type``: "cuda" (the default, NCCL) or "cpu"
    (gloo). Raises ``ValueError`` when the shape's product is not the world
    size, ``RuntimeError`` before :func:`~.multihost.initialize`.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize() first")
    n = dist.get_world_size()
    names = tuple(axis_names)
    if shape is None:
        shape = [1] * len(names)
        shape[names.index("expert") if "expert" in names else 0] = n
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} does not name {len(names)} axes {names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along the named mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along the named mesh axis (JAX's
    ``axis_index``)."""
    return mesh.get_local_rank(axis)


def local_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on: its current CUDA device
    (:func:`~.multihost.initialize` sets it), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: DeviceMesh, axis: str, t: torch.Tensor):
    """The process group along ``axis``, for a collective on ``t``. A CUDA
    tensor needs an NCCL group and a CPU tensor a gloo one: anything else
    raises, with no fallback to another backend or device."""
    group = mesh.get_group(axis)
    backend = str(dist.get_backend(group)).lower()
    want = "nccl" if t.is_cuda else "gloo"
    if want not in backend:
        raise RuntimeError(f"a collective on a {t.device.type} tensor needs a {want} group; "
                           f"mesh axis {axis!r} runs on {backend}")
    return group


def all_gather_ordered(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """``t`` (at least 1-d, the same shape on every rank) from every rank
    along ``axis``, in rank order. The collective runs at one rank too (the
    group's cost shows at world size 1)."""
    n = axis_size(mesh, axis)
    group = axis_group(mesh, axis, t)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    # one buffer, the inputs concatenated along dim 0 (the form gloo takes too)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t.contiguous(), group=group)
    return list(out.chunk(n))


def sum_in_rank_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` left to right, in their dtype: JAX's
    ``psum`` with a fixed order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``, in rank order, the same bits on every
    rank."""
    return sum_in_rank_order(all_gather_ordered(t, mesh, axis))


def all_gather_dim(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis`` concatenated along ``dim`` in rank
    order (JAX's tiled ``all_gather``)."""
    return torch.cat(all_gather_ordered(t, mesh, axis), dim=dim)


def all_to_all(send: torch.Tensor, mesh: DeviceMesh, axis: str,
               recv_sizes: Optional[List[int]] = None,
               send_sizes: Optional[List[int]] = None) -> torch.Tensor:
    """``all_to_all_single`` along ``axis``: chunk j of ``send``'s dim 0 goes
    to the rank at coordinate j, the received chunks come back in rank
    order. Equal chunks, or the given split sizes (Python ints)."""
    group = axis_group(mesh, axis, send)
    rows = send.shape[0] if recv_sizes is None else sum(recv_sizes)
    out = torch.empty((rows,) + tuple(send.shape[1:]), dtype=send.dtype, device=send.device)
    dist.all_to_all_single(out, send.contiguous(), output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=group)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], mesh: DeviceMesh, axis: str) -> List[torch.Tensor]:
    """Send each tensor to the next rank along ``axis`` (coordinate i to
    i + 1, the last to the first) and return the previous rank's: JAX's
    ``ppermute`` over the ring, as one batch of isend/irecv pairs."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    me = axis_index(mesh, axis)
    group = axis_group(mesh, axis, tensors[0])
    nxt, prv = dist.get_global_rank(group, (me + 1) % n), dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out
