"""Pipeline parallelism: a `stage` mesh axis and GPipe-style microbatches.

Counterpart of ``fused4bit_tpu/parallel/pipeline.py``. Homogeneous stages
are stacked on a leading axis (:func:`stack_stage_params`) and split over a
mesh ``stage`` axis, so that each rank holds its own stage's parameters
(``sharding.shard_tensor`` with ``Shard("stage", 0)``: leaves [1, ...]).

The schedule is inference GPipe: with S stages and M microbatches, stage s
computes microbatch j at step s + j, its input the previous stage's output
of step s + j - 1, received from it (irecv) while the previous stage sends
it on (isend). JAX runs every stage at every one of the M + S - 1 steps as
one static program and discards the bubbles; here a stage computes only its
M microbatches, in the same order, on the same inputs. The last stage's
outputs are broadcast to every rank, so every rank returns the result.

Constraints, as in JAX: all stages share one activation shape and dtype (a
transformer trunk), and stacking needs the same parameter tree per stage.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_group, axis_index, axis_size

__all__ = ["stack_stage_params", "pipeline_stages"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack S per-stage parameter trees (dicts, lists, tuples of tensors)
    on a new leading `stage` axis: leaves [S, ...]."""
    return _tree_map(lambda *ls: torch.stack(ls), *per_stage_params)


def pipeline_stages(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,               # this rank's stage: leaves [1, ...]
    x: torch.Tensor,           # [M, mb, ...] microbatched input, the same on every rank
    mesh: DeviceMesh,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """``stage_{S-1}(... stage_0(x))``, microbatch by microbatch, pipelined
    over ``mesh[axis]``; every rank returns the [M, mb, ...] result.

    ``stage_fn(stage_params, act) -> act`` is one stage's compute, with
    ``stage_params`` the rank's parameters without the stacked leading dim.
    """
    n_stages, s = axis_size(mesh, axis), axis_index(mesh, axis)
    p_loc = _tree_map(lambda a: a[0], params)
    group = axis_group(mesh, axis, x)
    prev = dist.get_global_rank(group, s - 1) if s > 0 else None
    nxt = dist.get_global_rank(group, s + 1) if s < n_stages - 1 else None
    y = torch.empty_like(x)
    sends = []
    for j in range(x.shape[0]):
        inp = x[j]
        if prev is not None:
            inp = torch.empty_like(x[j])
            dist.irecv(inp, prev, group=group).wait()
        out = stage_fn(p_loc, inp).to(x.dtype).contiguous()
        if nxt is not None:
            sends.append((dist.isend(out, nxt, group=group), out))
        else:
            y[j] = out
    for req, _ in sends:
        req.wait()
    if n_stages > 1:
        dist.broadcast(y, dist.get_global_rank(group, n_stages - 1), group=group)
    return y
