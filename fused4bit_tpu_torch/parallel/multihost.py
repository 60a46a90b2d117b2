"""Process-group initialization and helpers.

Counterpart of ``fused4bit_tpu/parallel/multihost.py``. JAX joins hosts with
``jax.distributed.initialize``; here every rank is one process with one
device, joined by ``torch.distributed.init_process_group``. Call
:func:`initialize` once per process before building a mesh
(:func:`~.mesh.make_mesh`): it reads the variables the JAX package reads
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) and those ``torchrun``
sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).

A process with nothing configured stays single-process: :func:`initialize`
returns False and starts nothing.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "local_device_slice"]

# How long a collective may wait for its peers before it fails (a peer that
# died must not hang the others).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _first(*values):
    return next((v for v in values if v is not None), None)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Initialize ``torch.distributed`` (idempotent, environment aware).

    ``coordinator_address`` ("host:port") defaults to COORDINATOR_ADDRESS,
    then MASTER_ADDR:MASTER_PORT; ``num_processes`` to NUM_PROCESSES, then
    WORLD_SIZE; ``process_id`` to PROCESS_ID, then RANK. ``device_type``:
    "cuda" (the default: NCCL, after ``torch.cuda.set_device`` to
    LOCAL_RANK, else the process id modulo the visible cards) or "cpu"
    (gloo). ``timeout`` bounds every collective's wait. Returns True if a
    process group is active, False when nothing is configured.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    master = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
              if "MASTER_ADDR" in env and "MASTER_PORT" in env else None)
    coordinator_address = _first(coordinator_address, env.get("COORDINATOR_ADDRESS"), master)
    num_processes = _first(num_processes, _env_int("NUM_PROCESSES"), _env_int("WORLD_SIZE"))
    process_id = _first(process_id, _env_int("PROCESS_ID"), _env_int("RANK"))
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"incomplete process group: address {coordinator_address}, "
                         f"{num_processes} processes, id {process_id}")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        local_rank = _first(_env_int("LOCAL_RANK"), process_id % torch.cuda.device_count())
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type={device_type!r} is not 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    return True


def is_multihost() -> bool:
    """Whether more than one process is joined."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_slice(mesh_axis_size: int) -> slice:
    """Index range of this process's devices within a flat device list: one
    device per process, this rank's. ``mesh_axis_size`` is unused, kept for
    the JAX package's signature."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return slice(rank, rank + 1)
