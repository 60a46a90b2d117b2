"""Elastic step loop: checkpoint/resume and failure retry.

Counterpart of ``fused4bit_tpu/utils/elastic.py``, over
:mod:`fused4bit_tpu_torch.utils.checkpoint`:

* every ``save_every`` steps the whole state is written to a step-numbered
  directory ``step_N`` (the newest ``keep`` kept, older ones pruned);
* on (re)start the loop resumes from the newest complete checkpoint, so a
  preempted or crashed process relaunched with the same command line
  continues where the last save left it;
* a step that raises rolls the loop back to the last checkpoint (or to the
  start) and retries, up to ``max_retries`` times before re-raising.
  Deterministic step functions give the same trajectory with or without
  failures.

Unlike JAX arrays, torch tensors are mutable, and the port's KV caches are
updated in place: a step may change the state it is given. The loop
therefore keeps one deep copy of ``init_state`` that it never hands out,
and a rollback to the start hands out a fresh copy of it; a rollback to a
checkpoint loads new tensors. ``init_state`` itself is handed to the first
step.

Multi-process (``torch.distributed`` initialized with a world size above
1): in-process retry is DISABLED (``max_retries`` is forced to 0), because
one process rolling back while its peers go on would pair collectives at
mismatched steps; the recovery is to relaunch every process, and all resume
from the newest complete checkpoint. Rank 0 alone writes and prunes, into
a ``ckpt_dir`` on storage every process reads. A state that is the same on
every process is saved by rank 0 alone; a sharded one (``shardings`` over
``mesh``, as :func:`checkpoint.save` and :func:`checkpoint.load` take them)
is gathered whole by every rank, written by rank 0, and each rank restores
its own slice, under this mesh or another.
"""
from __future__ import annotations

import copy
import os
import re
import shutil
from typing import Any, Callable, Optional, Tuple

from . import checkpoint as ckpt

__all__ = ["elastic_loop", "latest_step", "prune_checkpoints"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _world() -> Tuple[int, int]:
    """(world size, rank) of the ``torch.distributed`` group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest complete checkpoint step under ``ckpt_dir`` (None if none).

    A checkpoint is complete once :func:`checkpoint.save` has renamed its
    temporary directory to ``step_N``: a save cut by a crash is invisible
    here, so a resume always lands on a consistent state.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(name)) and os.path.isdir(os.path.join(ckpt_dir, name))
    ]
    return max(steps) if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                   if (m := _STEP_RE.match(name)))
    doomed = steps[:-keep] if keep > 0 else steps
    for s in doomed:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def elastic_loop(
    step_fn: Callable[[Any, int], Any],
    init_state: Any,
    *,
    ckpt_dir: str,
    num_steps: int,
    save_every: int = 100,
    keep: int = 2,
    max_retries: int = 3,
    shardings: Any = None,
    mesh=None,
    on_step: Optional[Callable[[int, Any], None]] = None,
) -> Tuple[Any, int]:
    """Run ``state = step_fn(state, i)`` for ``i in [0, num_steps)``,
    checkpointing, resuming and retrying around failures.

    Returns ``(final_state, resumed_from)``, ``resumed_from`` being the step
    the loop started at (0 for a fresh run). ``init_state`` is the restore
    template too (``checkpoint.load``); ``shardings`` and ``mesh``: the
    state's split over a mesh, for its saves and restores. ``on_step(i,
    state)`` is called after each step with the count of steps done.
    """
    world, rank = _world()
    if world > 1:
        max_retries = 0   # see the module docstring: recovery is relaunch-and-resume
    os.makedirs(ckpt_dir, exist_ok=True)
    pristine = copy.deepcopy(init_state)   # never handed out: the start to roll back to

    def restore(step: int) -> Any:
        # a copy as the template: a module in it is loaded in place
        return ckpt.load(os.path.join(ckpt_dir, f"step_{step}"), copy.deepcopy(pristine),
                         shardings, mesh)

    start = latest_step(ckpt_dir)
    if start is not None:
        state, resumed_from = restore(start), start
    else:
        state, start, resumed_from = init_state, 0, 0

    retries = 0
    i = start
    while i < num_steps:
        try:
            state = step_fn(state, i)
        except Exception:
            retries += 1
            if retries > max_retries:
                raise
            # roll back to the last durable state and retry from there
            last = latest_step(ckpt_dir)
            if last is None:
                state, i = copy.deepcopy(pristine), 0
            else:
                state, i = restore(last), last
            continue
        i += 1
        if on_step is not None:
            on_step(i, state)
        if i % save_every == 0 or i == num_steps:
            if shardings is not None or rank == 0:
                ckpt.save(os.path.join(ckpt_dir, f"step_{i}"), state, shardings, mesh)
            if rank == 0:
                prune_checkpoints(ckpt_dir, keep)
            retries = 0
    return state, resumed_from
