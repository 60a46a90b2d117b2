"""Checkpoint save/restore for the port's modules and tensor trees.

Counterpart of ``fused4bit_tpu/utils/checkpoint.py`` (Orbax over a pytree).
A tree is an ``nn.Module`` (its ``state_dict``), a tensor, or dicts, lists,
tuples and dataclasses of those (``QuantizedTensor``, ``QuantizedKVCache``,
``PagedKVCache``, ``FP4Tensor``, ...), with Python scalars, strings and None
allowed as leaves. A checkpoint is a directory holding one ``torch.save``
file: the tensors by path, the scalars by path, and the tree's static
description (container types and keys, each dataclass's non-tensor fields,
each module's class and plain attributes: shapes, granularity, layout,
execution mode), which a load compares with the template's.

:func:`save` writes a temporary directory beside ``path``, flushes it to
disk, then renames it to ``path`` (``os.replace``): a crash in the middle of
a save never leaves a ``path`` that looks complete (``utils.elastic`` relies
on it, as the JAX loop relies on Orbax's rename).

:func:`load` reads with ``torch.load(..., weights_only=True)`` and checks
the whole checkpoint against the template before it touches anything: the
same static description, the same tensor paths, shapes and dtypes; any
difference raises ``ValueError`` and nothing is loaded. Each tensor goes to
the device of its counterpart in the template. An ``nn.Module`` in the
template is loaded IN PLACE (``load_state_dict``, strict) and returned, the
torch idiom; every other tensor comes back as a new tensor, and the
template's own tensors stay as they were.

Sharded state (``parallel``): ``shardings`` names, per tensor, the mesh
axis and dim it is split on (``parallel.sharding.Shard``; None: whole), in
a tree that follows the state's: a ``Shard`` for a whole subtree, a dict by
``state_dict`` name for a module (``parallel.model_pspecs``), dicts, lists
and tuples of the state's shape, a dict by field name for a dataclass. A
checkpoint always holds whole tensors: :func:`save` all-gathers each split
tensor over its axis (every rank calls it; rank 0 writes), and :func:`load`
gives each rank its slice, so a state saved under one mesh restores under
another, another `data` size included (JAX's Orbax restore with
``shardings``).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Dict, Tuple

import torch
from torch import nn

__all__ = ["save", "load"]

_FILE = "tree.pt"
_FORMAT = 1
_SCALARS = (bool, int, float, str, type(None))
# Module attributes that record how the weights were made, not how to read
# them: carried from the checkpoint onto the template instead of compared.
_CARRIED = ("awq_alphas",)


def _plain(v) -> bool:
    """A value the static description can hold (and weights_only can load)."""
    if isinstance(v, _SCALARS):
        return True
    if isinstance(v, (tuple, list)):
        return all(_plain(x) for x in v)
    return False


def _module_attrs(module: nn.Module) -> Tuple:
    """A module's public plain attributes (shape, granularity, layout,
    execution mode, ...), sorted by name."""
    return tuple(sorted((k, v) for k, v in vars(module).items()
                        if not k.startswith("_") and k != "training"
                        and k not in _CARRIED and _plain(v)))


def _flatten(tree: Any, path: str, tensors: Dict[str, torch.Tensor], scalars: Dict[str, Any],
             static: Dict[str, Any]) -> None:
    """Walk ``tree``: tensors and scalars by path, the structure in ``static``."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree
        static[path] = ("tensor",)
    elif isinstance(tree, nn.Module):
        static[path] = ("module",)
        for name, sub in tree.named_modules():
            # a module holding a share of another (parallel.EPMoEBlock) names it
            kind = getattr(type(sub), "checkpoint_class", type(sub).__name__)
            static[f"{path}:{name}"] = (kind, _module_attrs(sub))
        for k, t in tree.state_dict().items():
            tensors[f"{path}:{k}"] = t
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor) or not _plain(v):
                _flatten(v, f"{path}.{f.name}", tensors, scalars, static)
                fields.append((f.name, None))
            else:
                fields.append((f.name, v))   # a static field: shape, granularity, ...
        static[path] = ("dataclass", type(tree).__name__, tuple(fields))
    elif isinstance(tree, dict):
        keys = list(tree)
        if not all(isinstance(k, (str, int)) for k in keys):
            raise TypeError(f"{path or 'tree'}: dict keys must be str or int, got {keys}")
        static[path] = ("dict", tuple(keys))
        for k in keys:
            _flatten(tree[k], f"{path}[{k!r}]", tensors, scalars, static)
    elif isinstance(tree, (list, tuple)):
        static[path] = (type(tree).__name__, len(tree))
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", tensors, scalars, static)
    elif isinstance(tree, _SCALARS):
        scalars[path] = tree
        static[path] = ("scalar", type(tree).__name__)
    else:
        raise TypeError(f"{path or 'tree'}: cannot checkpoint a {type(tree).__name__}")


def _carried(tree: Any, path: str, out: Dict[str, Any]) -> None:
    """The :data:`_CARRIED` attributes of every module in ``tree``."""
    if isinstance(tree, nn.Module):
        for name, sub in tree.named_modules():
            for attr in _CARRIED:
                if hasattr(sub, attr):
                    out[f"{path}:{name}:{attr}"] = getattr(sub, attr)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _carried(v, f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _carried(v, f"{path}[{i}]", out)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _specs(tree: Any, spec: Any, path: str, out: Dict[str, Any]) -> None:
    """The ``Shard`` of each tensor path of ``tree`` under ``shardings``."""
    from ..parallel.sharding import Shard

    if spec is None:
        return
    if isinstance(spec, Shard):
        tensors: Dict[str, torch.Tensor] = {}
        _flatten(tree, path, tensors, {}, {})
        out.update(dict.fromkeys(tensors, spec))
    elif isinstance(tree, nn.Module):
        out.update({f"{path}:{k}": s for k, s in spec.items()})
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _specs(getattr(tree, f.name), spec.get(f.name), f"{path}.{f.name}", out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _specs(v, spec.get(k), f"{path}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"{path or 'tree'}: {len(spec)} shardings for {len(tree)} items")
        for i, (v, s) in enumerate(zip(tree, spec)):
            _specs(v, s, f"{path}[{i}]", out)
    else:
        raise TypeError(f"{path or 'tree'}: a {type(tree).__name__} takes no sharding {spec!r}")


def _sharded(tree: Any, shardings: Any, mesh) -> Dict[str, Any]:
    specs: Dict[str, Any] = {}
    if shardings is not None:
        if mesh is None:
            raise ValueError("shardings need the mesh they name axes of")
        _specs(tree, shardings, "", specs)
    return specs


def _write(path: str, tensors, scalars, static, carried) -> None:
    if os.path.exists(path):
        raise FileExistsError(f"checkpoint destination {path} already exists")
    payload = dict(format=_FORMAT, static=static, scalars=scalars, carried=carried,
                   # a copy of just the tensor's elements, never a view's whole storage
                   tensors={k: t.detach().to("cpu", copy=True) for k, t in tensors.items()})
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.tmp-", dir=parent)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)


def _written(ok: bool, mesh) -> bool:
    """Rank 0's ``ok``, on every rank, once rank 0 has written (or failed)."""
    from ..parallel.mesh import local_device

    flag = torch.tensor([int(ok)], dtype=torch.int32, device=local_device(mesh))
    torch.distributed.broadcast(flag, src=0)
    return bool(flag.item())


def save(path: str, tree: Any, shardings: Any = None, mesh=None) -> None:
    """Write ``tree`` to the directory ``path``, which must not exist yet.

    With ``shardings`` (over ``mesh``), ``tree`` is this rank's share: every
    rank calls :func:`save` (a None leaf of ``shardings``: the same on
    every rank), the split tensors are gathered whole, rank 0 alone checks
    ``path`` and writes, and every rank returns once the checkpoint is in
    place, or raises if rank 0 could not write it."""
    from ..parallel.sharding import unshard_tensor

    path = os.path.abspath(os.path.expanduser(path))
    specs = _sharded(tree, shardings, mesh)
    tensors, scalars, static, carried = {}, {}, {}, {}
    _flatten(tree, "", tensors, scalars, static)
    _carried(tree, "", carried)
    if shardings is None:
        _write(path, tensors, scalars, static, carried)
        return
    tensors = {k: unshard_tensor(t, mesh, specs.get(k)) for k, t in tensors.items()}
    if torch.distributed.get_rank() != 0:
        if not _written(True, mesh):
            raise RuntimeError(f"rank 0 could not write the checkpoint {path}")
        return
    ok = False
    try:
        _write(path, tensors, scalars, static, carried)
        ok = True
    finally:
        _written(ok, mesh)


def _check(path: str, payload: dict, tensors, scalars, static) -> None:
    """Raise unless the checkpoint fits the template in every respect."""
    if payload.get("format") != _FORMAT:
        raise ValueError(f"{path}: checkpoint format {payload.get('format')} is not {_FORMAT}")
    saved = payload["static"]
    differ = sorted(k for k in set(saved) | set(static) if saved.get(k) != static.get(k))
    if differ:
        k = differ[0]
        raise ValueError(f"{path}: the checkpoint's structure differs from the template's at "
                         f"{len(differ)} places, first at {k or 'the root'!r}: checkpoint "
                         f"{saved.get(k)} against template {static.get(k)}")
    got = payload["tensors"]
    if got.keys() != tensors.keys():
        raise ValueError(f"{path}: tensors only in the checkpoint "
                         f"{sorted(set(got) - set(tensors))[:8]}, only in the template "
                         f"{sorted(set(tensors) - set(got))[:8]}")
    for k, t in tensors.items():
        if got[k].shape != t.shape or got[k].dtype != t.dtype:
            raise ValueError(f"{path}: {k!r} is {tuple(got[k].shape)} {got[k].dtype} in the "
                             f"checkpoint, {tuple(t.shape)} {t.dtype} in the template")
    for k, v in scalars.items():
        if type(payload["scalars"][k]) is not type(v):
            raise ValueError(f"{path}: scalar {k!r} is a {type(payload['scalars'][k]).__name__}, "
                             f"a {type(v).__name__} in the template")


def _build(tree: Any, path: str, payload: dict) -> Any:
    """The template's structure holding the checkpoint's values."""
    got = payload["tensors"]
    if isinstance(tree, torch.Tensor):
        return got[path].to(tree.device)
    if isinstance(tree, nn.Module):
        prefix = f"{path}:"
        tree.load_state_dict({k[len(prefix):]: v for k, v in got.items()
                              if k.startswith(prefix)}, strict=True)
        for key, v in payload["carried"].items():
            if key.startswith(prefix):
                name, attr = key[len(prefix):].rsplit(":", 1)
                setattr(tree.get_submodule(name), attr, v)
        return tree
    if dataclasses.is_dataclass(tree):
        new = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor) or not _plain(v):
                new[f.name] = _build(v, f"{path}.{f.name}", payload)
        return dataclasses.replace(tree, **new)
    if isinstance(tree, dict):
        return {k: _build(v, f"{path}[{k!r}]", payload) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_build(v, f"{path}[{i}]", payload) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return payload["scalars"][path]


def load(path: str, template: Any, shardings: Any = None, mesh=None) -> Any:
    """Restore a checkpoint written by :func:`save` into ``template``'s
    structure (a tree of the same kind, built with the same configuration;
    its tensor values are ignored). Raises ``ValueError`` and loads nothing
    when the checkpoint does not fit the template.

    With ``shardings`` (over ``mesh``), ``template`` is this rank's share
    (``parallel.place_model`` of a model, the rank's caches): each split
    tensor of the checkpoint is cut to the rank's slice before it is held to
    the template's."""
    from ..parallel.sharding import shard_tensor

    path = os.path.abspath(os.path.expanduser(path))
    payload = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    tensors, scalars, static = {}, {}, {}
    _flatten(template, "", tensors, scalars, static)
    for k, spec in _sharded(template, shardings, mesh).items():
        if spec is not None and k in payload["tensors"]:
            payload["tensors"][k] = shard_tensor(payload["tensors"][k], mesh, spec)
    _check(path, payload, tensors, scalars, static)
    return _build(template, "", payload)
