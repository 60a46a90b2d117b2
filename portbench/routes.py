"""The experts the program chose, read where it chose them.

A forward hook on each layer's router hands the router's output (the
logits the program routed by, as it computed them) to a sink; the decode
driver's sink keeps a reference to it and copies nothing, so a CUDA graph
captured with the hooks on holds no added kernel and refreshes those
buffers at each replay. The port's own ``topk_route`` turns them into
expert indices after the window. ``Tap`` is what the drivers attach;
``choices`` gives the expert indices [rows, k] of one kept output.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from fused4bit_tpu_torch.layers.moe import topk_route


def choices(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """The program's top-k experts for router logits [rows, E]."""
    return topk_route(logits, top_k, logits.shape[-1]).expert_indices


class Tap:
    """Forward hooks on every router of ``model``: each call hands
    ``sink(layer, logits)`` the router's output."""

    def __init__(self, model, sink: Callable[[int, torch.Tensor], None]):
        self.model, self.sink = model, sink
        self.handles: List = []

    def attach(self) -> "Tap":
        def hook(layer):
            return lambda mod, args, out: self.sink(layer, out)
        self.handles = [blk.moe.router.register_forward_hook(hook(i))
                        for i, blk in enumerate(self.model.blocks)]
        return self

    def detach(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []
