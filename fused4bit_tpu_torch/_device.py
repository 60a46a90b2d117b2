"""Where the port's entry points allocate: on the card unless told otherwise."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Raises ``RuntimeError`` when None is given and no CUDA device exists: the
    caller asks for the CPU (and the kernels' plain versions) explicitly with
    ``device="cpu"``, never by falling back.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to build on the CPU, where the "
            "kernels' plain versions run"
        )
    return torch.device("cuda")
