"""Device selection for the port's entry points.

Every public constructor or function that makes tensors takes
``device=``; the default is ``"cuda"``, and asking for CUDA where there
is none raises instead of silently running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The ``torch.device`` to place tensors on. ``None`` means the
    default, ``"cuda"``. A CUDA device on a host without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
