"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller names another device; the
CPU is reached only on request (the tests pass ``device="cpu"``), never as
a fallback when the card is missing."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raising when no GPU is present); anything
    else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
