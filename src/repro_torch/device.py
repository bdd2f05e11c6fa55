"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the card. There is no
silent fallback: without CUDA, ``None`` raises, and the CPU runs only when
the caller asks for it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the card by "
                "default; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
