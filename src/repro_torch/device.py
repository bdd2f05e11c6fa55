"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the card. There is no
silent fallback: without CUDA, ``None`` raises, and the CPU runs only when
the caller asks for it (``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_device", "follows_card"]


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


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; a host tensor goes to the card through pinned
    memory, asynchronously on the current stream, so the host does not
    wait for the card's queue to drain."""
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def follows_card(t: torch.Tensor) -> bool:
    """Whether work on ``t`` takes the card's spelling where the port
    spells an operation per device (the optimizer's square root, the f32
    sums of bf16 products): on a CUDA tensor, and on a ``meta`` one, the
    dry run's stand-in for the card (:mod:`repro_torch.launch.dryrun`)."""
    return t.device.type in ("cuda", "meta")
