"""Error-feedback state of the inter-pod gradient compression.

The reference compresses the gradient all-reduce across pods with int8
and error feedback (``compressed_psum``). On one card there is no pod
axis, so only the error-feedback state exists here: f32 zeros like the
parameters, carried in every ``TrainState`` and checkpoint as the
reference carries it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.training.tree import tree_map

__all__ = ["init_error_feedback"]


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
