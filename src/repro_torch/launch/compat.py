"""The local devices a point-split sweep runs over.

The reference's ``device_mesh(axis_name, devices)`` is a 1-D
``jax.sharding.Mesh`` over the local devices, and its ``shard_map`` shim
runs a body on each. The port's counterpart is the plain list of local
cards: the sweep launches each card's rows from one host thread
(:mod:`repro_torch.sim.sweep`). ``shard_map`` has no counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["device_mesh"]


def device_mesh(axis_name: str, devices: Optional[Sequence] = None
                ) -> tuple:
    """The devices of a 1-D mesh over ``axis_name``: ``devices`` as
    ``torch.device`` s, by default every local card."""
    del axis_name  # a 1-D mesh: the name labels nothing here
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass the devices (e.g. ('cpu', 'cpu'))")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return tuple(torch.device(d) for d in devices)
