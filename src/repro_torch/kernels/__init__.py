"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

A wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors. Inside :func:`plain_versions`, the serving path's wrappers
(flash attention, paged attention, page copy, the SSD and RG-LRU scans)
run their plain versions on CUDA tensors too: the explicit switch with
which a run on the card is held against the plain path. Nothing falls
back from one to the other.
"""
from __future__ import annotations

import contextlib

__all__ = ["plain_versions", "plain_selected"]

_PLAIN = [False]


@contextlib.contextmanager
def plain_versions():
    """Select the plain versions of the serving kernels inside the block."""
    prev = _PLAIN[0]
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = prev


def plain_selected() -> bool:
    return _PLAIN[0]
