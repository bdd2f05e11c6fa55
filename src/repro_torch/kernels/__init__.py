"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

A wrapper runs its kernel on CUDA tensors and its plain version on CPU
tensors. Inside :func:`plain_versions`, the serving path's wrappers
(flash attention, paged attention, page copy, the SSD and RG-LRU scans)
run their plain versions on CUDA tensors too: the explicit switch with
which a run on the card is held against the plain path. The dry run
(:mod:`repro_torch.launch.dryrun`) uses the same switch for its ``meta``
tensors, which have no kernel; outside it a ``meta`` tensor raises
(:func:`use_plain`). Nothing falls back from one to the other.

No kernel has a backward, and a wrapper returns tensors with no
``grad_fn``: under autograd every dispatcher refuses inputs that require
grad (:func:`refuse_autograd`), on every device, rather than cut the graph
and let the inputs' gradients read as zeros. Training runs the
reference's training forms instead (``repro_torch.models.transformer``).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["plain_versions", "use_plain", "refuse_autograd"]

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


def use_plain(device: torch.device) -> bool:
    """Whether a serving wrapper runs its plain version for tensors on
    ``device``: always on the CPU; on the card and on ``meta`` (the dry
    run's shapes) only inside :func:`plain_versions`. A wrapper raises for
    any other case that is not a CUDA tensor."""
    return device.type == "cpu" or (device.type in ("cuda", "meta")
                                    and _PLAIN[0])


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad: the
    ``name`` kernel has no backward (ROADMAP.md §2 item 8)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand kernel has no backward (ROADMAP.md §2 item 8); "
            "its inputs require grad, and its output would cut the graph. "
            "Train through the model's training forms, or call it under "
            "torch.no_grad()")
