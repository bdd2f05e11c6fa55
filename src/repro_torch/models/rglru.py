"""RG-LRU recurrent block (recurrentgemma / Griffin) on one card.

Two branches from the residual stream: GeLU(x W1) gates the branch x W2
-> causal conv1d -> RG-LRU, and an output projection merges them. The
prefill form runs the recurrence with its gates through
:func:`repro_torch.kernels.rglru_scan.rglru_scan` (the hand kernel on the
card, its plain version on the CPU); the training form runs
:func:`rglru_scan`, the reference's associative scan in PyTorch under
autograd (the reference trains through it, not through its Pallas
kernel); the decode form is the single-step update in plain PyTorch, as
the reference computes it outside any Pallas kernel. Numerics as the reference's ``repro/models/rglru.py``, including
its asymmetry: the state a prefill hands to decode is the last output in
the model's dtype, cast back to f32, while decode carries its state in
f32 from step to step.

Under a model axis the recurrence width is this rank's block (the
recurrence is elementwise over it) and the output projection a TP
partial sum, as the reference's; under autograd the block input enters
both split projections through ``Axes.enter`` (its gradient summed over
the axis).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.kernels import rglru_scan as kr
from repro_torch.models.layers import causal_conv1d, dense, tp_out

__all__ = ["rglru_scan", "rglru_step", "recurrent_block",
           "recurrent_block_step"]

_F32 = torch.float32


def rglru_scan(u, w_a, b_a, w_x, b_x, lam) -> torch.Tensor:
    """``h [B, S, W]`` in u's dtype under autograd, as the reference's
    associative ``rglru_scan``: the gates in f32, then a log-depth
    (Hillis-Steele) scan of ``h_t = a_t h_{t-1} + b_t`` over S, each round
    combining every step with the one ``d`` before it (``(a, b)`` then
    ``(a', b')`` is ``(a a', b a' + b')``), in ``ceil(log2 S)`` rounds of
    whole-tensor operations instead of S small ones."""
    a, b = kr.rglru_gates(u, w_a, b_a, w_x, b_x, lam)
    d = 1
    while d < u.shape[1]:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b.to(u.dtype)


def rglru_step(u, h_prev, w_a, b_a, w_x, b_x, lam):
    """One decode step, u ``[B, W]``, h_prev ``[B, W]`` f32: ``(h in u's
    dtype, h f32)``."""
    a, b = kr.rglru_gates(u, w_a, b_a, w_x, b_x, lam)
    h = a * h_prev + b
    return h.to(u.dtype), h


def _handoff(h: torch.Tensor) -> torch.Tensor:
    """The state a prefill hands to decode: the last output ``h[:, -1]``,
    in the model's dtype, as f32."""
    return h[:, -1].to(_F32)


def _out(merged: torch.Tensor, w_out: torch.Tensor, ax: Axes):
    if ax.model is None:
        return dense(merged, w_out)
    return tp_out(merged, w_out, ax)


def recurrent_block(x: torch.Tensor, p: dict, *, capture: bool = False,
                    scan=None, ax: Axes = SINGLE):
    """The Griffin recurrent block over a sequence, x ``[B, S, d]``:
    ``(out, state)``; with ``capture``, ``state`` is the decode
    continuation ``{"h": [B, W] f32, "conv": [B, K-1, W]}``, else None.
    ``scan`` is the recurrence: :func:`rglru_scan` for training, or by
    default the kernel's dispatcher (the prefill's), looked up at the call
    (so that a caller may replace it on its module)."""
    x = ax.enter(x, (ax.model,))
    y1 = F.gelu(dense(x, p["w1"]).to(_F32), approximate="tanh").to(x.dtype)
    u_pre = dense(x, p["w2"])
    u = causal_conv1d(u_pre, p["conv"])
    h = (scan or kr.rglru_scan)(u, p["w_a"], p["b_a"], p["w_x"], p["b_x"],
                                p["lam"])
    merged = (y1.to(_F32) * h.to(_F32)).to(x.dtype)
    out = _out(merged, p["w_out"], ax)
    if not capture:
        return out, None
    K = p["conv"].shape[0]
    return out, {"h": _handoff(h), "conv": u_pre[:, -(K - 1):]}


def recurrent_block_step(x: torch.Tensor, state: dict, p: dict,
                         ax: Axes = SINGLE):
    """One decode step, x ``[B, d]``, from ``state``
    (:func:`recurrent_block`'s layout): ``(out [B, d], new state)``."""
    y1 = F.gelu(dense(x, p["w1"]).to(_F32), approximate="tanh").to(x.dtype)
    u_in = dense(x, p["w2"])
    window = torch.cat([state["conv"], u_in[:, None]], dim=1)  # [B, K, W]
    u = torch.einsum("bkw,kw->bw", window.to(_F32),
                     p["conv"].to(_F32)).to(x.dtype)
    h_out, h_new = rglru_step(u, state["h"], p["w_a"], p["b_a"], p["w_x"],
                              p["b_x"], p["lam"])
    merged = (y1.to(_F32) * h_out.to(_F32)).to(x.dtype)
    return _out(merged, p["w_out"], ax), {"h": h_new, "conv": window[:, 1:]}
