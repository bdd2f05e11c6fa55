"""Gradient compression for the all-reduce across pods, and its
error-feedback state.

The pod axis is pure data parallelism: every pod holds the same
parameters, and the gradients are averaged across pods over the slow
links between them. The reference compresses that all-reduce with int8
codes and error feedback; so does :func:`compressed_psum`, op for op:

    gf    = g + err                          (f32; err from the last step)
    scale = max(pmax(max |gf|), 1e-30) / 127 (one scale across the pods)
    q     = clip(round(gf / scale), -127, 127) as int8 (half to even)
    mean  = psum(q as int32) * scale / n     (an exact integer sum)
    err   = gf - q * scale

so equal gradients give the reference's codes, means and error feedback
bit for bit, in XLA's spelling of it (ROADMAP.md fault (o)): the division
by 127 is a product with f32(1 / 127), and ``gf - q * scale`` one fused
multiply-add (one rounding), as XLA compiles the reference's lines. The
codes cross the links as int32 in the all-reduce, as the reference's
``psum`` of int32 sends them. Without a pod axis there is
nothing to compress, and only the error-feedback state exists: f32
zeros like the parameters, carried in every ``TrainState`` and
checkpoint as the reference carries it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.online_learning import fma_f32
from repro_torch.training.tree import tree_map

__all__ = ["init_error_feedback", "quantize", "compressed_psum"]

_F32 = torch.float32
_INV_127 = float(torch.tensor(1 / 127, dtype=_F32))  # f32(1 / 127)


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def quantize(gf: torch.Tensor, amax: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale f32)``: ``gf`` f32 coded against the shared
    maximum ``amax``."""
    scale = torch.clamp(amax, min=1e-30) * _INV_127
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_psum(g: torch.Tensor, err: torch.Tensor, ax, name: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.to(_F32) + err
    q, scale = quantize(gf, ax.pmax(torch.max(torch.abs(gf)), name))
    new_err = fma_f32(-q.to(_F32), scale.expand_as(gf), gf)
    summed = ax.psum(q.to(torch.int32), name).to(_F32)
    return (summed * scale / ax.size(name)).to(g.dtype), new_err


def compressed_psum(grads: list, err: list, ax, name: Optional[str]
                    ) -> tuple[list, list]:
    """The mean of each gradient in ``grads`` over the axis ``name`` of
    ``ax`` (an :class:`~repro_torch.distributed.axes.Axes`), through int8
    codes with error feedback ``err`` (f32, one a gradient). Returns (the
    means, the new error feedback); the identity without the axis."""
    if name is None:
        return grads, err
    out = [_quantize_psum(g, e, ax, name) for g, e in zip(grads, err)]
    return [o[0] for o in out], [o[1] for o in out]
