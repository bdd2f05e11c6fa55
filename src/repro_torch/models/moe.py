"""Mixture-of-Experts FFN (mixtral / grok-1: 8 experts, top-2) on one card.

The reference's capacity-buffer dispatch, op by op: each (token, k) slot
takes its position in its expert's queue from a cumsum over the ``[T *
K]`` flattening, token-major; a slot past the capacity ``C`` goes to the
scratch row ``E * C`` and is dropped; the kept tokens are scattered into
an ``[E, C, d]`` buffer, each expert's SwiGLU runs on its ``C`` rows, and
each slot's output is gathered back and weighted by its renormalized
router probability.

Numerics as the reference: the router logits, the gate and up products
and the down product are f32 sums of the model dtype's products
(:func:`~repro_torch.models.layers.matmul_f32`); ``silu(g) * u`` in f32,
cast to x's dtype; the combine in f32. The top-k is a stable descending
sort, so ties go to the lower expert index, as ``jax.lax.top_k``'s do
(``torch.topk`` leaves their order unspecified).

The experts run one at a time: at a 3,072-token prefill of 8 sequences
(T = 24,576, C = 7,680 at mixtral's width) all eight experts' f32 gate
and up products would take 4 GB each; one expert's take 0.5 GB. The
expert products stay ``torch.matmul``: the reference computes them
outside any Pallas kernel.

Under a model axis each expert's ``d_ff`` is this rank's block, and the
combined output a TP partial sum over the axis, as the reference's
``psum``. The router, the dispatch and the combine weights are
replicated over the axis; under autograd the expert buffers and the
combine weights enter the split compute through ``Axes.enter``, so
their gradients are summed over it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.models.layers import matmul_f32

__all__ = ["MoEOut", "capacity", "route", "moe_swiglu"]

_F32 = torch.float32


class MoEOut(NamedTuple):
    y: torch.Tensor         # [T, d] in x's dtype
    aux_loss: torch.Tensor  # f32: the switch-style load-balance loss
    dropped: torch.Tensor   # f32: the fraction of (token, k) slots dropped


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots an expert holds: ``T K cf / E``, rounded up to a multiple of
    8, at least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: ``(probs [T, E], top_p [T, K], top_e [T, K])``, f32
    softmax probabilities, the top ``K`` renormalized over themselves and
    their experts in descending order, ties to the lower index."""
    logits = matmul_f32(x, w_router)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def moe_swiglu(x: torch.Tensor, w_router: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, cfg: MoEConfig, ax: Axes = SINGLE
               ) -> MoEOut:
    """x ``[T, d]``, router ``[d, E]``, experts ``[E, d, f]`` / ``[E, f,
    d]`` -> :class:`MoEOut`."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    dev = x.device
    probs, top_p, top_e = route(x, w_router, cfg)

    # One-hot masks by comparison: ``one_hot`` and ``bincount`` would wait
    # for the card to check or size their output, a sync a call.
    experts = torch.arange(E, device=dev)

    # Load-balance loss: the top-1 routing fraction against the mean
    # router probability.
    frac = (top_e[:, :1] == experts).sum(0).to(_F32) / T
    aux = E * torch.sum(frac * probs.mean(0))

    # Each (token, k) slot's position in its expert's queue.
    e_flat = top_e.reshape(-1)                                    # [T K]
    onehot = (e_flat[:, None] == experts).to(torch.int32)
    pos = (torch.cumsum(onehot, 0, dtype=torch.int32) - 1).gather(
        1, e_flat[:, None])[:, 0]
    keep = pos < C
    # The reference's f32 mean, as XLA computes it: the sum times 1 / n.
    inv_n = torch.tensor(1.0 / keep.numel(), dtype=_F32, device=dev)
    dropped = 1.0 - keep.to(_F32).sum() * inv_n
    slot = torch.where(keep, e_flat * C + pos, E * C)
    # The expert buffers' fill, counted while a profiler runs.
    obs.add("moe.kept", keep)
    obs.add("moe.slots", E * C)
    tok = torch.arange(T, device=dev).repeat_interleave(K)

    # Dispatch into the expert buffers (+1 scratch row), one expert's
    # SwiGLU at a time, and its outputs into the f32 combine buffer.
    xb = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    xb[slot] = x[tok]
    xb = ax.enter(xb[:E * C].reshape(E, C, d), (ax.model,))
    flat = torch.zeros((E * C + 1, d), dtype=_F32, device=dev)
    for e in range(E):
        g = matmul_f32(xb[e], w_gate[e])
        u = matmul_f32(xb[e], w_up[e])
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        del g, u
        flat[e * C:(e + 1) * C] = matmul_f32(h, w_down[e])
        del h

    # Combine: each slot's output weighted by its router probability.
    w = ax.enter(top_p.reshape(-1) * keep, (ax.model,))
    y = (flat[slot] * w[:, None]).reshape(T, K, d).sum(1)
    y = ax.psum(y, ax.model)  # TP partial sum (f32)
    return MoEOut(y=y.to(x.dtype), aux_loss=aux, dropped=dropped)
