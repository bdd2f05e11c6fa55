"""The training step on one card: loss -> gradients -> clipped AdamW.

The reference's step (``repro.training.train_step``) runs under manual
SPMD; on one card its replication weights are all 1 and its collectives
vanish, which leaves what is here: the loss and its gradients (autograd
in place of ``jax.value_and_grad``), microbatch accumulation in f32, the
global-norm clip and the AdamW update. The pod axis and its gradient
compression have no counterpart on one card (the reference's
``compress_pod_grads`` does nothing without a pod axis either).

Fault (j) of the reference: its step is meant to skip the update on a
non-finite gradient norm, but it only sets the gradient scale to 0, and
``NaN * 0`` is NaN, so the non-finite entries still poison their
parameters and moments while every other entry decays and the schedule
advances. Here such a step leaves the parameters, both moments and the
step count unchanged bit for bit, as the reference documents.

The step reports its metrics as tensors on the card and makes no host
sync; it updates the state in place and returns it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import fwd_train
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)
from repro_torch.training.tree import flatten, leaves, unflatten

__all__ = ["TrainHyper", "TrainState", "global_grad_norm",
           "make_loss_and_grads", "make_train_step"]

_F32 = torch.float32
_CHUNK = 1 << 24  # elements squared and summed at a time


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    adamw: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    aux_weight: float = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err_fb: Any  # error-feedback tree (zeros: no compression on one card)


def global_grad_norm(grads: Any) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g^2))`` in f32, the leaves summed in
    the reference's order."""
    total = torch.zeros((), dtype=_F32, device=leaves(grads)[0].device)
    for g in leaves(grads):
        flat = g.reshape(-1)
        for lo in range(0, flat.numel(), _CHUNK):
            total = total + torch.sum(flat[lo:lo + _CHUNK].to(_F32) ** 2)
    return torch.sqrt(total)


def make_loss_and_grads(cfg: ModelConfig, hyper: TrainHyper) -> Callable:
    """``(params, batch) -> (loss, metrics, grads)``, accumulating
    ``hyper.accum_steps`` microbatches (f32 accumulators, ``g / a`` and
    ``loss / a``; the metrics of the last microbatch). Every key of the
    batch is split along its first dimension, ``frames`` and
    ``prefix_embeds`` as the tokens."""

    def value_and_grad(params, batch):
        flat, treedef = flatten(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = fwd_train(unflatten(treedef, live), batch, cfg,
                                      aux_weight=hyper.aux_weight)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        metrics = type(metrics)(*(m.detach() for m in metrics))
        return loss.detach(), metrics, unflatten(treedef, grads)

    def run(params, batch):
        a = hyper.accum_steps
        if a <= 1:
            return value_and_grad(params, batch)
        micro = {k: torch.as_tensor(v).reshape(
            (a, v.shape[0] // a) + tuple(v.shape[1:]))
            for k, v in batch.items()}
        flat, treedef = flatten(params)
        acc_g = [torch.zeros(p.shape, dtype=_F32, device=p.device)
                 for p in flat]
        acc_l = torch.zeros((), dtype=_F32, device=flat[0].device)
        metrics = None
        for i in range(a):
            loss, metrics, grads = value_and_grad(
                params, {k: v[i] for k, v in micro.items()})
            acc_g = [t + g.to(_F32) / a for t, g in zip(acc_g, leaves(grads))]
            acc_l = acc_l + loss / a
        return acc_l, metrics, unflatten(treedef, acc_g)

    return run


def make_train_step(cfg: ModelConfig, hyper: TrainHyper = TrainHyper()):
    """``step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``labels`` ``[B, S]`` on the parameters' device, and
    whisper's stub ``frames [B, T_enc, d]`` or a VLM's ``prefix_embeds [B,
    P, d]``;
    ``metrics`` is ``loss``, ``grad_norm``, ``aux_loss`` and ``dropped``,
    f32 scalars on the card. ``state`` is updated in place."""
    run = make_loss_and_grads(cfg, hyper)

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = run(state.params, batch)
        gnorm = global_grad_norm(grads)
        clip = hyper.adamw.clip_norm
        scale = (torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                 if clip is not None
                 else torch.ones((), dtype=_F32, device=gnorm.device))
        params, opt = adamw_update(grads, state.opt, state.params,
                                   hyper.adamw, grad_scale=scale,
                                   apply=torch.isfinite(gnorm))
        out = {"loss": loss, "grad_norm": gnorm,
               "aux_loss": metrics.aux_loss, "dropped": metrics.dropped}
        return TrainState(params, opt, state.err_fb), out

    return step
