"""The training step: loss -> synced gradients -> clipped AdamW.

The reference's step (``repro.training.train_step``) runs under manual
SPMD, where its varying-manual-axes types make autodiff place the
gradient reductions over ``"data"`` (the FSDP gathers' reduce-scatter)
and ``"model"`` (the TP partials). Here one process runs each rank, and
the same reductions come from the collectives' backwards and the entry
markers (:mod:`repro_torch.distributed.axes`), with :func:`promote`
marking the leaves that are replicated over ``"data"`` (their partial
gradients summed over it). On one card (:data:`SINGLE`) every collective
is the identity and the replication weights are 1.

The ``"pod"`` axis (pure data parallelism) is reduced explicitly: the
loss is averaged over ``"data"`` only, so each pod's gradients are its
own until the step averages them across pods, with ``pmean`` or, with
``compress_pod_grads``, with int8 codes and error feedback
(:func:`repro_torch.training.compression.compressed_psum`).

Fault (n) of the reference: under vma the parameters, replicated over
``"pod"``, are promoted implicitly where they meet the pod's batch, so
autodiff already sums the pods' gradients; the explicit ``pmean`` then
finds them equal, and the step's gradient is the pods' sum, ``n_pod``
times the mean (its grad norm ``n_pod`` times the one-card step's; the
compression codes the summed gradient). The port does what the reference
documents: pod-local gradients, averaged by the step.

Fault (j) of the reference: its step is meant to skip the update on a
non-finite gradient norm, but it only sets the gradient scale to 0, and
``NaN * 0`` is NaN, so the non-finite entries still poison their
parameters and moments while every other entry decays and the schedule
advances. Here such a step leaves the parameters, both moments and the
step count unchanged bit for bit, as the reference documents; the norm
that decides it is equal on every rank.

The step reports its metrics as tensors on the card (equal on every
rank) and makes no host sync; it updates the state in place and returns
it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.models import params as pm
from repro_torch.models.transformer import fwd_train
from repro_torch.training import compression
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update)
from repro_torch.training.tree import flatten, leaves, unflatten

__all__ = ["TrainHyper", "TrainState", "global_grad_norm", "promote",
           "make_loss_and_grads", "make_train_step"]

_F32 = torch.float32
_CHUNK = 1 << 24  # elements squared and summed at a time


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    adamw: AdamWConfig = AdamWConfig()
    accum_steps: int = 1
    compress_pod_grads: bool = False
    aux_weight: float = 0.01


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err_fb: Any  # error-feedback tree (zeros when compression is off)


def _replication(grads: Any, gs_tree: Optional[dict], ax: Axes) -> list:
    """How many ranks hold each leaf's gradient (the data and model axes
    it is replicated over), in leaf order."""
    if gs_tree is None:
        return [1.0] * len(leaves(grads))

    def rep(_, s):
        r = 1.0
        if s["data"] and ax.data is not None:
            r *= ax.data_size
        if s["model_rep"] and ax.model is not None:
            r *= ax.model_size
        return r
    return leaves(pm.zip_map(rep, grads, gs_tree))


def global_grad_norm(grads: Any, gs_tree: Optional[dict] = None,
                     ax: Axes = SINGLE) -> torch.Tensor:
    """The global L2 norm in f32, exact under 2-D sharding: each leaf's
    local sum of squares divided by the ranks that hold it
    (:func:`~repro_torch.models.params.grad_sync`'s ``data`` and
    ``model_rep``), summed in the reference's leaf order, then over
    ``(data, model)`` in one collective."""
    total = torch.zeros((), dtype=_F32, device=leaves(grads)[0].device)
    for g, rep in zip(leaves(grads), _replication(grads, gs_tree, ax)):
        flat = g.reshape(-1)
        sq = sum(torch.sum(flat[lo:lo + _CHUNK].to(_F32) ** 2)
                 for lo in range(0, flat.numel(), _CHUNK))
        total = total + sq / rep
    return torch.sqrt(ax.psum_many(total, (ax.data, ax.model)))


def promote(params: Any, gs_tree: dict, ax: Axes) -> Any:
    """Each leaf replicated over ``"data"`` (``grad_sync``'s ``data``)
    entered over it, so its partial gradients are summed over the data
    axis, as the reference's ``promote`` (its ``pvary_entry``, and the
    implicit promotion under vma). The ``model`` flag is the reference's
    pre-vma shim's: under vma its sums sit where a replicated activation
    meets split compute, and so do the port's (:mod:`repro_torch.models.
    layers`), so a sum at the leaf would count them twice."""
    if ax.data is None:
        return params
    return pm.zip_map(lambda p, s: ax.enter(p, (ax.data,)) if s["data"]
                      else p, params, gs_tree)


def make_loss_and_grads(cfg: ModelConfig, ax: Axes = SINGLE,
                        ms: Optional[pm.MeshSizes] = None,
                        hyper: "TrainHyper" = None) -> tuple[Callable, dict]:
    """``((params, batch) -> (loss, metrics, grads), grad_sync tree)``,
    accumulating ``hyper.accum_steps`` microbatches (f32 accumulators,
    ``g / a`` and ``loss / a``; the metrics of the last microbatch). Every
    key of the batch is split along its first dimension, ``frames`` and
    ``prefix_embeds`` as the tokens. Under a mesh ``params`` and
    ``batch`` are this rank's, and so are the gradients: each leaf's
    block, summed over the data and model axes as the reference's vma
    autodiff sums it."""
    ms = ms or pm.MeshSizes()
    hyper = hyper or TrainHyper()
    gs_tree = pm.grad_sync(cfg, ms)

    def value_and_grad(params, batch):
        flat, treedef = flatten(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = fwd_train(
                promote(unflatten(treedef, live), gs_tree, ax), batch, cfg,
                ax, ms=ms, aux_weight=hyper.aux_weight)
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

    return run, gs_tree


def make_train_step(cfg: ModelConfig, ax: Axes = SINGLE,
                    ms: Optional[pm.MeshSizes] = None,
                    hyper: TrainHyper = TrainHyper()):
    """``step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``labels`` ``[B, S]`` on the parameters' device, and
    whisper's stub ``frames [B, T_enc, d]`` or a VLM's ``prefix_embeds [B,
    P, d]``; ``metrics`` is ``loss``, ``grad_norm``, ``aux_loss`` and
    ``dropped``, f32 scalars on the card, equal on every rank. ``state``
    is updated in place. Under a mesh (``ax``, ``ms``) the state and the
    batch are this rank's blocks (:func:`repro_torch.launch.spmd.
    build_train_step`)."""
    run, gs_tree = make_loss_and_grads(cfg, ax, ms, hyper)

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = run(state.params, batch)
        if ax.pod is not None:
            flat, treedef = flatten(grads)
            if hyper.compress_pod_grads:
                flat, err = compression.compressed_psum(
                    flat, leaves(state.err_fb), ax, ax.pod)
                for e, new in zip(leaves(state.err_fb), err):
                    e.copy_(new)
            else:
                flat = ax.dp_mean_grads(flat)
            grads = unflatten(treedef, flat)
            loss = ax.pmean(loss, ax.pod)
        gnorm = global_grad_norm(grads, gs_tree, ax)
        clip = hyper.adamw.clip_norm
        scale = (torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                 if clip is not None
                 else torch.ones((), dtype=_F32, device=gnorm.device))
        params, opt = adamw_update(grads, state.opt, state.params,
                                   hyper.adamw, grad_scale=scale,
                                   apply=torch.isfinite(gnorm))

        def rep(v):  # equal on every rank of the batch axes
            return ax.pmean(ax.pmean(v, ax.data), ax.pod)

        out = {"loss": loss, "grad_norm": gnorm,
               "aux_loss": rep(metrics.aux_loss),
               "dropped": rep(metrics.dropped)}
        return TrainState(params, opt, state.err_fb), out

    return step
