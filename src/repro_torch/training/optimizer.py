"""AdamW with a linear-warmup, cosine-decay schedule, for one card.

Elementwise and leaf by leaf in the reference's spelling
(``repro.training.optimizer``): ``b1 ** t`` in f32, ``m_hat / (sqrt(v_hat)
+ eps)``, the decay on the f32 parameter, each result cast back to its
leaf's dtype. The same gradients give the reference's update to the last
bit or within one f32 ulp (``pow`` and ``cos`` round as the platform's
libm does; square roots are correctly rounded on both devices). No fused
library optimizer: its arithmetic differs.

The update runs in place, as the reference's step does with its state
donated: at stablelm-3b's width a second copy of the parameters and
moments would not fit beside the first. Each leaf is updated a slice of
``_CHUNK`` elements at a time, so the f32 temporaries stay small.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import device as _dev
from repro_torch.training.tree import leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "lr_schedule",
           "adamw_update"]

_F32 = torch.float32
_CHUNK = 1 << 24  # elements of a leaf updated at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any             # tree like params
    nu: Any


def adamw_init(params: Any, dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``, in f32."""
    s = torch.as_tensor(step).to(_F32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    cfg: AdamWConfig,
    *,
    grad_scale: torch.Tensor | float = 1.0,
    apply: Optional[torch.Tensor] = None,
) -> tuple[Any, AdamWState]:
    """One AdamW step, in place on ``params``, ``state.mu`` and
    ``state.nu``; returns them with the advanced step.

    ``grad_scale`` multiplies the gradients first (the global-norm clip).
    ``apply``, a bool scalar tensor, makes the step conditional on the
    card, without a host sync: where it is false, every parameter, moment
    and the step count keep their values bit for bit.
    """
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    t = step.to(_F32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.mu), leaves(state.nu)):
            _update_leaf(p, g, m, v, cfg, grad_scale, lr, bc1, bc2, apply)
    if apply is not None:
        step = torch.where(apply, step, state.step)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root: the card's ``sqrtf`` is;
    PyTorch's vectorized CPU ``sqrt`` is not always (one ulp off on some
    entries), while the f64 root of an f32 value rounds to the f32 one."""
    if _dev.follows_card(x):
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(_F32)


def _update_leaf(p, g, m, v, cfg: AdamWConfig, grad_scale, lr, bc1, bc2,
                 apply) -> None:
    pf, gf_all, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
    for lo in range(0, pf.numel(), _CHUNK):
        pc, mc, vc = pf[lo:lo + _CHUNK], mf[lo:lo + _CHUNK], vf[lo:lo + _CHUNK]
        gf = gf_all[lo:lo + _CHUNK].to(_F32) * grad_scale
        m_new = cfg.b1 * mc.to(_F32) + (1 - cfg.b1) * gf
        v_new = cfg.b2 * vc.to(_F32) + (1 - cfg.b2) * gf * gf
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (_sqrt(v_hat) + cfg.eps)
        delta = delta + cfg.weight_decay * pc.to(_F32)
        p_new = pc.to(_F32) - lr * delta
        for dst, new in ((pc, p_new), (mc, m_new), (vc, v_new)):
            new = new.to(dst.dtype)
            dst.copy_(new if apply is None else torch.where(apply, new, dst))
