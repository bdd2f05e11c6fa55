"""Weight-sharing online learning for cache replacement (paper §III-A).

Algorithms 1 (GetVictim: the highest-probability expert evicts) and 2
(WeightSharing: every ``EPOCH_WIDTH`` iterations, experts whose
misprediction count reaches ``THRESHOLD * miss_count`` are penalized
``w_i <- w_i * beta^{l_i}``, the lost weight is shared back
``w_i <- w_i + alpha * mean_lost``, and the weights are renormalized).

Tensors carry a leading batch axis ``[B, ...]``: one row per cache shard,
so one call advances every shard of a distributed store.

The f32 arithmetic repeats the reference's rounding step for step, because
the argmax of the weights picks evictions and a one-ulp drift can flip a
near tie:

- every 3-element sum is spelled ``(a + b) + c`` and the mean as that sum
  times ``float32(1/3)``;
- the two products that XLA contracts into fused multiply-adds keep a
  single rounding: ``prev - prev * pw`` and ``prev * pw + alpha * share``
  go through :func:`fma_f32` (the CUDA kernel uses ``__fmaf_rn``);
- ``beta ** losses`` is a lookup in a per-row table ``pw[k] = pow(beta,
  k)`` built by :func:`pow_table`. Under ``ws`` the losses are integers in
  ``0..epoch_width`` (``mispred`` is cleared at every epoch boundary); the
  CUDA kernel reads the same table, so the two agree by construction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "EXPERTS",
    "N_EXPERTS",
    "OLConfig",
    "OLState",
    "init_ol",
    "probabilities",
    "choose_expert",
    "pow_table",
    "fma_f32",
    "weight_adjust",
]

# Expert order is part of the public contract (indices used in stats/tests).
EXPERTS: tuple[str, ...] = ("lru", "lfu", "random")
N_EXPERTS = len(EXPERTS)

_THIRD = torch.tensor(1.0 / 3.0, dtype=torch.float32)
_FLOOR = torch.tensor(1e-8, dtype=torch.float32)


class OLConfig(NamedTuple):
    """Online-learning knobs. ``epoch_width`` and ``pred_cap`` are
    structural; ``alpha``, ``beta`` and ``threshold`` are floats or f32
    tensors of shape ``[B]`` (one setting per row)."""

    epoch_width: int = 4      # iterations per epoch (paper §III-A)
    alpha: float = 0.5        # weight-share rate
    beta: float = 0.7         # multiplicative penalty base (< 1)
    threshold: float = 0.25   # ignore experts below threshold*miss_count
    pred_cap: int = 64        # prediction-vector ring capacity per expert


class OLState(NamedTuple):
    weights: torch.Tensor       # f32[..., E]
    pred: torch.Tensor          # int32[..., E, C] evicted pages this epoch
    pred_n: torch.Tensor        # int32[..., E] ring write cursor
    mispred: torch.Tensor       # int32[..., E]
    epoch_misses: torch.Tensor  # int32[..., 1] misses in current epoch
    chosen: torch.Tensor        # int32[..., 1] expert of the last eviction


def init_ol(cfg: OLConfig, *, device=None) -> OLState:
    i32 = dict(dtype=torch.int32, device=device)
    return OLState(
        weights=torch.ones(N_EXPERTS, dtype=torch.float32, device=device)
        / N_EXPERTS,
        pred=torch.full((N_EXPERTS, cfg.pred_cap), -1, **i32),
        pred_n=torch.zeros(N_EXPERTS, **i32),
        mispred=torch.zeros(N_EXPERTS, **i32),
        epoch_misses=torch.zeros(1, **i32),
        chosen=torch.zeros(1, **i32),
    )


def _sum3(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def probabilities(weights: torch.Tensor) -> torch.Tensor:
    s = _sum3(weights)[..., None]
    return torch.where(s > 0, weights / s,
                       torch.full_like(weights, 1.0 / N_EXPERTS))


def choose_expert(ol: OLState, policy_idx=None) -> torch.Tensor:
    """Algorithm 1: highest-probability expert (first on ties), or a fixed
    expert where ``policy_idx >= 0`` (``-1`` = online learning)."""
    learned = probabilities(ol.weights).argmax(-1).to(torch.int32)
    if policy_idx is None:
        return learned
    idx = torch.as_tensor(policy_idx, dtype=torch.int32,
                          device=learned.device)
    return torch.where(idx >= 0, idx.clamp(0, N_EXPERTS - 1), learned)


def pow_table(beta, epoch_width: int) -> torch.Tensor:
    """``pw[b, k] = beta[b] ** k`` for ``k = 0..epoch_width``, f32, on the
    host. Each entry is one single-element ``torch.pow`` call: that path
    rounds like the reference's f32 ``power``, while the vectorized path
    of a wide call may differ in the last ulp."""
    beta = torch.as_tensor(beta, dtype=torch.float32).reshape(-1).cpu()
    cache: dict = {}
    rows = []
    for b in beta.tolist():
        if b not in cache:
            bt = torch.tensor([b], dtype=torch.float32)
            cache[b] = torch.cat([
                torch.pow(bt, torch.tensor([float(k)], dtype=torch.float32))
                for k in range(epoch_width + 1)])
        rows.append(cache[b])
    return torch.stack(rows)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors, rounded once (a fused multiply-add).

    The product of two f32 values is exact in f64, and the f64 sum ``s``
    with its error ``e`` (Knuth's two-sum) is exact too, so rounding ``s``
    to f32 is the fused result except where ``s`` lies exactly halfway
    between two f32 values; there the sign of ``e`` picks the side."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    up = torch.nextafter(r, inf)
    dn = torch.nextafter(r, -inf)
    diff = s - r64
    to_up = (diff > 0) & (2 * diff == up.double() - r64) & (err > 0)
    to_dn = (diff < 0) & (-2 * diff == r64 - dn.double()) & (err < 0)
    return torch.where(to_up, up, torch.where(to_dn, dn, r))


def weight_adjust(ol: OLState, cfg: OLConfig, pw=None) -> OLState:
    """Algorithm 2 epoch-boundary update for every row. ``pw`` is the
    :func:`pow_table` of ``cfg.beta`` (built here when omitted); losses
    past the table's width clamp to its last entry, a state no ``ws`` run
    reaches."""
    prev = ol.weights
    dev = prev.device
    if pw is None:
        pw = pow_table(cfg.beta, cfg.epoch_width)
    pw = pw.to(dev).reshape(-1, pw.shape[-1])
    pw = (pw.expand(prev.shape[:-1] + pw.shape[-1:]) if prev.dim() > 1
          else pw[0])
    f32 = torch.float32
    threshold = torch.as_tensor(cfg.threshold, dtype=f32, device=dev)
    alpha = torch.as_tensor(cfg.alpha, dtype=f32, device=dev)
    if threshold.dim():
        threshold = threshold[..., None]
    if alpha.dim():
        alpha = alpha[..., None]
    thresh = threshold * ol.epoch_misses.to(f32)
    losses = torch.where(ol.mispred.to(f32) >= thresh, ol.mispred, 0)
    idx = losses.long().clamp(0, pw.shape[-1] - 1)
    p = torch.gather(pw, -1, idx)
    share = _sum3(fma_f32(-prev, p, prev))[..., None] * _THIRD.to(dev)
    w = fma_f32(prev, p, (alpha * share).expand_as(prev))
    w = torch.maximum(w, _FLOOR.to(dev))
    w = w / _sum3(w)[..., None]
    return ol._replace(
        weights=w,
        pred=torch.full_like(ol.pred, -1),
        pred_n=torch.zeros_like(ol.pred_n),
        mispred=torch.zeros_like(ol.mispred),
        epoch_misses=torch.zeros_like(ol.epoch_misses),
    )
