"""Attention in plain PyTorch: blockwise (flash-style) attention and the
partial state of decode attention.

``blockwise_attention`` is the reference's online-softmax attention over
KV blocks, with the blocks that a causal, sliding-window or prefix-LM
pattern cannot see skipped. The port's prefill runs the flash kernel
(:mod:`repro_torch.kernels.flash_attention`); this function is the
independent forward that :func:`repro_torch.models.transformer.fwd_hidden`
computes, against which decode is checked.

``attention_partial`` / ``combine_partials`` expose the online-softmax
partial ``(acc, m, l)``. On one card, ``combine_partials`` merges the
tier-1 and tier-2 partials of one decode step. Across page shards each
rank merges its two tiers with ``merge_partials`` and
``combine_shards`` puts the ranks' partials together, the reference's
``combine_partials``: a ``pmax`` of ``m`` and one ``psum`` of ``(acc,
l)`` rescaled to it, O(B H hd) bytes, and no page moves. A rank that owns
no live token of a row holds the empty partial (acc 0, m -1e30, l 0),
which the rescale turns into nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.distributed.axes import Axes

__all__ = ["blockwise_attention", "Partial", "attention_partial",
           "combine_partials", "merge_partials", "combine_shards"]

_F32 = torch.float32
_NEG = -1e30


def blockwise_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    prefix_len: int = 0,
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    """Online-softmax attention with statically skipped KV blocks;
    returns ``[B, Sq, H, hd]`` in q's dtype. With ``causal``, key ``j`` is
    visible to query ``i`` if ``j <= i`` (and ``j > i - window``), or if
    ``j < prefix_len`` (the bidirectional prefix of a prefix-LM)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(block_q, Sq), min(block_kv, Skv)
    nq, nkv = -(-Sq // bq), -(-Skv // bk)
    dev = q.device
    out = torch.empty((B, nq * bq, KV, G, hd), dtype=_F32, device=dev)
    for i in range(nq):
        q_lo, q_hi = i * bq, (i + 1) * bq - 1
        if causal:
            hi = min(nkv, -(-(q_hi + 1) // bk))
            lo = (max(0, (q_lo - window + 1) // bk) if window is not None
                  else 0)
            if prefix_len:
                lo, hi = 0, min(nkv, max(hi, -(-prefix_len // bk)))
            hi = max(hi, lo + 1)
        else:
            lo, hi = 0, nkv
        qi = q[:, q_lo:q_lo + bq].reshape(B, -1, KV, G, hd)
        q_pos = torch.arange(q_lo, q_lo + qi.shape[1], device=dev)
        m = torch.full((B, KV, G, qi.shape[1]), _NEG, dtype=_F32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,), dtype=_F32, device=dev)
        for j in range(lo, hi):
            kj = k[:, j * bk:(j + 1) * bk]
            vj = v[:, j * bk:(j + 1) * bk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi.to(_F32),
                             kj.to(_F32)) * scale
            kv_pos = torch.arange(j * bk, j * bk + kj.shape[1], device=dev)
            ok = torch.ones((q_pos.numel(), kv_pos.numel()), dtype=torch.bool,
                            device=dev)
            if causal:
                ok = q_pos[:, None] >= kv_pos[None, :]
                if window is not None:
                    ok &= kv_pos[None, :] > (q_pos[:, None] - window)
                if prefix_len:
                    ok |= kv_pos[None, :] < prefix_len
            s = torch.where(ok, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vj.to(_F32))
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]   # [B, KV, G, bq, hd]
        out[:, q_lo:q_lo + qi.shape[1]] = o.permute(0, 3, 1, 2, 4)
    return out[:, :Sq].reshape(B, Sq, H, hd).to(q.dtype)


class Partial(NamedTuple):
    acc: torch.Tensor  # [..., hd] f32 — unnormalized weighted values
    m: torch.Tensor    # [...]     f32 — running max
    l: torch.Tensor    # [...]     f32 — running sum of exp


def attention_partial(
    q: torch.Tensor,      # [B, H, hd] single-token query
    k: torch.Tensor,      # [B, T, KV, hd]
    v: torch.Tensor,
    valid: torch.Tensor,  # [B, T] bool — which positions are live
) -> Partial:
    """The partial over ``T`` positions, per ``[B, KV, G]`` head."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).to(_F32)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.to(_F32)) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, _NEG))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.to(_F32))
    return Partial(acc=acc, m=m, l=l)


def combine_partials(parts: Sequence[Partial]) -> torch.Tensor:
    """Merge partials over disjoint positions (flash-decoding) and
    normalize: ``[B, H, hd]`` f32 from partials of ``acc [B, H, hd]``,
    ``m``/``l [B, H]`` (or any shapes where ``acc`` has one more trailing
    dim)."""
    m_g = parts[0].m
    for p in parts[1:]:
        m_g = torch.maximum(m_g, p.m)
    l_g = acc_g = None
    for p in parts:
        corr = torch.exp(p.m - m_g)
        lc, ac = p.l * corr, p.acc * corr[..., None]
        l_g = lc if l_g is None else l_g + lc
        acc_g = ac if acc_g is None else acc_g + ac
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def merge_partials(parts: Sequence[Partial]) -> Partial:
    """The partial over the union of disjoint positions, unnormalized:
    ``m`` the maximum, ``l`` and ``acc`` rescaled to it and summed."""
    m_g = parts[0].m
    for p in parts[1:]:
        m_g = torch.maximum(m_g, p.m)
    l_g = acc_g = None
    for p in parts:
        corr = torch.exp(p.m - m_g)
        lc, ac = p.l * corr, p.acc * corr[..., None]
        l_g = lc if l_g is None else l_g + lc
        acc_g = ac if acc_g is None else acc_g + ac
    return Partial(acc=acc_g, m=m_g, l=l_g)


def combine_shards(part: Partial, ax: Axes, names) -> torch.Tensor:
    """Combine the page shards' partials over the mesh axes ``names``
    (flash-decoding across ranks) and normalize: ``[B, H, hd]`` f32."""
    m_g = ax.pmax_many(part.m, names)
    corr = torch.exp(part.m - m_g)
    packed = torch.cat([part.acc * corr[..., None],
                        (part.l * corr)[..., None]], dim=-1)
    packed = ax.psum_many(packed, names)
    acc_g, l_g = packed[..., :-1], packed[..., -1]
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]
