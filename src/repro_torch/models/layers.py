"""Shared model layers on one card.

Numerics as the reference: parameters and activations in the model's
dtype, normalization, RoPE, softmax and logsumexp in f32, products
accumulated in f32. A product of two bf16 (or f32) tensors through
``torch.matmul`` accumulates in f32 on the card and on the CPU, which is
what the reference's ``preferred_element_type=f32`` followed by a cast to
the activation dtype computes. The dense projections and the
unembedding stay ``torch.matmul``: the reference computes them outside any
Pallas kernel. Every function here is differentiable under autograd, as
the train step needs.

Under a model axis (TP) the helpers place the gradient reductions that
the reference's vma types place (:mod:`repro_torch.distributed.axes`):
an activation replicated over the axis enters the column-parallel
projections, the sharded vocabulary and the TP norm's summed normalizer
through :meth:`~repro_torch.distributed.axes.Axes.enter` (its gradient
summed over the axis), and the TP partial sums leave through ``psum``
(its gradient passed through).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import device as _dev
from repro_torch.distributed.axes import SINGLE, Axes

__all__ = ["dense", "rms_norm", "rms_norm_tp", "tp_out", "rope_tables",
           "apply_rope", "sinusoidal_positions", "embed", "unembed_loss",
           "unembed_greedy", "mlp_swiglu", "mlp_gelu", "matmul_f32",
           "causal_conv1d"]

_F32 = torch.float32
# Vocabulary rows of the unembedding converted to f32 at a time.
_UNEMBED_CHUNK = 16384


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, output in x.dtype."""
    return torch.matmul(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(_F32))).to(x.dtype)


def rms_norm_tp(x: torch.Tensor, scale: torch.Tensor, eps: float, ax: Axes,
                full_width: int) -> torch.Tensor:
    """RMSNorm over a TP-sharded last dim: the sum of squares summed over
    the model axis, so the normalizer is the unsharded one."""
    xf = x.to(_F32)
    ss = torch.sum(xf * xf, dim=-1, keepdim=True)
    if x.shape[-1] != full_width:
        ss = ax.enter(ax.psum(ss, ax.model), (ax.model,))
    y = xf * torch.rsqrt(ss / full_width + eps)
    return (y * (1.0 + scale.to(_F32))).to(x.dtype)


def tp_out(x: torch.Tensor, w: torch.Tensor, ax: Axes,
           reduce_dtype=_F32) -> torch.Tensor:
    """A TP partial product ``x @ w`` (x ``[..., k]``): the f32 sums of
    the local block summed over the model axis in ``reduce_dtype``, then
    cast to x's dtype."""
    out = matmul_f32(x.reshape(-1, x.shape[-1]), w)
    out = ax.psum(out.to(reduce_dtype), ax.model)
    return out.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)


def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE's ``(cos, sin)`` for ``positions [..., S]``: f32 ``[..., S, 1,
    hd / 2]``, broadcasting over heads. Every layer of one step shares
    them."""
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=_F32,
                             device=positions.device) / half
    freq = torch.pow(theta, exponent)  # a Python base: no host-to-card copy
    ang = positions[..., :, None].to(_F32) * freq      # [..., S, half]
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope(x: torch.Tensor, rope: tuple) -> torch.Tensor:
    """RoPE over the last dim of x ``[..., S, H, hd]``, with ``rope`` the
    :func:`rope_tables` of its positions ``[..., S]``."""
    half = x.shape[-1] // 2
    cos, sin = rope
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper's absolute position embeddings, f32 ``[..., S, d]`` for
    ``positions [..., S]``: ``sin`` then ``cos`` of ``position x
    exp(-i log(10000) / (d / 2 - 1))``."""
    half = d // 2
    dev = positions.device
    step = torch.log(torch.tensor(10000.0, dtype=_F32, device=dev)) / (
        half - 1)
    freq = torch.exp(-torch.arange(half, dtype=_F32, device=dev) * step)
    ang = positions[..., :, None].to(_F32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed(tokens: torch.Tensor, emb: torch.Tensor, ax: Axes = SINGLE
          ) -> torch.Tensor:
    """tokens [...] int -> [..., d]. Under a model axis ``emb`` is this
    rank's block of the vocabulary: each rank looks up the tokens it
    holds, zeros elsewhere, and the blocks are summed."""
    if ax.model is None:
        return emb[tokens.long()]
    v_local = emb.shape[0]
    local = tokens.long() - ax.index(ax.model) * v_local
    ok = (local >= 0) & (local < v_local)
    out = emb[local.clamp(0, v_local - 1)] * ok[..., None].to(emb.dtype)
    return ax.psum(out, ax.model)


def unembed_loss(x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 ax: Axes = SINGLE, *, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Unembedding and cross-entropy: the mean NLL (f32) of ``labels [B,
    S]`` under the f32 logits of x ``[B, S, d]`` and the unembedding ``[V,
    d]``, as the reference computes it: logsumexp shifted by the logits'
    maximum (held constant under differentiation) minus the label's
    logit. With ``mask [B, S]`` the mean runs over its weight.

    Under a model axis ``emb`` is this rank's block of the vocabulary and
    no logit leaves its rank: the maximum is a ``pmax`` of the local ones,
    the exponentials' sum and the label's logit (its rank's, zero on the
    others; the window starting at ``index(model) * V_local``) are summed
    over the axis."""
    v_local = emb.shape[0]
    if ax.model is not None:
        x = ax.enter(x, (ax.model,))
    logits = torch.matmul(x.to(_F32), emb.to(_F32).t())   # [B, S, V]
    m = ax.pmax(logits.detach().amax(-1), ax.model)
    se = ax.psum_rep(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                     ax.model)
    local = labels.long() - ax.index(ax.model) * v_local
    label_logit = torch.gather(logits, -1,
                               local.clamp(0, v_local - 1)[..., None])[..., 0]
    if ax.model is not None:
        ok = (local >= 0) & (local < v_local)
        label_logit = ax.psum_rep(torch.where(ok, label_logit, 0.0),
                                  ax.model)
    nll = torch.log(se) + m - label_logit
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask.to(_F32)), min=1.0)
    else:
        denom = float(nll.numel())
    return torch.sum(nll) / denom


def unembed_greedy(x: torch.Tensor, emb: torch.Tensor, ax: Axes = SINGLE
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy next token: x [B, d] -> (token [B] int32, logprob [B] f32).

    The logits are f32 products of x and the unembedding, built a chunk of
    the vocabulary at a time (so no f32 copy of the whole table is held).
    Ties go to the lowest id, as the reference's and ``torch.argmax``.
    Under a model axis ``emb`` is this rank's block of the vocabulary, and
    no logit leaves its rank: the maximum is a ``pmax``, the softmax's sum
    a ``psum``, and the token the lowest id among the ranks that hold the
    maximum (``pmax`` of the negated candidates)."""
    xf = x.to(_F32)
    logits = torch.cat([
        torch.matmul(xf, emb[v0:v0 + _UNEMBED_CHUNK].to(_F32).t())
        for v0 in range(0, emb.shape[0], _UNEMBED_CHUNK)], dim=-1)
    m_loc = torch.max(logits, dim=-1).values
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    if ax.model is None:
        se = torch.sum(torch.exp(logits - m_loc[..., None]), dim=-1)
        return token, m_loc - torch.log(se)
    m = ax.pmax(m_loc, ax.model)
    se = ax.psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                 ax.model)
    cand = torch.where(m_loc >= m,
                       token + ax.index(ax.model) * emb.shape[0],
                       torch.iinfo(torch.int32).max)
    return -ax.pmax(-cand, ax.model), m - torch.log(se)


def mlp_swiglu(x, w_gate, w_up, w_down, ax: Axes = SINGLE) -> torch.Tensor:
    """SwiGLU; under a model axis ``d_ff`` is this rank's block and the
    down projection a TP partial sum (:func:`tp_out`)."""
    if ax.model is not None:
        x = ax.enter(x, (ax.model,))
    g = dense(x, w_gate)
    u = dense(x, w_up)
    h = F.silu(g.to(_F32)).to(x.dtype) * u
    if ax.model is None:
        return torch.matmul(h, w_down)
    return tp_out(h, w_down, ax)


class _MatmulF32(torch.autograd.Function):
    """cuBLAS's f32 sums of bf16 products, which have no derivative in
    PyTorch, with the gradients of a product in the operands' dtype (as
    autograd takes them through :func:`dense`): the output's gradient
    rounded to that dtype, then multiplied by each operand."""

    @staticmethod
    def forward(a, b):
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=_F32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None,
                a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched 3-D) summed and returned in f32, as the
    reference's ``preferred_element_type=f32`` products that are used
    before any cast. On the card (and on the dry run's ``meta`` stand-in
    for it) cuBLAS writes the f32 sums of bf16 products directly (under
    autograd through :class:`_MatmulF32`); on the CPU the operands are
    widened first (a product of two bf16 values is exact in f32)."""
    if _dev.follows_card(a) and a.dtype != _F32:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MatmulF32.apply(a, b)
        return _MatmulF32.forward(a, b)
    return torch.matmul(a.to(_F32), b.to(_F32))


def mlp_gelu(x, w1, b1, w2, b2, ax: Axes = SINGLE) -> torch.Tensor:
    """Whisper's FFN: ``gelu(x w1 + b1) w2 + b2``, with ``b1`` added in x's
    dtype, the tanh-approximated gelu (``jax.nn.gelu``'s default) in f32,
    and ``b2`` added in f32 to the unrounded down projection (summed over
    the model axis first, under one)."""
    if ax.model is not None:
        x = ax.enter(x, (ax.model,))
    h = dense(x, w1) + b1.to(x.dtype)
    h = F.gelu(h.to(_F32), approximate="tanh").to(x.dtype)
    out = matmul_f32(h.reshape(-1, h.shape[-1]), w2)
    out = ax.psum(out, ax.model).reshape(h.shape[:-1] + (w2.shape[-1],))
    return (out + b2.to(_F32)).to(x.dtype)


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of the recurrent blocks: x ``[B, S,
    W]``, kernel ``[K, W]``; summed in f32 tap by tap, returned in x's
    dtype."""
    K = kernel.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=_F32, device=x.device)
    for k in range(K):
        out = out + xp[:, k:k + x.shape[1]].to(_F32) * kernel[k].to(_F32)
    return out.to(x.dtype)
