"""Pre-norm mixture-of-experts SwiGLU: a softmax router over the experts,
each token to its top-k (ties to the lower expert), the k weights
renormalized over themselves.

Where the configuration states a capacity factor (``assumed.
moe_capacity_factor``), each expert takes at most ``C`` tokens of a group
that was routed together, in token-major order over the group's (token,
k) slots; a slot past ``C`` is dropped and adds nothing. ``C = max(8,
T K cf / E rounded down, then up to a multiple of 8)`` for a group of
``T`` tokens. A group is the whole prefill of a batch, or one decode step
of it, as the served program routed them.
"""
from __future__ import annotations

import torch

from .common import F32, rms_norm
from .swiglu import swiglu_rows

COUPLES_BATCH = True  # capacity counts over every request of a group


def leaves(m: dict) -> dict:
    d, f, e = m["d"], m["d_ff"], m["experts"]
    return {"w_router": ((d, e), d ** -0.5),
            "w_gate": ((e, d, f), d ** -0.5), "w_up": ((e, d, f), d ** -0.5),
            "w_down": ((e, f, d), f ** -0.5), "norm2": ((d,), 0.1)}


def capacity(n_tokens: int, top_k: int, cf: float, n_experts: int) -> int:
    c = int(n_tokens * top_k * cf / n_experts)
    return max(8, -(-c // 8) * 8)


def route(h, w_router, m, cf):
    """``(expert [T, K], weight [T, K])`` of each slot of ``h [T, d]``,
    the weight 0 where capacity drops the slot."""
    e, k = m["experts"], m["top_k"]
    probs = torch.softmax(torch.matmul(h, w_router), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    if cf is not None:
        flat = top_e.reshape(-1)
        onehot = (flat[:, None] == torch.arange(e, device=h.device)).long()
        pos = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
        keep = pos < capacity(h.shape[0], k, cf, e)
        top_p = top_p * keep.reshape(top_p.shape)
    return top_e, top_p


def apply(x, p, ctx):
    m = ctx.m
    n, t, d = x.shape
    h = rms_norm(x, p["norm2"], m["eps"])
    w_router = ctx.cast(p["w_router"])
    # Each group's tokens in the order the program routed them.
    order = torch.cat([
        (torch.arange(n, device=x.device)[:, None] * t
         + torch.arange(a, b, device=x.device)[None, :]).reshape(-1)
        for a, b in ctx.groups])
    flat_h = h.reshape(-1, d)
    experts, weights, start = [], [], 0
    for a, b in ctx.groups:
        rows = order[start:start + n * (b - a)]
        start += rows.numel()
        e, w = route(flat_h[rows], w_router, m, m["capacity_factor"])
        experts.append(e)
        weights.append(w)
    experts, weights = torch.cat(experts), torch.cat(weights)
    y = torch.zeros_like(flat_h)
    for e in range(m["experts"]):
        sel = (experts == e) & (weights > 0)
        slot_tok, slot_k = sel.nonzero(as_tuple=True)
        if slot_tok.numel() == 0:
            continue
        tok = order[slot_tok]
        wg, wu, wd = (ctx.cast(p[k][e]) for k in ("w_gate", "w_up",
                                                   "w_down"))
        out = swiglu_rows(flat_h[tok], wg, wu, wd)
        y.index_add_(0, tok, out * weights[slot_tok, slot_k][:, None])
        del wg, wu, wd, out
    return x + y.reshape(x.shape).to(F32)
