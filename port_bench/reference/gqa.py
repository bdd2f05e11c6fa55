"""Pre-norm causal self-attention with grouped query heads and RoPE.

Query head h reads key/value head ``h // (heads / kv_heads)``. Scores are
scaled by ``1 / sqrt(head_dim)`` and softmaxed in f32 over the keys at or
before the query. Computed a few sequences and a block of queries at a
time, so that the scores fit.
"""
from __future__ import annotations

import torch

from .common import rms_norm, rope, scale_of

SEQS = 4       # sequences projected at a time
Q_BLOCK = 1024  # queries scored at a time


def leaves(m: dict) -> dict:
    d, h, kv, hd = m["d"], m["heads"], m["kv_heads"], m["head_dim"]
    return {"wq": ((d, h * hd), d ** -0.5),
            "wk": ((d, kv * hd), d ** -0.5),
            "wv": ((d, kv * hd), d ** -0.5),
            "wo": ((h * hd, d), (h * hd) ** -0.5),
            "norm": ((d,), 0.1)}


def causal_attention(q, k, v):
    """q ``[T, H, hd]``, k, v ``[T, KV, hd]`` -> ``[T, H, hd]``."""
    t, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)   # [H, T, hd]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    pos = torch.arange(t, device=q.device)
    for a in range(0, t, Q_BLOCK):
        b = min(a + Q_BLOCK, t)
        s = torch.matmul(q[a:b].transpose(0, 1), k[:, :b].transpose(1, 2))
        s = s * scale_of(hd)
        s.masked_fill_(pos[None, a:b, None] < pos[None, None, :b],
                       float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1),
                                v[:, :b]).transpose(0, 1)
    return out


def apply(x, p, ctx):
    m = ctx.m
    n, t, d = x.shape
    hd = m["head_dim"]
    wq, wk, wv, wo = (ctx.cast(p[k]) for k in ("wq", "wk", "wv", "wo"))
    out = torch.empty_like(x)
    for a in range(0, n, SEQS):
        h = rms_norm(x[a:a + SEQS], p["norm"], m["eps"])
        s = h.shape[0]
        q = rope(torch.matmul(h, wq).reshape(s, t, m["heads"], hd),
                 m["rope_theta"])
        k = rope(torch.matmul(h, wk).reshape(s, t, m["kv_heads"], hd),
                 m["rope_theta"])
        v = torch.matmul(h, wv).reshape(s, t, m["kv_heads"], hd)
        k, v = ctx.kv_cast(k), ctx.kv_cast(v)
        o = torch.stack([causal_attention(q[i], k[i], v[i])
                         for i in range(s)])
        out[a:a + SEQS] = torch.matmul(o.reshape(s, t, -1), wo)
    return x + out
