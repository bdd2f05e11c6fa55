"""Pre-norm dense SwiGLU feed-forward: ``(silu(h W_gate) * (h W_up))
W_down``, in blocks of rows."""
from __future__ import annotations

import torch

from .common import rms_norm

ROWS = 16384  # tokens at a time


def leaves(m: dict) -> dict:
    d, f = m["d"], m["d_ff"]
    return {"w_gate": ((d, f), d ** -0.5), "w_up": ((d, f), d ** -0.5),
            "w_down": ((f, d), f ** -0.5), "norm2": ((d,), 0.1)}


def swiglu_rows(h, wg, wu, wd):
    out = torch.empty_like(h)
    for a in range(0, h.shape[0], ROWS):
        r = h[a:a + ROWS]
        out[a:a + ROWS] = torch.matmul(
            torch.nn.functional.silu(torch.matmul(r, wg))
            * torch.matmul(r, wu), wd)
    return out


def apply(x, p, ctx):
    h = rms_norm(x, p["norm2"], ctx.m["eps"])
    wg, wu, wd = (ctx.cast(p[k]) for k in ("w_gate", "w_up", "w_down"))
    return x + swiglu_rows(h.reshape(-1, x.shape[-1]), wg, wu,
                           wd).reshape(x.shape)
