"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) on one card.

The prefill form runs the chunked SSD scan through
:func:`repro_torch.kernels.ssd_scan.ssd_scan` (the hand kernel on the card,
its plain version on the CPU), which also returns the state after the
last step; the decode form is the O(1) state update in plain PyTorch, as
the reference computes it outside any Pallas kernel. Numerics as the
reference's ``repro/models/ssd.py``: projections in the model's dtype with
f32 accumulation, the scan and the gating in f32, the prefill's causal
convolution rounded to the model's dtype, the decode step's kept in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ssd_scan as ks
from repro_torch.kernels.ref import softplus
from repro_torch.models.layers import causal_conv1d, dense, rms_norm

__all__ = ["ssd_block", "ssd_block_step"]

_F32 = torch.float32


def _gate_out(y, xh, z, p, x_dtype):
    """The skip term, the SiLU gate, the grouped norm and the output
    projection, shared by both forms. y/xh f32 ``[..., H, P]``."""
    y = y + p["D"].to(_F32)[:, None] * xh
    y = y.reshape(y.shape[:-2] + (-1,))
    y = (y * F.silu(z.to(_F32))).to(x_dtype)
    y = rms_norm(y, p["norm_g"], 1e-6)
    return dense(y, p["w_out"])


def ssd_block(x: torch.Tensor, p: dict, cfg: SSMConfig, *,
              capture: bool = False):
    """The Mamba-2 block over a sequence, x ``[B, S, d]``: ``(out,
    state)``; with ``capture``, ``state`` is the decode continuation
    ``{"h": [B, H, N, P] f32, "conv": [B, K-1, di + 2N]}``, else None."""
    Bsz, S, _ = x.shape
    z = dense(x, p["w_z"])
    xin_pre = dense(x, p["w_x"])
    bc = dense(x, p["w_bc"])
    dt_raw = dense(x, p["w_dt"])
    N, P = cfg.state_dim, cfg.head_dim
    xin = causal_conv1d(xin_pre, p["conv_x"])
    Bm = causal_conv1d(bc[..., :N], p["conv_b"])
    Cm = causal_conv1d(bc[..., N:], p["conv_c"])
    H = p["A_log"].shape[0]
    xh = xin.reshape(Bsz, S, H, P)
    dt = softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))
    A = -torch.exp(p["A_log"].to(_F32))
    y, h_last = ks.ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.chunk)
    out = _gate_out(y.to(_F32), xh.to(_F32), z, p, x.dtype)
    if not capture:
        return out, None
    K = p["conv_x"].shape[0]
    feats = torch.cat([xin_pre, bc], dim=-1)  # the convolution's inputs
    return out, {"h": h_last, "conv": feats[:, -(K - 1):]}


def ssd_block_step(x: torch.Tensor, state: dict, p: dict, cfg: SSMConfig):
    """One decode step, x ``[B, d]``, from ``state`` (:func:`ssd_block`'s
    layout): ``(out [B, d], new state)``."""
    Bsz, _ = x.shape
    z = dense(x, p["w_z"])
    xin = dense(x, p["w_x"])
    bc = dense(x, p["w_bc"])
    dt_raw = dense(x, p["w_dt"])
    N, P = cfg.state_dim, cfg.head_dim
    feats = torch.cat([xin, bc], dim=-1)
    window = torch.cat([state["conv"], feats[:, None]], dim=1)  # [B, K, F]
    kernel = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=1)
    conv = torch.einsum("bkf,kf->bf", window.to(_F32), kernel.to(_F32))
    di = xin.shape[-1]
    H = p["A_log"].shape[0]
    xh = conv[:, :di].reshape(Bsz, H, P)
    Bm, Cm = conv[:, di:di + N], conv[:, di + N:]
    dt = softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))      # [B, H]
    A = -torch.exp(p["A_log"].to(_F32))
    decay = torch.exp(dt * A)
    dbx = torch.einsum("bn,bhp->bhnp", Bm, dt[..., None] * xh)
    h = state["h"] * decay[..., None, None] + dbx
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    out = _gate_out(y, xh, z, p, x.dtype)
    return out, {"h": h, "conv": window[:, 1:]}
