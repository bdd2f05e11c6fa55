"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) on one card.

The prefill form runs the chunked SSD scan through
:func:`repro_torch.kernels.ssd_scan.ssd_scan` (the hand kernel on the card,
its plain version on the CPU), which also returns the state after the
last step; the training form runs :func:`ssd_chunked`, the reference's
``ssd_chunked`` in PyTorch under autograd (the reference trains through
it, not through its Pallas kernel); the decode form is the O(1) state
update in plain PyTorch, as the reference computes it outside any Pallas
kernel. Numerics as the reference's ``repro/models/ssd.py``: projections
in the model's dtype with f32 accumulation, the scan and the gating in
f32, the prefill's causal convolution rounded to the model's dtype, the
decode step's kept in f32.

Under a model axis the heads and the inner width are this rank's block
(``B`` / ``C`` replicated), the grouped norm's sum of squares is summed
over the axis, and the output projection is a TP partial sum, as the
reference's. Under autograd the block input enters the split
projections, and ``B`` / ``C`` the scan, through ``Axes.enter``: their
gradients are summed over the axis, where the reference's vma types
place those sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.kernels import ssd_scan as ks
from repro_torch.kernels.ref import softplus
from repro_torch.models.layers import (causal_conv1d, dense, rms_norm,
                                       rms_norm_tp, tp_out)

__all__ = ["ssd_chunked", "ssd_block", "ssd_block_step"]

_F32 = torch.float32


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int):
    """The chunked SSD scan under autograd, as the reference's
    ``ssd_chunked``: ``(y [B, S, H, P] in x's dtype, final state f32 [B, H,
    N, P])`` for x ``[B, S, H, P]``, dt ``[B, S, H]`` (softplus'ed), A
    ``[H]`` (negative), Bm/Cm ``[B, S, N]``, in chunks of ``min(chunk,
    S)`` (S zero-padded to a multiple: dt = 0 leaves the state unchanged).

    The same f32 terms: within each chunk ``(C . B^T * decay) . (dt x)``,
    each chunk's state increment ``B^T . (exp(cum_end - cum) dt x)``, the
    states carried across chunks, and ``exp(cum) C . h`` from the state
    entering the chunk. Two differences: the first leaves the forward's
    value as it was, the second only the order of its f32 sums:

    - the decay ``exp(cum_t - cum_s)`` is taken of the exponent selected
      to 0 above the diagonal, where the reference takes it of the whole
      chunk and selects after. Above the diagonal the exponent is a sum of
      ``|dt A|``, which at mamba2's chunk of 256 passes f32's ``exp``
      limit, and the reference's selection then back-propagates ``0 *
      inf = NaN`` (fault (l));
    - the reference's four-operand contraction is taken in pairs, so no
      ``[B, nc, Q, Q, H, P]`` product is formed (17 GB at mamba2's width
      and 2 x 4,096 tokens), and the carry over the ``nc`` chunk states is
      a loop, not an associative scan (it sums in another order).
    """
    f = torch.float32
    Bsz, S0, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S0)
    pad = (-S0) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    # Heads before steps: [B, nc, H, Q, ...].
    xf = x.to(f).reshape(Bsz, nc, Q, H, P).transpose(2, 3)
    dtf = dt.to(f).reshape(Bsz, nc, Q, H).transpose(2, 3)
    Bf = Bm.to(f).reshape(Bsz, nc, Q, N)
    Cf = Cm.to(f).reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dtf * A.to(f)[:, None], dim=-1)          # [B,nc,H,Q]
    dx = dtf[..., None] * xf                                     # [B,nc,H,Q,P]

    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]                 # [B,nc,H,Q,Q]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    cb = Cf @ Bf.transpose(-1, -2)                               # [B,nc,Q,Q]
    y_diag = (cb[:, :, None] * decay) @ dx                       # [B,nc,H,Q,P]

    edge = torch.exp(cum[..., -1:] - cum)                        # [B,nc,H,Q]
    states = Bf[:, :, None].transpose(-1, -2) @ (edge[..., None] * dx)
    chunk_decay = torch.exp(cum[..., -1])                        # [B,nc,H]
    h = torch.zeros((Bsz, H, N, P), dtype=f, device=x.device)
    h_prev = []                                                  # entering
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,H,N,P]
    y_off = torch.exp(cum)[..., None] * (Cf[:, :, None] @ h_prev)
    y = (y_diag + y_off).transpose(2, 3).reshape(Bsz, nc * Q, H, P)
    return y[:, :S0].to(x.dtype), h


def _gate_out(y, xh, z, p, x_dtype, ax: Axes, full_width: int):
    """The skip term, the SiLU gate, the grouped norm and the output
    projection, shared by both forms. y/xh f32 ``[..., H, P]``;
    ``full_width`` is the unsharded inner width."""
    y = y + p["D"].to(_F32)[:, None] * xh
    y = y.reshape(y.shape[:-2] + (-1,))
    y = (y * F.silu(z.to(_F32))).to(x_dtype)
    if ax.model is None:
        return dense(rms_norm(y, p["norm_g"], 1e-6), p["w_out"])
    y = rms_norm_tp(y, p["norm_g"], 1e-6, ax, full_width)
    return tp_out(y, p["w_out"], ax)


def ssd_block(x: torch.Tensor, p: dict, cfg: SSMConfig, *,
              capture: bool = False, scan=None, ax: Axes = SINGLE):
    """The Mamba-2 block over a sequence, x ``[B, S, d]``: ``(out,
    state)``; with ``capture``, ``state`` is the decode continuation
    ``{"h": [B, H, N, P] f32, "conv": [B, K-1, di + 2N]}``, else None.
    ``scan`` is the chunked scan: :func:`ssd_chunked` for training, or by
    default the kernel's dispatcher (the prefill's), looked up at the call
    (so that a caller may replace it on its module)."""
    Bsz, S, _ = x.shape
    tp = (ax.model,)
    xs = ax.enter(x, tp)
    z = dense(xs, p["w_z"])
    xin_pre = dense(xs, p["w_x"])
    bc = dense(x, p["w_bc"])
    dt_raw = dense(xs, p["w_dt"])
    N, P = cfg.state_dim, cfg.head_dim
    xin = causal_conv1d(xin_pre, p["conv_x"])
    Bm = ax.enter(causal_conv1d(bc[..., :N], p["conv_b"]), tp)
    Cm = ax.enter(causal_conv1d(bc[..., N:], p["conv_c"]), tp)
    H = p["A_log"].shape[0]
    xh = xin.reshape(Bsz, S, H, P)
    dt = softplus(dt_raw.to(_F32) + p["dt_bias"].to(_F32))
    A = -torch.exp(p["A_log"].to(_F32))
    y, h_last = (scan or ks.ssd_scan)(xh, dt, A, Bm, Cm, chunk=cfg.chunk)
    out = _gate_out(y.to(_F32), xh.to(_F32), z, p, x.dtype, ax,
                    cfg.expand * x.shape[-1])
    if not capture:
        return out, None
    K = p["conv_x"].shape[0]
    feats = torch.cat([xin_pre, bc], dim=-1)  # the convolution's inputs
    return out, {"h": h_last, "conv": feats[:, -(K - 1):]}


def ssd_block_step(x: torch.Tensor, state: dict, p: dict, cfg: SSMConfig,
                   ax: Axes = SINGLE):
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
    out = _gate_out(y, xh, z, p, x.dtype, ax, cfg.expand * x.shape[-1])
    return out, {"h": h, "conv": window[:, 1:]}
