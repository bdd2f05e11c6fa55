"""The Mamba-2 chunked SSD scan as a hand-written CUDA kernel.

Per chunk of ``Q`` steps, with ``cum`` the within-chunk cumulative sum of
``dt A``:

    CB = C . B^T                                   [Q, Q]
    y  = (CB * causal decay) . (dt x) + exp(cum) * (C . h)
    h' = exp(cum_end) h + B^T . (exp(cum_end - cum) dt x)

``csrc/ssd_scan.cu`` runs it chunk-parallel on the tensor cores, as
Mamba-2's SSD does: each chunk's state increment (one block per sequence,
chunk and group of 4 heads), a short sequential pass over the chunk states
of each (sequence, head), then each chunk's output with ``C . B^T``
computed once for a group of 8 heads (B and C are shared by the heads).
An operand computed in f32 enters the bf16 products as three bf16 parts
(as do x, B and C when they are f32), so y keeps f32 accuracy. It
replaces the Pallas TPU
kernel ``repro/kernels/ssd_scan.py:ssd_scan_kernel`` and also returns the
final state, which the prefill hands to decode (the reference takes it
from ``ssd_chunked(..., return_state=True)``).

:func:`ssd_scan_plain` computes the same chunk by chunk in PyTorch;
:func:`repro_torch.kernels.ref.ssd_ref` is the step-by-step recurrence.

Layouts: x ``[B, S, H, P]``, dt ``[B, S, H]`` f32 (softplus'ed), A
``[H]`` f32 (negative), Bm/Cm ``[B, S, N]`` in x's dtype; y in x's dtype,
the final state f32 ``[B, H, N, P]``. The wrapper zero-pads S to a
multiple of the chunk as ``ssd_chunked`` does (dt = 0 leaves the state
unchanged) and cuts y back.

Dispatch: :func:`ssd_scan` runs the plain version for CPU tensors (and on
the card inside :func:`repro_torch.kernels.plain_versions`), the kernel
for CUDA tensors; there is no fallback between them. One wrapper call
counts one launch, whatever launches the kernel makes inside it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import plain_selected
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_cuda", "build_ssd_scan",
           "ssd_scan_launch_count", "reset_ssd_scan_launch_count"]

SOURCE = CSRC / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q, _MAX_N, _MAX_P = 256, 128, 64  # chunk, state and head dims

_LAUNCHES = [0]
_LIB = [None]


def ssd_scan_launch_count() -> int:
    return _LAUNCHES[0]


def reset_ssd_scan_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_ssd_scan():
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB[0] = load_library(SOURCE, "ssd_scan_launch",
                               [p] * 10 + [i] * 7 + [p])
    return _LIB[0]


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() != 4 or dt.shape != x.shape[:3] or A.shape != x.shape[2:3]:
        raise ValueError("x must be [B, S, H, P], dt [B, S, H] and A [H]; "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != x.shape[:2] or Cm.shape != Bm.shape:
        raise ValueError("Bm and Cm must be [B, S, N]; got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")


def ssd_scan_plain(x, dt, A, Bm, Cm, chunk: int):
    """The kernel's arithmetic in PyTorch, chunk by chunk (S a multiple of
    ``chunk``), every (sequence, head) at once: ``(y in x's dtype, final
    state f32 [B, H, N, P])``. The decay is selected with ``where`` where
    ``t >= s`` (above the diagonal ``cum_t - cum_s > 0`` can overflow)."""
    f = torch.float32
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    xf, dtf, Af = x.to(f), dt.to(f), A.to(f)
    Bf, Cf = Bm.to(f), Cm.to(f)
    h = torch.zeros((Bsz, H, N, P), dtype=f, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        xc = xf[:, sl].permute(0, 2, 1, 3)                  # [B, H, Q, P]
        dtc = dtf[:, sl].permute(0, 2, 1)                   # [B, H, Q]
        Bc, Cc = Bf[:, sl], Cf[:, sl]                       # [B, Q, N]
        cum = torch.cumsum(dtc * Af[None, :, None], dim=-1)
        cb = Cc @ Bc.transpose(1, 2)                        # [B, Q, Q]
        diff = cum[..., :, None] - cum[..., None, :]        # [B, H, Q, Q]
        decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        y_diag = (cb[:, None] * decay) @ (dtc[..., None] * xc)
        y_off = (Cc[:, None] * torch.exp(cum)[..., None]) @ h
        y[:, sl] = (y_diag + y_off).permute(0, 2, 1, 3).to(x.dtype)
        edge = torch.exp(cum[..., -1:] - cum) * dtc         # [B, H, Q]
        h = h * torch.exp(cum[..., -1])[..., None, None] + (
            Bc[:, None] * edge[..., None]).transpose(-1, -2) @ xc
    return y, h


def ssd_scan_cuda(x, dt, A, Bm, Cm, chunk: int):
    """Launch the kernel on CUDA tensors (x, Bm, Cm f32 or bf16 and of one
    dtype; S a multiple of ``chunk``, the chunk at most 256, N at most 128
    and P at most 64, both multiples of 8): ``(y, final state)``."""
    _check(x, dt, A, Bm, Cm)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in _DTYPES or not x.dtype == Bm.dtype == Cm.dtype:
        raise ValueError("x, Bm and Cm must share one dtype, f32 or bf16")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (S % chunk or chunk > _MAX_Q or N > _MAX_N or N % 8 or P > _MAX_P
            or P % 8):
        raise ValueError(f"S {S} must be a multiple of the chunk {chunk} "
                         f"(at most {_MAX_Q}), N {N} at most {_MAX_N} and P "
                         f"{P} at most {_MAX_P}, both multiples of 8")
    # The kernel loads 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied.
    xc, bc, cc = (t.contiguous() if t.is_contiguous() and
                  t.data_ptr() % 16 == 0 else t.contiguous().clone()
                  for t in (x, Bm, Cm))
    dtc = dt.to(device=dev, dtype=torch.float32).contiguous()
    ac = A.to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty_like(xc)
    h = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
    # Each chunk's state increment, then the state entering it; each
    # chunk's cum_end, and its cumulative sums of dt A (f64, the chunk
    # padded to a multiple of 16 steps).
    states = torch.empty((Bsz, S // chunk, H, N, P), dtype=torch.float32,
                         device=dev)
    cum_end = torch.empty((Bsz, S // chunk, H), dtype=torch.float32,
                          device=dev)
    cum = torch.empty((Bsz, S // chunk, H, -(-chunk // 16) * 16),
                      dtype=torch.float64, device=dev)
    lib = _library()
    err = lib.ssd_scan_launch(
        xc.data_ptr(), dtc.data_ptr(), ac.data_ptr(), bc.data_ptr(),
        cc.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
        cum_end.data_ptr(), cum.data_ptr(), _DTYPES[x.dtype], Bsz, S, H, P,
        N, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return y, h


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """SSD scan ``(y [B, S, H, P] in x's dtype, final state f32 [B, H, N,
    P])`` with chunks of ``min(chunk, S)``: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    _check(x, dt, A, Bm, Cm)
    S0 = x.shape[1]
    Q = min(chunk, S0)
    pad = (-S0) % Q
    if pad:  # zero tail: dt = 0 leaves states and outputs unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    dev = x.device
    if dev.type == "cpu" or (dev.type == "cuda" and plain_selected()):
        y, h = ssd_scan_plain(x, dt, A, Bm, Cm, Q)
    elif dev.type == "cuda":
        y, h = ssd_scan_cuda(x, dt, A, Bm, Cm, Q)
    else:
        raise ValueError(f"no SSD-scan path for device {dev}")
    return (y[:, :S0] if pad else y), h
