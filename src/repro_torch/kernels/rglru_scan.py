"""The RG-LRU scan with its gates as a hand-written CUDA kernel.

``csrc/rglru_scan.cu`` runs ``h_t = a_t h_{t-1} + b_t`` along the
sequence for each (sequence, channel), with the gates computed in the
same pass from ``u`` and five per-channel vectors (f32 inside):

    r, i  = sigmoid(u w_a + b_a), sigmoid(u w_x + b_x)
    log a = -8 softplus(lam) r,   b = sqrt(max(1 - a^2, 1e-12)) i u

so the card reads ``u`` once and writes ``h`` once. It replaces the
Pallas TPU kernel ``repro/kernels/rglru_scan.py:rglru_scan_kernel``. The
kernel splits the sequence into chunks of 128 steps and runs
persistent blocks over (sequence, 64 channels, chunk) items: a block
computes an item's gates once and keeps them in shared memory, composes
the chunk into ``(prod a, h from 0)``, takes the carry from the chunks
before it by a decoupled look-back, and runs its steps from that carry
(emulated on the CPU in ``tests/test_torch_reuse_rglru_redesign.py``).

Layouts: u ``[B, S, W]`` (f32 or bf16), the vectors ``[W]`` in any
float dtype; h ``[B, S, W]`` in u's dtype.

Dispatch: :func:`rglru_scan` runs the plain version for CPU tensors (and
on the card inside :func:`repro_torch.kernels.plain_versions`), the
kernel for CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import refuse_autograd, use_plain
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import softplus

__all__ = ["rglru_gates", "rglru_scan", "rglru_scan_plain",
           "rglru_scan_cuda", "build_rglru_scan", "rglru_scan_launch_count",
           "reset_rglru_scan_launch_count"]

SOURCE = CSRC / "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = [0]
_LIB = [None]


def rglru_scan_launch_count() -> int:
    return _LAUNCHES[0]


def reset_rglru_scan_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_rglru_scan():
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib = load_library(SOURCE, "rglru_scan_launch",
                           [p, p, p, p, i, i, i, i, p])
        lib.rglru_scan_workspace_bytes.argtypes = [i, i, i]
        lib.rglru_scan_workspace_bytes.restype = ctypes.c_longlong
        _LIB[0] = lib
    return _LIB[0]


def _check(u, vecs) -> None:
    if u.dim() != 3 or any(v.shape != u.shape[2:] for v in vecs):
        raise ValueError("u must be [B, S, W] and w_a, b_a, w_x, b_x, lam "
                         f"[W]; got {tuple(u.shape)}, "
                         f"{[tuple(v.shape) for v in vecs]}")


def rglru_gates(u, w_a, b_a, w_x, b_x, lam):
    """The gates in f32, ``(a, b)`` of ``h_t = a h_{t-1} + b``, for u of
    any shape ending in W (the decode step uses them too)."""
    f = torch.float32
    uf = u.to(f)
    r = torch.sigmoid(uf * w_a.to(f) + b_a.to(f))
    i = torch.sigmoid(uf * w_x.to(f) + b_x.to(f))
    log_a = (-8.0 * softplus(lam.to(f))) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * uf)
    return a, b


def rglru_scan_plain(u, w_a, b_a, w_x, b_x, lam) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``h [B, S, W]`` in u's dtype,
    the carry in f32."""
    a, b = rglru_gates(u, w_a, b_a, w_x, b_x, lam)
    h = torch.zeros_like(a[:, 0])
    out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
    for t in range(u.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h.to(u.dtype)
    return out


def rglru_scan_cuda(u, w_a, b_a, w_x, b_x, lam) -> torch.Tensor:
    """Launch the kernel on a CUDA ``u`` (f32 or bf16)."""
    vecs = (w_a, b_a, w_x, b_x, lam)
    _check(u, vecs)
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs a CUDA u, got {dev}")
    if u.dtype not in _DTYPES:
        raise ValueError(f"dtype {u.dtype} not supported (f32, bf16)")
    B, S, W = u.shape
    uc = u.contiguous()
    # The five vectors, f32, side by side: [5, W].
    params = torch.stack([v.to(device=dev, dtype=torch.float32)
                          for v in vecs])
    h = torch.empty_like(uc)
    lib = _library()
    work = torch.empty(lib.rglru_scan_workspace_bytes(B, S, W),
                       dtype=torch.uint8, device=dev)
    err = lib.rglru_scan_launch(
        uc.data_ptr(), params.data_ptr(), h.data_ptr(), work.data_ptr(),
        _DTYPES[u.dtype], B, S, W, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return h


def rglru_scan(u, w_a, b_a, w_x, b_x, lam) -> torch.Tensor:
    """RG-LRU ``h [B, S, W]`` in u's dtype: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    _check(u, (w_a, b_a, w_x, b_x, lam))
    refuse_autograd("rglru_scan", u, w_a, b_a, w_x, b_x, lam)
    dev = u.device
    if use_plain(dev):
        return rglru_scan_plain(u, w_a, b_a, w_x, b_x, lam)
    if dev.type != "cuda":
        raise ValueError(f"no RG-LRU-scan path for device {dev}")
    return rglru_scan_cuda(u, w_a, b_a, w_x, b_x, lam)
