"""Flash attention forward as a hand-written CUDA kernel.

Causal or sliding-window GQA attention with an online softmax
(``csrc/flash_attention.cu``), the prefill attention of the serving path:
bf16 on the tensor cores (``wgmma``), f32 on the CUDA cores.
Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention``; the plain version is
:func:`repro_torch.kernels.ref.attention_ref`.

Layouts: q ``[B, H, Sq, hd]``, k/v ``[B, KV, Skv, hd]``, as the TPU kernel
takes them, with any strides over batch, head and sequence (the head dim
contiguous): the model's ``[B, S, H, hd]`` projections go in as
``x.transpose(1, 2)`` views, no copy, and the output comes back with q's
strides, in q's dtype.

Dispatch: :func:`flash_attention` runs the plain version for CPU tensors
(and on the card inside :func:`repro_torch.kernels.plain_versions`), the
kernel for CUDA tensors; there is no fallback between them.
:func:`flash_attention_launch_count` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import plain_selected
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_cuda",
           "build_flash_attention", "flash_attention_launch_count",
           "reset_flash_attention_launch_count"]

SOURCE = CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # head dims the kernel is compiled for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = [0]
_LIB = [None]


def flash_attention_launch_count() -> int:
    return _LAUNCHES[0]


def reset_flash_attention_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_flash_attention():
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _LIB[0] = load_library(SOURCE, "flash_attention_launch",
                               [p, p, p, p, i, p] + [i] * 8 + [p])
    return _LIB[0]


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, H, Sq, hd], k and v [B, KV, Skv, hd]"
                         f"; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError("q and k/v disagree in batch or head dim, or the "
                         "kv heads do not divide the query heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must share one dtype")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (f32 or bf16, head dim in
    :data:`HEAD_DIMS`, contiguous along it)."""
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (f32, bf16)")
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled (have {HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must be contiguous")
    out = torch.empty_like(q)  # q's strides when q is dense
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (q, k, v, out)):
        raise ValueError("the bf16 kernel copies 16-byte rows: q, k, v must "
                         "be 16-byte aligned with strides of multiples of 8")
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], ctypes.cast(strides, ctypes.c_void_p), B, H, KV,
        Sq, Skv, hd, int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention ``[B, H, Sq, hd]`` in q's dtype: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    _check(q, k, v, window)
    if q.device.type == "cpu" or (q.device.type == "cuda"
                                   and plain_selected()):
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
