"""Tier data movement as a hand-written CUDA kernel: batched page copies
between pools, in place.

``dst[dst_idx[i]] = src[src_idx[i]]`` for every pair where neither index
is ``-1`` (``csrc/page_copy.cu``): the serving engine's prefill population,
write-back of dirty pages on eviction, and promotion. Replaces the Pallas
TPU kernel ``repro/kernels/page_gather.py:page_copy``; the plain version is
:func:`repro_torch.kernels.ref.page_copy_ref`.

``dst`` and ``src`` are ``[rows, ...]`` with any row stride and each row
contiguous and of one byte size: one layer of a ``[slots, layers, ...]``
pool (``pool[:, li]``) has rows of one layer's page, the pool itself has
rows of whole slots. Destinations must be unique (pairs run in no order).

Dispatch: :func:`page_copy` runs the plain version for CPU tensors (and on
the card inside :func:`repro_torch.kernels.plain_versions`), the kernel for
CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import plain_selected
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import page_copy_ref

__all__ = ["page_copy", "page_copy_cuda", "build_page_copy",
           "page_copy_launch_count", "reset_page_copy_launch_count"]

SOURCE = CSRC / "page_copy.cu"

_LAUNCHES = [0]
_LIB = [None]


def page_copy_launch_count() -> int:
    return _LAUNCHES[0]


def reset_page_copy_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_page_copy():
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _LIB[0] = load_library(SOURCE, "page_copy_launch",
                               [p, p, p, p, i, ll, ll, ll, i, i, p])
    return _LIB[0]


def _check(dst, src, dst_idx, src_idx) -> None:
    if dst.dtype != src.dtype or dst[0].numel() != src[0].numel():
        raise ValueError("dst and src rows must share dtype and size; got "
                         f"{dst.dtype}{list(dst.shape)}, "
                         f"{src.dtype}{list(src.shape)}")
    if dst_idx.shape != src_idx.shape or dst_idx.dim() != 1:
        raise ValueError("dst_idx and src_idx must be [N] alike")
    for idx, t, name in ((dst_idx, dst, "dst"), (src_idx, src, "src")):
        if idx.device.type == "cpu" and idx.numel() and (
                int(idx.min()) < -1 or int(idx.max()) >= t.shape[0]):
            raise IndexError(f"{name}_idx out of [-1, {t.shape[0]})")


def page_copy_cuda(dst: torch.Tensor, src: torch.Tensor,
                   dst_idx: torch.Tensor, src_idx: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the kernel on CUDA ``dst``/``src``; the index vectors are
    moved to the card if they are not there (on the card, an index out of
    range skips its pair). Returns ``dst``."""
    _check(dst, src, dst_idx, src_idx)
    dev = dst.device
    if dev.type != "cuda" or src.device != dev:
        raise ValueError(f"page_copy_cuda needs dst and src on one card, got "
                         f"{dev}, {src.device}")
    if not (dst[0].is_contiguous() and src[0].is_contiguous()):
        raise ValueError("each row of dst and src must be contiguous")
    n = dst_idx.numel()
    if n == 0:
        return dst
    di = dst_idx.to(device=dev, dtype=torch.int32).contiguous()
    si = src_idx.to(device=dev, dtype=torch.int32).contiguous()
    item = dst.element_size()
    lib = _library()
    err = lib.page_copy_launch(
        dst.data_ptr(), src.data_ptr(), di.data_ptr(), si.data_ptr(), n,
        dst[0].numel() * item, dst.stride(0) * item, src.stride(0) * item,
        dst.shape[0], src.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return dst


def page_copy(dst: torch.Tensor, src: torch.Tensor, dst_idx: torch.Tensor,
              src_idx: torch.Tensor) -> torch.Tensor:
    """``dst[dst_idx[i]] = src[src_idx[i]]`` in place for the live pairs:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    _check(dst, src, dst_idx, src_idx)
    dev = dst.device
    if dev.type == "cpu" or (dev.type == "cuda" and plain_selected()):
        return page_copy_ref(dst, src, dst_idx, src_idx)
    if dev.type != "cuda":
        raise ValueError(f"no page-copy path for device {dev}")
    return page_copy_cuda(dst, src, dst_idx, src_idx)
