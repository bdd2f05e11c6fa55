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
rows of whole slots. Destinations must be unique and must not overlap the
source rows (pairs run in no order).

The kernel walks a flat list of items, each a chunk of one pair's row, with
a persistent grid of a few blocks an SM; :func:`copy_plan` picks its path
(16-byte vectors in registers, or bytes), its chunk and its grid. The wrapper makes no
host synchronization: index vectors on the CPU go to the card through
pinned memory without blocking (:func:`card_index`), int32 vectors on the
card are used as they are, and an index out of range on the card skips
its pair (on the CPU it raises ``IndexError``).

Dispatch: :func:`page_copy` runs the plain version for CPU tensors (and on
the card inside :func:`repro_torch.kernels.plain_versions`), the kernel for
CUDA tensors; there is no fallback between them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import refuse_autograd, use_plain
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import page_copy_ref

__all__ = ["page_copy", "page_copy_cuda", "build_page_copy", "copy_plan",
           "CopyPlan", "card_index", "page_copy_launch_count",
           "reset_page_copy_launch_count"]

SOURCE = CSRC / "page_copy.cu"

# The kernel's paths, in the order of ``csrc/page_copy.cu``'s ``Path``, and
# its constants: the threads a block, the 16-byte loads a thread keeps in
# flight on the vector path, the largest chunk (a vector block's loads) and
# the blocks an SM at most.
PATHS = ("bytes", "vector")
THREADS = 128
UNROLL = 8
CHUNK = THREADS * UNROLL * 16
BLOCKS_PER_SM = 8

_LAUNCHES = [0]
_LIB = [None]
_SMS: dict = {}


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
                               [p, p, p, p, ll, ll, ll, ll, i, i, i, ll, i,
                                p])
    return _LIB[0]


class CopyPlan(NamedTuple):
    """A launch's work split: ``path`` (one of :data:`PATHS`); items of
    ``chunk`` bytes, ``chunks`` a row (the last one ragged), walked by
    ``blocks`` blocks of :data:`THREADS` with a grid-stride loop."""
    path: str
    chunk: int
    chunks: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def copy_plan(n: int, row_bytes: int, align: int, sms: int) -> CopyPlan:
    """The kernel's plan for ``n`` pairs of ``row_bytes``-byte rows;
    ``align`` is the OR of the two base addresses and row strides in bytes
    and ``sms`` the card's SM count. Rows that keep every address a
    multiple of 16 bytes take 16-byte vectors, other rows bytes, in chunks
    of at most :data:`CHUNK` bytes cut evenly from the row."""
    path = "vector" if (align | row_bytes) % 16 == 0 else "bytes"
    pieces = _cdiv(row_bytes, CHUNK)  # the fewest chunks of <= CHUNK
    chunk = min(row_bytes, 16 * _cdiv(_cdiv(row_bytes, pieces), 16))
    chunks = _cdiv(row_bytes, chunk)
    blocks = max(1, min(n * chunks, BLOCKS_PER_SM * sms))
    return CopyPlan(path, chunk, chunks, blocks)


def card_index(device, *idx: torch.Tensor) -> tuple:
    """The index vectors ``idx`` as contiguous int32 vectors on the card
    ``device``, with no host synchronization: the CPU ones go together
    through one buffer of pinned memory from PyTorch's caching host
    allocator (which reuses a block only once the copy that read it has
    completed) and one copy that does not block; the ones on the card are
    converted there (int32 contiguous ones are used as they are). On a CPU
    ``device`` they are returned unchanged."""
    device = torch.device(device)
    if device.type != "cuda":
        return idx
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out, host = list(idx), []
    for i, x in enumerate(idx):
        if x.device.type == "cpu":
            host.append(i)
        elif not (x.device == device and x.dtype == torch.int32
                  and x.is_contiguous()):
            out[i] = x.to(device=device, dtype=torch.int32).contiguous()
    if host:
        sizes = [idx[i].numel() for i in host]
        buf = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
        for i, part in zip(host, buf.split(sizes)):
            part.copy_(idx[i].reshape(-1))
        card = buf.to(device, non_blocking=True)
        for i, part in zip(host, card.split(sizes)):
            out[i] = part
    return tuple(out)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _check(dst, src, dst_idx, src_idx) -> None:
    if dst.dtype != src.dtype or dst.shape[1:].numel() != \
            src.shape[1:].numel():
        raise ValueError("dst and src rows must share dtype and size; got "
                         f"{dst.dtype}{list(dst.shape)}, "
                         f"{src.dtype}{list(src.shape)}")
    if dst_idx.shape != src_idx.shape or dst_idx.dim() != 1:
        raise ValueError("dst_idx and src_idx must be [N] alike")
    for idx, t, name in ((dst_idx, dst, "dst"), (src_idx, src, "src")):
        if idx.device.type == "cpu" and idx.numel():
            lo, hi = torch.aminmax(idx)
            if int(lo) < -1 or int(hi) >= t.shape[0]:
                raise IndexError(f"{name}_idx out of [-1, {t.shape[0]})")


def _launch(dst, src, dst_idx, src_idx) -> torch.Tensor:
    dev = dst.device
    if dev.type != "cuda" or src.device != dev:
        raise ValueError(f"page_copy_cuda needs dst and src on one card, got "
                         f"{dev}, {src.device}")
    if not (dst[0].is_contiguous() and src[0].is_contiguous()):
        raise ValueError("each row of dst and src must be contiguous")
    n = dst_idx.numel()
    if n == 0:
        return dst
    di, si = card_index(dev, dst_idx, src_idx)
    item = dst.element_size()
    row_bytes = dst.shape[1:].numel() * item
    d_stride, s_stride = dst.stride(0) * item, src.stride(0) * item
    plan = copy_plan(n, row_bytes, dst.data_ptr() | src.data_ptr()
                     | d_stride | s_stride, _sm_count(dev))
    lib = _library()
    err = lib.page_copy_launch(
        dst.data_ptr(), src.data_ptr(), di.data_ptr(), si.data_ptr(), n,
        row_bytes, d_stride, s_stride, dst.shape[0], src.shape[0],
        PATHS.index(plan.path), plan.chunk, plan.blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return dst


def page_copy_cuda(dst: torch.Tensor, src: torch.Tensor,
                   dst_idx: torch.Tensor, src_idx: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the kernel on CUDA ``dst``/``src``; the index vectors may lie
    on the CPU or on the card (on the card, an index out of range skips its
    pair). Returns ``dst``."""
    _check(dst, src, dst_idx, src_idx)
    return _launch(dst, src, dst_idx, src_idx)


def page_copy(dst: torch.Tensor, src: torch.Tensor, dst_idx: torch.Tensor,
              src_idx: torch.Tensor) -> torch.Tensor:
    """``dst[dst_idx[i]] = src[src_idx[i]]`` in place for the live pairs:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    _check(dst, src, dst_idx, src_idx)
    refuse_autograd("page_copy", dst, src)
    dev = dst.device
    if use_plain(dev):
        return page_copy_ref(dst, src, dst_idx, src_idx)
    if dev.type != "cuda":
        raise ValueError(f"no page-copy path for device {dev}")
    return _launch(dst, src, dst_idx, src_idx)
