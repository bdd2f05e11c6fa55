"""Reuse distances (Mattson LRU stack distances) as a hand-written CUDA kernel.

Per request, the number of *distinct* keys touched since that key's last
access: under fully-associative LRU of capacity ``C`` a request hits iff
its reuse distance ``d < C``, so one pass over the stream yields exact
hit/miss counters for every cache size at once (:mod:`repro_torch.sim.mrc`
builds the counters; this module computes ``d``).

The distance is a 2-D dominance count over the host-computed
previous-occurrence index ``P`` (``P[j]`` = column of the previous access
of ``pages[j]`` within its row, ``-1`` for a first access):

    d_j = #{ k : P[j] < k < j  and  P[k] <= P[j]  and  valid[k] }

Replaces the Pallas TPU kernel ``repro/kernels/reuse_distance.py:
reuse_distance_kernel`` (body ``_dominance_kernel``), a ``[block, block]``
broadcast compare per ``(row, query block)`` grid cell. On Hopper
(``csrc/reuse_distance.cu``) the count takes O(L log L) per row:

    F_j  = #{ k < j : valid[k], P[k] <= P[j] }
    G(x) = #{ k : valid[k], max(k, P[k]) <= x }
    d_j  = F_j - G(P[j])          (0 <= P[j] < j; 0 where P[j] >= j)

``G`` is a histogram and its prefix sum; ``F`` is the count a merge sort
of the row by ``(P[k], k)`` gives on the way (pads keyed above every
``P``), its first 11 levels in shared memory on tiles of 2,048 positions,
the rest as merge passes through device memory, each row cut at its last
valid position. What bounds it is the bytes of those passes. The
arithmetic is emulated step by step on the CPU in
``tests/test_torch_reuse_rglru_redesign.py``.

Dispatch: :func:`reuse_distances` takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.reuse_distance_ref`) for tensors on the
CPU and launches the kernel for CUDA tensors; there is no fallback between
them. :func:`reuse_compile_count` counts kernel launches (the reference's
counter of compiles, kept under its name).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import DIST_INF, reuse_distance_ref

__all__ = [
    "DIST_INF",
    "prev_occurrence",
    "reuse_distance_cuda",
    "reuse_distances",
    "build_reuse_distance",
    "reuse_compile_count",
    "reset_reuse_compile_count",
]

SOURCE = CSRC / "reuse_distance.cu"

_LAUNCHES = [0]
_LIB = [None]


def reuse_compile_count() -> int:
    """Number of reuse-distance kernel launches so far."""
    return _LAUNCHES[0]


def reset_reuse_compile_count() -> None:
    _LAUNCHES[0] = 0


def build_reuse_distance():
    """Compile ``csrc/reuse_distance.cu`` (once per source content) and
    return the library's path."""
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib = load_library(SOURCE, "reuse_distance_launch",
                           [p, p, p, p, i, i, p])
        lib.reuse_distance_workspace_bytes.argtypes = [i, i]
        lib.reuse_distance_workspace_bytes.restype = ctypes.c_longlong
        _LIB[0] = lib
    return _LIB[0]


def prev_occurrence(sh_pages: np.ndarray, counts: np.ndarray):
    """Previous-occurrence index per request, host-side.

    ``sh_pages`` is the ``[S, L]`` partitioned key stream (per-shard
    substreams, padded at the row tails); ``counts[s]`` is the number of
    real requests in row ``s``. Returns ``(prev, valid)``: int32 ``[S, L]``
    with ``prev[s, j]`` = column of the previous access of ``sh_pages[s,
    j]`` within row ``s`` (``-1`` if first access), and the bool ``[S, L]``
    real-position mask. Pads carry ``prev = -1`` and ``valid = False`` and
    never link to (or from) real positions; rows are fully independent.

    One vectorized lexsort over ``(shard, page, position)`` — O(T log T).
    """
    sh_pages = np.asarray(sh_pages)
    counts = np.asarray(counts)
    S, L = sh_pages.shape
    valid = np.arange(L)[None, :] < counts[:, None]
    shard = np.repeat(np.arange(S, dtype=np.int64), L)
    page = sh_pages.reshape(-1).astype(np.int64)
    pos = np.tile(np.arange(L, dtype=np.int64), S)
    idx = np.flatnonzero(valid.reshape(-1))
    order = idx[np.lexsort((pos[idx], page[idx], shard[idx]))]
    prev = np.full(S * L, -1, np.int64)
    if order.size > 1:
        same = (shard[order[1:]] == shard[order[:-1]]) & (
            page[order[1:]] == page[order[:-1]]
        )
        prev[order[1:][same]] = pos[order[:-1][same]]
    return prev.reshape(S, L).astype(np.int32), valid


def _check(prev: torch.Tensor, valid: torch.Tensor) -> None:
    if prev.dim() != 2 or valid.shape != prev.shape:
        raise ValueError("prev and valid must be [S, L] alike, got "
                         f"{tuple(prev.shape)}, {tuple(valid.shape)}")
    if prev.device != valid.device:
        raise ValueError("prev and valid must share one device")


def reuse_distance_cuda(prev: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``[S, L]`` CUDA tensors: int32 reuse distances
    (:data:`DIST_INF` for first accesses, ``-1`` at pads), the integers of
    :func:`~repro_torch.kernels.ref.reuse_distance_ref`."""
    _check(prev, valid)
    dev = prev.device
    if dev.type != "cuda":
        raise ValueError(f"reuse_distance_cuda needs CUDA tensors, got {dev}")
    S, L = prev.shape
    prev = prev.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((S, L), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _library()
    work = torch.empty(lib.reuse_distance_workspace_bytes(S, L),
                       dtype=torch.uint8, device=dev)
    err = lib.reuse_distance_launch(
        prev.data_ptr(), valid.data_ptr(), out.data_ptr(), work.data_ptr(),
        S, L, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return out


def reuse_distances(prev, valid, *, block: int = 128,
                    device=None) -> torch.Tensor:
    """Reuse distances of ``[S, L]`` rows: the plain version
    (:func:`~repro_torch.kernels.ref.reuse_distance_ref`, blocked over
    ``block`` queries) for CPU tensors, the kernel for CUDA tensors. Numpy
    inputs are moved to ``device`` first (``None`` = the card); tensors
    stay on their own device."""
    if not isinstance(prev, torch.Tensor):
        dev = resolve_device(device)
        prev = torch.as_tensor(np.asarray(prev, np.int32), device=dev)
        valid = torch.as_tensor(np.asarray(valid, bool), device=dev)
    _check(prev, valid)
    dev = prev.device
    if dev.type == "cpu":
        return reuse_distance_ref(prev, valid, block=block)
    if dev.type != "cuda":
        raise ValueError(f"no reuse-distance path for device {dev}")
    return reuse_distance_cuda(prev, valid)
