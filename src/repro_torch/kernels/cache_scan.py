"""Fused tier-1 cache scan: the request loop as one hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/cache_scan.py:
cache_scan_kernel`` (body ``_cache_scan_body``), which keeps each stream
row's cache state in VMEM and loops over the requests with one-hot
elementwise updates.

On Hopper the kernel (``csrc/cache_scan.cu``) runs one thread block per
shard row, or a thread-block cluster per row where rows are fewer than
SMs. What bounds it is the serial request loop: every step reads the
state the previous step wrote, so a row's steps cannot overlap. The design
keeps the per-line state in shared memory where it fits (else in device
scratch that stays in L2), looks up the next ``K`` requests' pages in one
block-wide pass, and lets one warp walk the ``K`` steps with no block
barrier, correcting each looked-up line with the walk's own fills; the
block joins in only for an eviction's victim proposals and an active
prefetch probe. The PRNG key chain runs on its own warp, and the other
blocks of a row's cluster draw the Random expert's uniforms for their
share of the lines (no ``[L, n_lines]`` noise table is ever built). See
``PERF.md`` for its time and bound, and ``probe.py`` for the probes that
price the bound's step and shared-memory terms.

Dispatch: :func:`fused_cache_scan` takes the plain PyTorch version
(:func:`repro_torch.kernels.ref.cache_scan_ref`) for tensors on the CPU and
launches the kernel for CUDA tensors; there is no fallback between them.
Both take the same arguments, run every row from the cold ``init_store``
state with its own PRNG key, and return the same counters.
:func:`cache_scan_launch_count` counts kernel launches (the reference's
compile count, as a launch count).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import online_learning as _ol
from repro_torch.kernels import threefry
from repro_torch.kernels.build import CSRC, build_library
from repro_torch.kernels.ref import cache_scan_ref

__all__ = [
    "fused_cache_scan",
    "cache_scan_plain",
    "cache_scan_cuda",
    "cold_keys",
    "cache_scan_threads",
    "cache_scan_plan",
    "Plan",
    "per_row",
    "build_cache_scan",
    "cache_scan_launch_count",
    "reset_cache_scan_launch_count",
]

SOURCE = CSRC / "cache_scan.cu"
_SMEM_MAX = 232448  # dynamic shared memory a block may use on Hopper
_LOOKAHEAD = 256  # requests a look-ahead pass covers

_LAUNCHES = [0]
_LIB = [None]


def cache_scan_launch_count() -> int:
    """Number of cache-scan kernel launches so far."""
    return _LAUNCHES[0]


def reset_cache_scan_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_cache_scan():
    """Compile ``csrc/cache_scan.cu`` (once per source content) and return
    the library's path."""
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        lib = ctypes.CDLL(str(build_cache_scan()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cache_scan_launch.argtypes = [p] * 15 + [i] * 13 + [p]
        lib.cache_scan_launch.restype = i
        lib.cache_scan_smem_bytes.argtypes = [i] * 8
        lib.cache_scan_smem_bytes.restype = ctypes.c_size_t
        lib.cache_scan_pick_cluster.argtypes = [i] * 10
        lib.cache_scan_pick_cluster.restype = i
        lib.cache_scan_error_string.argtypes = [i]
        lib.cache_scan_error_string.restype = ctypes.c_char_p
        _LIB[0] = lib
    return _LIB[0]


def cache_scan_threads(n_lines: int) -> int:
    """Threads of one block: the walker's warp, the key-chain warp, and a
    worker warp per 32 lines (at least one) up to 512 threads in all, so
    that a thread may hold 128 registers; each worker thread then loops
    over ``ceil(n_lines / 448)`` lines."""
    return 64 + min(448, max(32, -(-n_lines // 32) * 32))


class Plan(NamedTuple):
    """How a launch runs: the per-line state in shared memory or in device
    scratch, the look-ahead ``K``, the block's shared memory and threads,
    and the blocks a row's cluster takes."""

    smem_state: bool
    K: int
    smem_bytes: int
    threads: int
    cluster: int


def cache_scan_plan(cfg, n_windows: int, n_rows: int, *,
                    cluster=None) -> Plan:
    """The plan of a launch of ``n_rows`` rows, chosen from the sizes alone:
    the state in shared memory where it fits beside a look-ahead of
    ``_LOOKAHEAD`` requests, else in device scratch; 8, 4 or 2 blocks a row
    where the rows' clusters fit the card at once and the cache is large
    (the library decides), else 1. ``cluster`` forces the cluster size.
    Raises if the card's occupancy query fails."""
    lib = _library()
    N, K = cfg.n_lines, _LOOKAHEAD
    dims = (min(cfg.pred_cap, cfg.epoch_width), cfg.prefetch_width,
            cfg.prefetch_buf, n_windows, cfg.epoch_width)
    for in_smem in (True, False):
        smem = lib.cache_scan_smem_bytes(N, K, *dims, int(in_smem))
        if smem <= _SMEM_MAX:
            threads = cache_scan_threads(N)
            if cluster is None:
                cluster = lib.cache_scan_pick_cluster(
                    n_rows, N, K, *dims, int(in_smem), threads)
                if cluster < 0:
                    raise RuntimeError(
                        "cache_scan cluster query failed: "
                        + lib.cache_scan_error_string(-cluster).decode())
            return Plan(in_smem, K, smem, threads, cluster)
    raise ValueError(
        f"n_lines={N}, n_windows={n_windows} need {smem} B of shared "
        f"memory per block; the card offers {_SMEM_MAX}")


def per_row(hyper, n_rows: int, device):
    """``hyper`` (a ``StoreHyper`` of scalars or ``[n_rows]`` tensors) with
    every knob a contiguous ``[n_rows]`` tensor on ``device``: f32
    ``alpha``/``beta``/``threshold``, i32 ``policy_idx``."""
    return type(hyper)(*(
        torch.as_tensor(x, dtype=d, device=device).reshape(-1)
        .expand(n_rows).contiguous()
        for x, d in zip(hyper, (torch.float32,) * 3 + (torch.int32,))))


def _check_rows(pages, writes, win):
    if pages.dim() != 2 or writes.shape != pages.shape \
            or win.shape != pages.shape:
        raise ValueError("pages, writes and win must be [B, L] alike, got "
                         f"{tuple(pages.shape)}, {tuple(writes.shape)}, "
                         f"{tuple(win.shape)}")
    if not (pages.device == writes.device == win.device):
        raise ValueError("pages, writes and win must share one device")
    if pages.numel() and int(pages.min()) < 0:
        raise ValueError("page ids must be non-negative (-1 marks a free "
                         "cache line)")


def cold_keys(seed: int, n_rows: int, device=None) -> torch.Tensor:
    """The PRNG key of a cold ``init_store(cfg, seed)`` state for each of
    ``n_rows`` rows: int64 ``[n_rows, 2]`` (two uint32 words)."""
    return torch.tensor([threefry.prng_key(seed)] * n_rows,
                        dtype=torch.int64, device=device)


def cache_scan_plain(cfg, hyper, keys, pages, writes, win, *,
                     n_windows: int) -> dict:
    """The plain PyTorch version on any device; same arguments and result
    as :func:`cache_scan_cuda`."""
    # tiered_store imports this module, so its state builders load late.
    from repro_torch.storage.tiered_store import (
        init_accum, init_store, stack_rows)
    _check_rows(pages, writes, win)
    B, dev = pages.shape[0], pages.device
    state0 = stack_rows(init_store(cfg, device=dev), B)._replace(
        key=torch.as_tensor(keys, dtype=torch.int64, device=dev)
        .reshape(B, 2))
    final, acc = cache_scan_ref(
        state0, init_accum(B, n_windows, device=dev), pages, writes, win,
        hyper, epoch_width=cfg.epoch_width, pred_cap=cfg.pred_cap,
        prefetch=cfg.prefetch, prefetch_width=cfg.prefetch_width,
        n_windows=n_windows)
    return dict(acc._asdict(), final_weights=final.ols.weights)


def cache_scan_cuda(cfg, hyper, keys, pages, writes, win, *,
                    n_windows: int) -> dict:
    """Launch the kernel on ``[B, L]`` CUDA rows, each from the cold
    ``init_store`` state with PRNG key ``keys[b]`` (two uint32 words).
    Returns the accumulator dict (``StreamStats`` field names, a leading
    row axis, plus ``final_weights``)."""
    return _launch(cfg, hyper, keys, pages, writes, win, n_windows=n_windows)


def _launch(cfg, hyper, keys, pages, writes, win, *, n_windows: int,
            cluster=None) -> dict:
    """:func:`cache_scan_cuda` with the cluster size a row takes forced
    where given (the tests hold cluster sizes 1 and 8 against each other);
    by default it follows the sizes."""
    _check_rows(pages, writes, win)
    dev = pages.device
    if dev.type != "cuda":
        raise ValueError(f"cache_scan_cuda needs CUDA tensors, got {dev}")
    B, L = pages.shape
    N, W, E = cfg.n_lines, n_windows, _ol.N_EXPERTS
    ew = cfg.epoch_width
    ring = min(cfg.pred_cap, ew)
    if min(N, ew, cfg.pred_cap, B) < 1:
        raise ValueError("n_lines, epoch_width, pred_cap and the row count "
                         "must be positive")
    lib = _library()
    plan = cache_scan_plan(cfg, W, B, cluster=cluster)
    i32, f32 = torch.int32, torch.float32
    pages = pages.to(i32).contiguous()
    writes = writes.to(i32).contiguous()
    win = win.to(i32).contiguous()
    alpha, beta, thr, pol = per_row(hyper, B, dev)
    pw = _ol.pow_table(beta, ew).to(dev).contiguous()
    k = torch.as_tensor(keys, dtype=torch.int64).reshape(B, 2)
    k = torch.where(k >= 2**31, k - 2**32, k).to(i32).to(dev).contiguous()
    scratch = torch.empty(0 if plan.smem_state else B * (3 * N + -(-N // 32)),
                          dtype=i32, device=dev)
    scal = torch.empty(B, 6, dtype=i32, device=dev)
    eu = torch.empty(B, E, dtype=i32, device=dev)
    winc = torch.empty(B, 7, W, dtype=i32, device=dev)
    weu = torch.empty(B, W, E, dtype=i32, device=dev)
    ww = torch.empty(B, W, E, dtype=f32, device=dev)
    fw = torch.empty(B, E, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (pages, writes, win, alpha, thr, pol, pw,
                                   k, scratch, scal, eu, winc, weu, ww, fw)]
    err = lib.cache_scan_launch(
        *ptrs, B, L, N, ew, ring, int(cfg.prefetch), cfg.prefetch_width,
        cfg.prefetch_buf, W, plan.K, int(plan.smem_state), plan.cluster,
        plan.threads, stream)
    if err != 0:
        raise RuntimeError("cache_scan kernel launch failed: "
                           + lib.cache_scan_error_string(err).decode())
    _LAUNCHES[0] += 1
    return dict(
        hits=scal[:, 0], misses=scal[:, 1], prefetch_hits=scal[:, 2],
        tier2_reads=scal[:, 3], tier2_writes=scal[:, 4],
        evictions=scal[:, 5], expert_use=eu,
        win_requests=winc[:, 0], win_hits=winc[:, 1],
        win_misses=winc[:, 2], win_prefetch_hits=winc[:, 3],
        win_tier2_reads=winc[:, 4], win_tier2_writes=winc[:, 5],
        win_evictions=winc[:, 6], win_expert_use=weu, win_weights=ww,
        final_weights=fw,
    )


def fused_cache_scan(cfg, hyper, keys, pages, writes, win, *,
                     n_windows: int) -> dict:
    """The fused engine over ``[B, L]`` rows, each from the cold
    ``init_store`` state with PRNG key ``keys[b]``: the plain version for
    CPU tensors, the kernel for CUDA tensors. Returns the ``StreamStats``
    fields but ``requests``, each with a leading row axis."""
    dev = pages.device
    if dev.type == "cpu":
        return cache_scan_plain(cfg, hyper, keys, pages, writes, win,
                                n_windows=n_windows)
    if dev.type != "cuda":
        raise ValueError(f"no cache-scan path for device {dev}")
    return cache_scan_cuda(cfg, hyper, keys, pages, writes, win,
                           n_windows=n_windows)
