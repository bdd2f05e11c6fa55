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

:func:`masked_cache_scan` is the chunked replay's mode of the same kernel
(``cache_scan_ref(masked=True)`` on the CPU): each row resumes from a
carried ``(StoreState, Accum)`` — the plain version's tensors, which the
kernel reads and updates in place — pads (window id ``>= n_windows``)
change nothing, and the key advances once per real request.
:func:`cache_scan_launch_count` counts kernel launches of both modes (the
reference's compile count, as a launch count).
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
    "masked_cache_scan",
    "masked_cache_scan_plain",
    "masked_cache_scan_cuda",
    "carry_leaves",
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
        lib.cache_scan_launch.argtypes = ([p] * 15 + [i] * 13
                                          + [ctypes.POINTER(p), i, p])
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
                    cluster=None, smem_state=None) -> Plan:
    """The plan of a launch of ``n_rows`` rows, chosen from the sizes alone:
    the state in shared memory where it fits beside a look-ahead of
    ``_LOOKAHEAD`` requests, else in device scratch; 8, 4 or 2 blocks a row
    where the rows' clusters fit the card at once and the cache is large
    (the library decides), else 1. ``cluster`` forces the cluster size and
    ``smem_state=False`` the device-scratch plan (the tests hold both
    plans against each other). Raises if the card's occupancy query
    fails."""
    lib = _library()
    N, K = cfg.n_lines, _LOOKAHEAD
    dims = (min(cfg.pred_cap, cfg.epoch_width), cfg.prefetch_width,
            cfg.prefetch_buf, n_windows, cfg.epoch_width)
    for in_smem in ((True, False) if smem_state is None
                    else (bool(smem_state),)):
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


def _check_rows(pages, writes, win, *, check_pages: bool = True):
    if pages.dim() != 2 or writes.shape != pages.shape \
            or win.shape != pages.shape:
        raise ValueError("pages, writes and win must be [B, L] alike, got "
                         f"{tuple(pages.shape)}, {tuple(writes.shape)}, "
                         f"{tuple(win.shape)}")
    if not (pages.device == writes.device == win.device):
        raise ValueError("pages, writes and win must share one device")
    if check_pages and pages.numel() and int(pages.min()) < 0:
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
        plan.threads, None, 0, stream)
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


def carry_leaves(state, acc) -> list:
    """The tensors of a ``(StoreState, Accum)`` carry in the kernel's
    pointer-table order: cache (tags, valid, dirty, freq, ts), learner
    (weights, pred, pred_n, mispred, epoch_misses, chosen), prefetcher
    (ptags, pvalid, last_miss, stride, conf, issued, useful), ``t``,
    ``key``, then the accumulators in field order."""
    return [*state.cache, *state.ols, *state.pf, state.t, state.key, *acc]


def _check_carry(cfg, state, acc, B: int, W: int, dev) -> list:
    """The carry's leaves, each checked to be contiguous, on ``dev``, of
    the plain version's dtype and shape, and no two sharing memory (the
    kernel writes them in place)."""
    N, E, P = cfg.n_lines, _ol.N_EXPERTS, cfg.prefetch_buf
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    want = ([(i32, (B, N)), (b8, (B, N)), (b8, (B, N)), (i32, (B, N)),
             (i32, (B, N)), (f32, (B, E)), (i32, (B, E, cfg.pred_cap)),
             (i32, (B, E)), (i32, (B, E)), (i32, (B, 1)), (i32, (B, 1)),
             (i32, (B, P)), (b8, (B, P))] + [(i32, (B,))] * 6
            + [(torch.int64, (B, 2))] + [(i32, (B,))] * 6
            + [(i32, (B, E))] + [(i32, (B, W))] * 7
            + [(i32, (B, W, E)), (f32, (B, W, E))])
    leaves = carry_leaves(state, acc)
    for i, (x, (dt, shape)) in enumerate(zip(leaves, want)):
        if (x.dtype != dt or tuple(x.shape) != shape or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(
                f"carry leaf {i} must be a contiguous {dt} {list(shape)} "
                f"tensor on {dev}, got {x.dtype} {list(x.shape)} on "
                f"{x.device}")
    if len({x.data_ptr() for x in leaves}) != len(leaves):
        raise ValueError("carry leaves must not share memory: the kernel "
                         "updates each in place")
    return leaves


def masked_cache_scan_plain(cfg, hyper, state, acc, pages, writes, win, *,
                            n_windows: int):
    """The plain version of the masked mode on any device: returns the
    new ``(state, acc)`` (``cache_scan_ref(masked=True)``)."""
    _check_rows(pages, writes, win)
    return cache_scan_ref(
        state, acc, pages, writes, win, hyper,
        epoch_width=cfg.epoch_width, pred_cap=cfg.pred_cap,
        prefetch=cfg.prefetch, prefetch_width=cfg.prefetch_width,
        n_windows=n_windows, masked=True)


def masked_cache_scan_cuda(cfg, hyper, state, acc, pages, writes, win, *,
                           n_windows: int, cluster=None, smem_state=None,
                           pw=None, check_pages: bool = True):
    """Launch the kernel's masked mode on ``[B, L]`` CUDA rows: each row
    resumes from ``(state, acc)`` (a ``StoreState`` and ``Accum`` with a
    leading row axis, every leaf contiguous on the card), which the kernel
    updates in place; returns them. ``cluster`` and ``smem_state=False``
    force the plan, as in :func:`cache_scan_plan`. A caller that keeps the
    launches queued (the chunked replay) passes ``hyper`` as ``[B]``
    tensors on the card with their ``pw`` pow table there, and
    ``check_pages=False`` once it has checked the pages on the host: each
    of these would otherwise copy between host and card, which waits for
    the launches before it."""
    _check_rows(pages, writes, win, check_pages=check_pages)
    dev = pages.device
    if dev.type != "cuda":
        raise ValueError(f"masked_cache_scan_cuda needs CUDA tensors, got "
                         f"{dev}")
    B, L = pages.shape
    N, W = cfg.n_lines, n_windows
    ew = cfg.epoch_width
    ring = min(cfg.pred_cap, ew)
    if min(N, ew, cfg.pred_cap, B) < 1:
        raise ValueError("n_lines, epoch_width, pred_cap and the row count "
                         "must be positive")
    leaves = _check_carry(cfg, state, acc, B, W, dev)
    if L == 0:
        return state, acc
    lib = _library()
    plan = cache_scan_plan(cfg, W, B, cluster=cluster, smem_state=smem_state)
    i32 = torch.int32
    pages = pages.to(i32).contiguous()
    writes = writes.to(i32).contiguous()
    win = win.to(i32).contiguous()
    alpha, beta, thr, pol = per_row(hyper, B, dev)
    if pw is None:
        pw = _ol.pow_table(beta, ew).to(dev)
    pw = pw.contiguous()
    scratch = torch.empty(0 if plan.smem_state else B * -(-N // 32),
                          dtype=i32, device=dev)
    table = (ctypes.c_void_p * len(leaves))(*(x.data_ptr() for x in leaves))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [x.data_ptr() for x in (pages, writes, win, alpha, thr, pol, pw)]
    err = lib.cache_scan_launch(
        *ptrs, None, scratch.data_ptr(), *([None] * 6), B, L, N, ew, ring,
        int(cfg.prefetch), cfg.prefetch_width, cfg.prefetch_buf, W, plan.K,
        int(plan.smem_state), plan.cluster, plan.threads, table,
        cfg.pred_cap, stream)
    if err != 0:
        raise RuntimeError("cache_scan kernel launch failed: "
                           + lib.cache_scan_error_string(err).decode())
    _LAUNCHES[0] += 1
    return state, acc


def masked_cache_scan(cfg, hyper, state, acc, pages, writes, win, *,
                      n_windows: int, **launch):
    """The chunked replay's engine over ``[B, L]`` rows from the carried
    ``(state, acc)``: the plain version for CPU tensors (returns new
    tensors), the kernel for CUDA tensors (updates the carry in place and
    returns it; ``launch`` goes to :func:`masked_cache_scan_cuda`)."""
    dev = pages.device
    if dev.type == "cpu":
        return masked_cache_scan_plain(cfg, hyper, state, acc, pages, writes,
                                       win, n_windows=n_windows)
    if dev.type != "cuda":
        raise ValueError(f"no cache-scan path for device {dev}")
    return masked_cache_scan_cuda(cfg, hyper, state, acc, pages, writes, win,
                                  n_windows=n_windows, **launch)
