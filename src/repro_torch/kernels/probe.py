"""Timed probes that price the cache-scan kernel's bound on the card.

``csrc/probe.cu`` holds small kernels with no TPU counterpart; nothing on
the main path launches them. :func:`l2_read_rate` and
:func:`smem_read_rate` measure the rates at which the whole card reads an
L2-resident buffer and its shared memory; :func:`chain_step_ms` the least
time of the request steps of the cache-scan design that takes a block
barrier a step (two block barriers around one dependent L2 load) and
:func:`walker_step_ms` that of the look-ahead design (a block pass every
``K`` steps, then one warp's dependent shared-memory steps), each with
CUDA events on the given CUDA device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CSRC, build_library

__all__ = ["build_probe", "l2_read_rate", "smem_read_rate", "chain_step_ms",
           "walker_step_ms"]

SOURCE = CSRC / "probe.cu"
_LIB = [None]


def build_probe():
    """Compile ``csrc/probe.cu`` (once per source content) and return the
    library's path."""
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        lib = ctypes.CDLL(str(build_probe()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.l2_read_probe_launch.argtypes = [p, i, i, p, i, i, p]
        lib.l2_read_probe_launch.restype = i
        lib.chain_probe_launch.argtypes = [p, i, p, i, i, p]
        lib.chain_probe_launch.restype = i
        lib.walker_probe_launch.argtypes = [i, i, i, p, i, i, p]
        lib.walker_probe_launch.restype = i
        lib.smem_read_probe_launch.argtypes = [i, i, p, i, i, p]
        lib.smem_read_probe_launch.restype = i
        lib.probe_error_string.argtypes = [i]
        lib.probe_error_string.restype = ctypes.c_char_p
        _LIB[0] = lib
    return _LIB[0]


def _timed(launch, device, reps: int) -> float:
    """Milliseconds per call of ``launch()`` after one warm-up call."""
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream

    def go():
        err = launch(lib, stream)
        if err != 0:
            raise RuntimeError("probe launch failed: "
                               + lib.probe_error_string(err).decode())
    go()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        go()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def l2_read_rate(device, *, threads: int = 256, reps: int = 2000) -> float:
    """Bytes per second at which every SM together reads a buffer that
    stays in L2: the best of 2, 4 and 8 blocks of ``threads`` an SM, each
    thread reading 64 bytes of one slice of the buffer a rep, ``reps``
    slices in turn (17 MB in all on 132 SMs, 35 MB at 8 blocks)."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    best = 0.0
    for blocks_per_sm, sweeps in ((2, 4), (4, 2), (8, 2)):
        blocks = sms * blocks_per_sm
        buf = torch.arange(sweeps * 16 * blocks * threads, dtype=torch.int32,
                           device=device)
        out = torch.empty(blocks * threads, dtype=torch.int32, device=device)
        ms = _timed(lambda lib, s: lib.l2_read_probe_launch(
            buf.data_ptr(), sweeps, reps, out.data_ptr(), blocks, threads,
            s), device, reps=3)
        best = max(best, buf.numel() * 4 / sweeps * reps / (ms * 1e-3))
    return best


def chain_step_ms(device, *, n_rows: int, threads: int, steps: int) -> float:
    """Milliseconds for ``steps`` request-step skeletons in a row, one block
    of ``threads`` threads per row, ``n_rows`` rows at once."""
    device = torch.device(device)
    n = 32 * 1024  # a cycle over 1,024 lines of 128 bytes
    nxt = ((torch.arange(n, dtype=torch.int32, device=device) + 32) % n)
    out = torch.empty(n_rows, dtype=torch.int32, device=device)
    return _timed(lambda lib, s: lib.chain_probe_launch(
        nxt.data_ptr(), steps, out.data_ptr(), n_rows, threads, s),
        device, reps=1)


def smem_read_rate(device, *, threads: int = 1024, reps: int = 4096) -> float:
    """Bytes per second at which every SM together reads its shared memory:
    two blocks of ``threads`` an SM, each thread loading 16 bytes of its
    block's 64 KiB ``reps`` times, each address depending on the last
    load's data."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, n_vec = 2 * sms, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device=device)
    ms = _timed(lambda lib, s: lib.smem_read_probe_launch(
        reps, n_vec, out.data_ptr(), blocks, threads, s), device, reps=3)
    return blocks * threads * 16 * reps / (ms * 1e-3)


def walker_step_ms(device, *, n_rows: int, threads: int, steps: int,
                   K: int, n_lines: int) -> float:
    """Milliseconds for ``steps`` hit steps of the look-ahead design in a
    row (a block pass over ``n_lines`` lines every ``K`` steps, one warp's
    walk between), one block of ``threads`` threads per row, ``n_rows`` rows
    at once; ``n_lines`` is capped at 16,384 (the per-line state must fit
    the block's shared memory)."""
    device = torch.device(device)
    out = torch.empty(n_rows, dtype=torch.int32, device=device)
    return _timed(lambda lib, s: lib.walker_probe_launch(
        steps, K, min(n_lines, 16384), out.data_ptr(), n_rows, threads, s),
        device, reps=1)
