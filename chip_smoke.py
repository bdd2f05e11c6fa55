"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, drives the port's main path
(``repro_torch.sim.simulate``) on the §V worked example and on a full-size
deployment, and prints:

- the card's name and power limit, as ``nvidia-smi`` prints them;
- one line per phase, with its times;
- one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
  main path, its agreement with the plain version, its time, the plain
  version's time and its bound;
- last, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits nonzero. Without CUDA, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s. The data sheet's
# 67 TFLOP/s outside the tensor cores counts an FMA as two operations on
# 128 fp32 lanes an SM; Hopper's SM has 64 int32 lanes (Hopper architecture
# white paper), so the kernel's integer compares, adds and selects issue at
# a quarter of that.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# Integer operations per cache line: the lookup compare (every step, over
# the filled lines), each LRU/LFU argmin step (eviction steps), and the
# Random expert's threefry draw and argmax step (eviction steps: 20 rounds
# of add/rotate/xor, 6 key injections, the mantissa shift).
OPS_LOOKUP, OPS_ARGMIN, OPS_DRAW = 1, 1, 83
# Per eviction step and line: the int32 state arrays the victim experts
# read (LRU: ts, LFU: freq) and whether the Random expert draws.
VICTIM_ARRAYS = {"ws": 2, "lru": 1, "lfu": 1, "random": 0}
DRAWS = {"ws": 1, "lru": 0, "lfu": 0, "random": 1}
PUBLISHED_LAM_EFF = 86.6  # §V worked example
PREFIX = 2**17  # full-size requests per row held against the plain version


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 1) -> tuple[float, object]:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def filled_lines(pages: np.ndarray, n_lines: int) -> int:
    """Lines the lookups of all steps scan: a step scans the lines filled
    before it. No line is evicted before the cache is full, so until then
    the fill is the number of distinct pages the row has seen."""
    total = 0
    for row in pages:
        new = np.zeros(len(row), np.int64)
        new[np.unique(row, return_index=True)[1]] = 1
        seen = np.cumsum(new) - new
        total += int(np.minimum(seen, n_lines).sum())
    return total


def bound(policy: str, out: dict, pages: np.ndarray, n_lines: int, W: int,
          chain_ms: float, l2_rate: float) -> dict:
    """Least time the card could take for this run's work, term by term:

    - ``io_bytes_ms``: inputs read once (page, write flag, window id; 12 B
      a request) and outputs written once, over the HBM rate;
    - ``state_bytes_ms``: the per-line state the steps must read (4 B of
      tags a filled line a lookup; on an eviction step 4 B a line of each
      array a victim expert scans), over the L2 read rate measured here;
    - ``ops_ms``: the integer operations on those lines, over the int32
      rate;
    - ``serial_chain_ms``: each row is a chain of dependent steps, and no
      step can take less than the measured skeleton (two block barriers
      around one dependent L2 load) on a block per row.

    The bound is the largest term; ``bytes`` names the first two,
    ``operations`` the last two (the chain is a chain of dependent
    operations)."""
    B, L = pages.shape
    scanned = filled_lines(pages, n_lines)
    ev_lines = int(out["evictions"].sum()) * n_lines
    io = 12 * B * L + B * (4 * 8 + 4 * 3 + 4 * 3 + 4 * 13 * W)
    state = 4 * scanned + 4 * VICTIM_ARRAYS[policy] * ev_lines
    ops = (OPS_LOOKUP * scanned
           + ev_lines * (OPS_ARGMIN * VICTIM_ARRAYS[policy]
                         + OPS_DRAW * DRAWS[policy]))
    terms = dict(io_bytes_ms=1e3 * io / HBM_BYTES_PER_S,
                 state_bytes_ms=1e3 * state / l2_rate,
                 ops_ms=1e3 * ops / INT32_OPS_PER_S,
                 serial_chain_ms=chain_ms)
    top = max(terms, key=terms.get)
    return dict(bound_ms=terms[top],
                bound_by=("bytes" if "bytes" in top else "operations"),
                bound_terms=terms)


def compare(got: dict, want: dict, ctx: str) -> float:
    """Every field equal (integers exactly, f32 bit for bit); returns the
    largest absolute difference (0.0)."""
    if set(got) != set(want):
        raise AssertionError(f"kernel != plain ({ctx}): fields differ")
    err = 0.0
    for f, ref in want.items():
        x = got[f]
        if ref.dtype == torch.float32:
            same = torch.equal(x.view(torch.int32), ref.view(torch.int32))
        else:
            same = torch.equal(x, ref)
        err = max(err, float((x.double() - ref.double()).abs().max()))
        if not same:
            raise AssertionError(f"kernel != plain ({ctx}): field={f}")
    return err


def fmt_bound(b: dict) -> str:
    terms = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in b["bound_terms"].items())
    return f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {terms})"


def phase_build():
    """Build every CUDA source at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import probe
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda f: f(), (cs.build_cache_scan,
                                             probe.build_probe)))
    dt = time.perf_counter() - t0
    for lib in libs:
        report = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "smem" in ln]
        log(f"[build] {lib.name}; ptxas: {' | '.join(report)}")
    log(f"[build] {len(libs)} libraries in {dt:.2f} s")


def phase_probes() -> float:
    """The card's L2 read rate, for the bound's state-bytes term."""
    from repro_torch.kernels import probe
    rate = probe.l2_read_rate("cuda")
    log(f"[probes] L2 read rate {rate / 1e12:.3f} TB/s (l2_read_probe, "
        f"CUDA events)")
    return rate


def _rows(L: int, n_windows: int):
    """Four stream rows of ``L`` requests (IRM, Poisson/IRM mix, two
    interleaved strided streams, IRM), with a padded tail."""
    from repro_torch.core.traffic import TrafficSpec, make_stream
    from repro_torch.storage.tiered_store import stream_window_ids
    specs = [TrafficSpec(kind="irm", n_requests=L, n_pages=4096,
                         write_fraction=0.3, seed=1),
             TrafficSpec(kind="mixed", n_requests=L, n_pages=2048,
                         write_fraction=0.3, seed=2),
             TrafficSpec(kind="strided", n_requests=L, n_pages=8192,
                         stride=3, n_streams=2, write_fraction=0.3, seed=3),
             TrafficSpec(kind="irm", n_requests=L, n_pages=1024,
                         write_fraction=0.5, seed=4)]
    pages, writes = zip(*(make_stream(s) for s in specs))
    win = np.tile(stream_window_ids(L, n_windows), (len(specs), 1))
    win[:, L - 96:] = n_windows  # trailing pads drop out of every window
    return np.stack(pages), np.stack(writes), win


def phase_kernel_vs_plain(l2_rate: float) -> None:
    """Kernel vs plain version on the card, every policy x prefetch."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import probe
    from repro_torch.storage.tiered_store import StoreConfig
    B, L, N, W = 4, 4096, 512, 8
    dev = torch.device("cuda")
    rows = _rows(L, W)
    pages, writes, win = (torch.as_tensor(x, device=dev) for x in rows)
    keys = cs.cold_keys(9, B, dev)
    chain_ms = probe.chain_step_ms(dev, n_rows=B, steps=L,
                                   threads=cs.cache_scan_threads(N))
    for policy in ("ws", "lru", "lfu", "random"):
        for prefetch in (False, True):
            cfg = StoreConfig(n_lines=N, policy=policy, prefetch=prefetch)
            hyper = cfg.hyper(device=dev)
            args = (cfg, hyper, keys, pages, writes, win)
            cs.cache_scan_cuda(*args, n_windows=W)  # warm-up
            k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(
                *args, n_windows=W), reps=3)
            p_ms, want = cuda_ms(lambda: cs.cache_scan_plain(
                *args, n_windows=W))
            compare(out, want, f"policy={policy} prefetch={prefetch}")
            b = bound(policy, out, rows[0], N, W, chain_ms, l2_rate)
            log(f"[kernel vs plain] policy={policy} prefetch={prefetch}: "
                f"equal (tolerance 0: integers exact, f32 bit for bit); "
                f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, "
                f"{fmt_bound(b)}; evictions {out['evictions'].tolist()}")


def worked_example_spec():
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.sim import RateSpec, SimSpec
    from repro_torch.storage.tiered_store import StoreConfig
    return SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=4000, n_pages=1024,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=128, policy="ws"),
        n_shards=4, lam=100.0, k_servers=1,
        rates=RateSpec(source="paper"), p12_override=0.2)


def phase_worked_example() -> int:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import simulate
    spec = worked_example_spec()
    cs.reset_cache_scan_launch_count()
    t0 = time.perf_counter()
    rep = simulate(spec, device="cuda")
    dt = time.perf_counter() - t0
    launches = cs.cache_scan_launch_count()
    if launches < 1:
        raise AssertionError("the §V run launched no cache-scan kernel")
    err = abs(rep.lam_eff - PUBLISHED_LAM_EFF) / PUBLISHED_LAM_EFF
    if not err < 0.01:
        raise AssertionError(f"lam_eff={rep.lam_eff} off 86.6 by {err:.2%}")
    cpu = simulate(spec, device="cpu")
    same = (json.dumps(rep.to_dict(), sort_keys=True)
            == json.dumps(cpu.to_dict(), sort_keys=True))
    if not same:
        raise AssertionError("§V report on cuda != report on cpu")
    log(f"[§V example] lam_eff={rep.lam_eff} (rel err {err:.2e}), "
        f"rho1={rep.rho1}, rho2={rep.rho2}, miss_rate={rep.miss_rate}; "
        f"to_dict identical to the cpu run; {dt:.2f} s, {launches} launch")
    return launches


def full_size_spec():
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.sim import SimSpec
    from repro_torch.storage.tiered_store import StoreConfig
    return SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=2**22, n_pages=2**22,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=16384, policy="ws"),
        n_shards=16, mapping="random", n_windows=32, lam=200.0)


def phase_full_size(l2_rate: float) -> dict:
    """The paper's many-core deployment: 16 processes, one 16,384-line
    tier-1 cache each, 2^22 IRM requests, through the two entry points
    ``simulate`` composes."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import probe
    from repro_torch.sim import report_from_counters, tier1_counters
    from repro_torch.sim.engine import (
        _assemble_counters, fault_owner, stream_for_spec)
    from repro_torch.storage.tiered_store import (
        StreamStats, correct_padded_stats, partition_streams,
        stream_window_ids)
    spec = full_size_spec()
    cfg = spec.store
    t0 = time.perf_counter()
    pages, is_write, times, n_pages, W, _ = stream_for_spec(spec)
    gen_s = time.perf_counter() - t0

    cs.reset_cache_scan_launch_count()
    t1 = time.perf_counter()
    ctr = tier1_counters(spec, device="cuda")
    t2 = time.perf_counter()
    rep = report_from_counters(spec, ctr)
    t3 = time.perf_counter()
    launches = cs.cache_scan_launch_count()
    if launches < 1:
        raise AssertionError("the full-size run launched no kernel")

    if not (ctr.evictions > 0).all():
        raise AssertionError(f"a shard never evicted: {ctr.evictions}")
    if not (ctr.hits + ctr.misses == ctr.requests).all():
        raise AssertionError("hits + misses != requests")
    for f in ("requests", "hits", "misses", "prefetch_hits", "tier2_reads",
              "tier2_writes", "evictions"):
        if not (getattr(ctr, "win_" + f).sum(-1) == getattr(ctr, f)).all():
            raise AssertionError(f"windowed {f} do not sum to the total")
    if not np.isfinite(rep.response_s) or rep.requests != 2**22:
        raise AssertionError("full-size report is not finite / complete")

    # The kernel alone at the main path's shapes, timed with CUDA events;
    # it must reproduce the main path's counters.
    owner = fault_owner(spec, pages, times, n_pages)
    sh_pages, sh_writes, counts, _, sh_win = partition_streams(
        pages, is_write, n_shards=spec.n_shards, n_pages=n_pages,
        n_windows=W, owner=owner)
    dev = torch.device("cuda")
    B, L = sh_pages.shape
    args = (cfg, cfg.hyper(device=dev), cs.cold_keys(0, B, dev),
            *(torch.as_tensor(x, device=dev)
              for x in (sh_pages, sh_writes, sh_win)))
    k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(*args, n_windows=W))
    stats = StreamStats(requests=torch.full((B,), L, device=dev), **out)
    writes = np.bincount(owner[is_write], minlength=spec.n_shards)
    again = _assemble_counters(correct_padded_stats(stats, counts, L),
                               counts, writes)
    for f in ctr._fields:
        if not np.array_equal(getattr(again, f), getattr(ctr, f)):
            raise AssertionError(f"timed re-run differs in {f}")
    threads = cs.cache_scan_threads(cfg.n_lines)
    main_b = bound("ws", out, sh_pages, cfg.n_lines, W, probe.chain_step_ms(
        dev, n_rows=B, threads=threads, steps=L), l2_rate)
    log(f"[full size] {spec.n_shards} shards x {L} padded requests "
        f"(loads {int(counts.min())}..{int(counts.max())}), "
        f"n_lines={cfg.n_lines}: stream generation {gen_s:.2f} s, "
        f"tier-1 stage {t2 - t1:.2f} s (generation, mapping, partition, "
        f"kernel), report {t3 - t2:.3f} s; kernel {k_ms:.1f} ms (CUDA "
        f"events), {fmt_bound(main_b)}; {launches} launch; "
        f"miss_rate={rep.miss_rate:.4f}, evictions/shard "
        f"{int(ctr.evictions.min())}..{int(ctr.evictions.max())}, "
        f"response_s={rep.response_s:.6g}")

    # Kernel against the plain version at the main path's widths (16 rows,
    # 16,384 lines, 32 windows) on the first PREFIX requests of each row,
    # binned into 32 equal windows: every row fills its cache and evicts
    # in the prefix, and each of the block's 1,024 threads loops over 16
    # lines. (The plain version's per-step loop over the whole rows would
    # take most of the run's time limit.)
    P = PREFIX
    pre = (cfg, args[1], args[2], args[3][:, :P].contiguous(),
           args[4][:, :P].contiguous(),
           torch.as_tensor(np.tile(stream_window_ids(P, W), (B, 1)),
                           device=dev))
    pk_ms, pout = cuda_ms(lambda: cs.cache_scan_cuda(*pre, n_windows=W))
    pp_ms, want = cuda_ms(lambda: cs.cache_scan_plain(*pre, n_windows=W))
    err = compare(pout, want, f"full-size rows, first {P} requests")
    if not (pout["evictions"] > 0).all():
        raise AssertionError("a row never evicted in the compared prefix")
    pre_b = bound("ws", pout, sh_pages[:, :P], cfg.n_lines, W,
                  probe.chain_step_ms(dev, n_rows=B, threads=threads,
                                      steps=P), l2_rate)
    log(f"[full size, kernel vs plain] {B} rows x first {P} requests, "
        f"n_lines={cfg.n_lines}, {W} windows, ws: equal (tolerance 0: "
        f"integers exact, f32 bit for bit); kernel {pk_ms:.1f} ms, plain "
        f"{pp_ms:.1f} ms, {fmt_bound(pre_b)}; evictions/row "
        f"{int(pout['evictions'].min())}..{int(pout['evictions'].max())}")
    return dict(launches=launches, ms=pk_ms, plain_ms=pp_ms,
                max_abs_err=err, **pre_b,
                shape=f"{B}x{P} (first {P} requests of the main path's "
                      f"rows), n_lines={cfg.n_lines}, n_windows={W}, ws",
                main_ms=k_ms, main_bound_ms=main_b["bound_ms"],
                main_bound_by=main_b["bound_by"],
                main_bound_terms=main_b["bound_terms"],
                main_shape=f"{B}x{L} rows, n_lines={cfg.n_lines}, "
                           f"n_windows={W}, ws")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails at once without the repo)
    log(card_line())  # name, power limit: as nvidia-smi prints them
    phase_build()
    l2_rate = phase_probes()
    phase_kernel_vs_plain(l2_rate)
    phase_worked_example()
    full = phase_full_size(l2_rate)
    kernel = dict(
        name="cache_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_scan.cu",
        replaces="src/repro/kernels/cache_scan.py:385", library_ms=None,
        **full)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
