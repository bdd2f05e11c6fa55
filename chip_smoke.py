"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` each, in parallel), holds each against its plain PyTorch version
on the card, and drives the port's paths through the entry points a user
calls, each with the launch counts set to 0 just before it and read just
after:

1. build (ptxas's registers and spills of the flash and paged kernels;
   a spill in the tensor-core flash kernel at hd 128 or 256 fails);
2. the bound's timing probes; 3. the cache-scan kernel against
   its plain version, every policy x prefetch;
4. ``simulate`` on the §V worked example;
5. ``simulate``'s stages on the full-size deployment (16 shards x 16,384
   lines, 2^22 requests), and the cache-scan kernel against its plain
   version on the first 2^17 requests of its rows;
6. the reuse-distance kernel against its plain version at small shapes;
7. the cache-scan kernel with its own policy and beta on each of 8 rows
   in one launch, against its plain version;
8. the miss-rate-curve route at full width: ``sweep`` over 64 cache sizes
   of the full-size deployment under LRU (one reuse-distance launch, no
   cache-scan launch), its counters at 16,384 lines against the
   cache-scan kernel's, and the reuse kernel against its plain version on
   the whole distance array;
9. the sweep's megabatch at full width: 16 points, 8 cache signatures,
   one cache-scan launch of 128 rows, and the cache-scan kernel against
   its plain version on those rows' first 2^15 steps;
10. serving at full width: mistral-nemo-12b in bf16 (weights from seed 0),
   8 requests x 3,072-token prompts, prefill and 257 greedy decode steps
   over the paged two-tier KV cache (tier 1 at half the pages, promotion
   every 4 steps); the flash-attention, paged-attention and page-copy
   kernels against their plain versions on inputs captured from that run;
   and the whole path again with the plain versions selected, fed the
   kernel run's tokens: the tier state equal integer for integer, the
   learner's f32 weights bit for bit, the final hidden states and the
   logprobs within a tolerance that two planted faults exceed.
11. serving mamba2-370m at full width (48 SSD layers, no KV pools), as
   phase 10: 48 SSD-scan launches at prefill, the kernel against its
   plain version on layer 0's captured inputs (y within one bf16 step,
   the final state within SSD_F32_TOL), the plain path teacher-forced
   within HIDDEN_TOL of the kernel run against a noise floor (the plain
   scan with half-length chunks), and a planted fault (layer 0's
   handed-off state zeroed) above the bar;
12. serving recurrentgemma-9b at full width (26 RG-LRU and 12 local
   attention layers, window 2,048, read window 17 pages), as phase 10:
   26 RG-LRU, 12 flash and 2 x 12 x 257 paged launches, each kernel
   against its plain version on captured inputs, the plain path with
   the tier state equal and the hidden states and logprobs within their
   bars, and planted faults (the window's token mask dropped; the
   RG-LRU handoff state unrounded) above the bar.

It prints:

- the card's name and power limit, as ``nvidia-smi`` prints them;
- one line per phase, with its times;
- one JSON line ``{"kernels": [...]}`` with the seven kernels'
  launches on their paths, its agreement with the plain version, its time, the plain
  version's time and its bound, term by term (paged attention's time in
  a loop of wrapper calls, and from a CUDA graph of the kernel's launches
  alone as ``ms_graph``);
- last, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits nonzero. Without CUDA, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import gc
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
# Integer operations a filled line costs a look-ahead pass: its tag's hash
# (a multiply and a shift), the probe's load and compare.
OPS_PROBE = 4
# Per eviction step and line: the int32 state arrays the victim experts
# read (LRU: ts, LFU: freq) and whether the Random expert draws.
VICTIM_ARRAYS = {"ws": 2, "lru": 1, "lfu": 1, "random": 0}
DRAWS = {"ws": 1, "lru": 0, "lfu": 0, "random": 1}
PUBLISHED_LAM_EFF = 86.6  # §V worked example
PREFIX = 2**17  # full-size requests per row held against the plain version
# Megabatch steps per row held against the plain version. Its rows fill
# their 16,384 lines near step 105,000, so this prefix covers the fill
# only; eviction under each policy and beta is held in phases 3 and 7,
# and at full size under ws in phase 5. The plain version's per-step loop
# takes about 1.5 ms a step on an H100 (PERF.md), and 2^17 steps here
# would take a fifth of the smoke's time.
MEGA_PREFIX = 2**15
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# Phase 10: the full-width serving cell, and its tolerances.
SERVE = dict(arch="mistral-nemo-12b", full=True, requests=8, prompt=3072,
             new=258, hbm_fraction=0.5, promote_every=4)
FLASH_TOL = 2e-2     # bf16 output, the bar of tests/test_kernels.py
# Element by element, the flash kernel's bf16 output against the plain
# version's: both round f32 results that differ only in summation order,
# so they may differ by one bf16 step (2^-7 of the value at most), plus
# the f32 summation noise where the output cancels to near zero.
FLASH_ULP, FLASH_ABS = 2.0 ** -7, 1e-5
FLASH_FAULT = 2.0 ** -5  # planted fault: the last query tile off by 1/32
PAGED_REL_TOL = 1e-5  # f32 partials, against each field's largest magnitude
# Kernel run vs plain run, in nats. The random 40-layer bf16 model
# amplifies any change of summation order: the plain run against itself
# with only the prefill attention reordered differs by about a tenth of a
# nat (the phase measures this noise floor); in f32 the kernel run stays
# within 1e-4 of the plain run (tests/test_torch_serving_cuda.py).
LOGPROB_TOL = 0.5
# Kernel run vs plain run: the final hidden state that each step unembeds,
# |h - h_plain| / |h_plain| for each sequence and step. Planted faults
# (the tier-2 partial dropped; one tier-2 page skipped) must exceed it.
HIDDEN_TOL = 0.05
# Phases 11 and 12: the recurrent models at full width, served as phase 10.
SSD_SERVE = dict(SERVE, arch="mamba2-370m")
RG_SERVE = dict(SERVE, arch="recurrentgemma-9b")
# The SSD kernel's f32 results (the final state; y from f32 inputs)
# against the plain version's, over the largest magnitude. Both sum the
# within-chunk decay dt A in f32; at mamba2's chunk of 256 a chunk's sum
# reaches several hundred, where one f32 ulp is ~3e-5, so the decays
# exp(cum_t - cum_s) of two summation orders differ by that much (2.5e-5
# for the state, 2.6e-5 for y on an H100, PERF.md §6).
SSD_F32_TOL = 1e-4
# Phase 11's bar on the final hidden state, kernel run vs plain run: the
# random 48-layer mamba2 in bf16 turns a reordering into more than phase
# 10's bar (the plain path against itself with half-length chunks differs
# by 0.069 on an H100, PERF.md §6); 2.9x that floor, while the planted
# fault (one layer's handed-off state zeroed) gave 0.82. So this comparison
# catches only faults that move the hidden state by more than 0.2; the
# kernel-level checks on captured inputs (y within one bf16 step, the state
# within SSD_F32_TOL) carry the fine bar.
SSD_HIDDEN_TOL = 0.2
PROFILE_STEPS = 4  # decode steps traced with torch.profiler
CONTROL_STEPS = 24  # decode steps of the noise-floor run


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


def graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn()`` replayed from a CUDA graph ``reps``
    times (CUDA events): the launches' own time, without the host's time
    between them, which a loop of short kernels from Python may exceed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ms, _ = cuda_ms(graph.replay, reps)
    return ms


def _paged_inputs(call) -> tuple:
    """A captured paged launch with q in f32 and the tables in int32 on
    the pool's card, as the wrapper converts them: timing it times the
    kernel alone."""
    q, pool, slot, live, window = call
    dev = pool.device
    return (q.to(dev, torch.float32).contiguous(), pool,
            slot.to(dev, torch.int32).contiguous(),
            live.to(dev, torch.int32).contiguous(), window)


def filled_lines(row: np.ndarray, n_lines: int) -> int:
    """Lines the lookups of one row's steps scan: a step scans the lines
    filled before it. No line is evicted before the cache is full, so until
    then the fill is the number of distinct pages the row has seen."""
    new = np.zeros(len(row), np.int64)
    new[np.unique(row, return_index=True)[1]] = 1
    seen = np.cumsum(new) - new
    return int(np.minimum(seen, n_lines).sum())


def filled_at_passes(row: np.ndarray, n_lines: int, K: int) -> int:
    """Lines the look-ahead passes of one row scan: the pass before step
    ``t0`` (every ``K``-th step) scans the lines filled before it."""
    new = np.zeros(len(row), np.int64)
    new[np.unique(row, return_index=True)[1]] = 1
    seen = np.cumsum(new) - new
    return int(np.minimum(seen[::K], n_lines).sum())


def bound(policies, out: dict, pages: np.ndarray, n_lines: int, W: int,
          plan, chain_ms: float, walker_ms: float, rates: dict) -> dict:
    """Least time the card could take for this run's work, term by term
    (``policies``: one policy for every row, or one a row; ``plan``: the
    launch's ``cache_scan.Plan``). The terms of the look-ahead design, of
    which the bound is the largest:

    - ``io_bytes_ms``: inputs read once (page, write flag, window id; 12 B
      a request) and outputs written once, over the HBM rate;
    - ``state_bytes_pass_ms``: the per-line state the design must read (4 B
      of tags a filled line a look-ahead pass of ``plan.K`` steps; on an
      eviction step 4 B a line of each array a victim expert scans), over
      the shared-memory read rate measured here where the state lives in
      shared memory, else the L2 read rate;
    - ``ops_pass_ms``: the integer operations on those lines (a pass's
      probe, the argmins, the Random draws), over the int32 rate;
    - ``walker_chain_ms``: each row is a chain of dependent walker
      iterations, and none can take less than the measured skeleton of
      one (``walker_ms`` is ``L`` of them: one warp's dependent
      shared-memory step each, and a block pass every K steps). An
      iteration takes one miss or a run of at most 32 hits, so a row
      takes at least ``misses + ceil(hits / 32)`` of them; the term is
      the most of any row, at ``walker_ms / L`` each.

    Beside them, as before, the terms of the design with a block barrier a
    step (``bound_terms_block_barrier``): ``state_bytes_ms`` (4 B of tags a
    filled line a step, at the L2 rate), ``ops_ms`` (a compare a filled
    line a step) and ``serial_chain_ms`` (two block barriers around one
    dependent L2 load a step). ``bytes`` names the byte terms,
    ``operations`` the others (the chain is a chain of dependent
    operations)."""
    B, L = pages.shape
    if isinstance(policies, str):
        policies = [policies] * B
    evictions = out["evictions"].tolist()
    state = ops = state_pass = ops_pass = 0
    fills: dict = {}  # a sweep's points repeat the same shard rows
    for row, policy, ev in zip(pages, policies, evictions):
        key = row.tobytes()
        if key not in fills:
            fills[key] = (filled_lines(row, n_lines),
                          filled_at_passes(row, n_lines, plan.K))
        scanned, passed = fills[key]
        ev_lines = ev * n_lines
        victims = 4 * VICTIM_ARRAYS[policy] * ev_lines
        evict_ops = ev_lines * (OPS_ARGMIN * VICTIM_ARRAYS[policy]
                                + OPS_DRAW * DRAWS[policy])
        state += 4 * scanned + victims
        ops += OPS_LOOKUP * scanned + evict_ops
        state_pass += 4 * passed + victims
        ops_pass += OPS_PROBE * passed + evict_ops
    io = 12 * B * L + B * (4 * 8 + 4 * 3 + 4 * 3 + 4 * 13 * W)
    rate = rates["smem"] if plan.smem_state else rates["l2"]
    misses = np.asarray(out["misses"].tolist(), np.int64)
    iters = int((misses + -(-(L - misses) // 32)).max())
    terms = dict(io_bytes_ms=1e3 * io / HBM_BYTES_PER_S,
                 state_bytes_pass_ms=1e3 * state_pass / rate,
                 ops_pass_ms=1e3 * ops_pass / INT32_OPS_PER_S,
                 walker_chain_ms=walker_ms * iters / L)
    return dict(_largest(terms), bound_terms_block_barrier=dict(
        state_bytes_ms=1e3 * state / rates["l2"],
        ops_ms=1e3 * ops / INT32_OPS_PER_S, serial_chain_ms=chain_ms))


def cache_scan_bound(policies, out: dict, pages: np.ndarray, cfg, W: int,
                     rates: dict) -> dict:
    """:func:`bound` of a cache-scan launch over ``pages``' rows, with its
    plan and its two step probes timed here on the launch's shapes."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import probe
    B, L = pages.shape
    plan = cs.cache_scan_plan(cfg, W, B)
    dev = torch.device("cuda")
    chain = probe.chain_step_ms(dev, n_rows=B, threads=plan.threads,
                                steps=L)
    walker = probe.walker_step_ms(dev, n_rows=B, threads=plan.threads,
                                  steps=L, K=plan.K, n_lines=cfg.n_lines)
    return dict(bound(policies, out, pages, cfg.n_lines, W, plan, chain,
                      walker, rates), plan=plan._asdict())


def _largest(terms: dict) -> dict:
    top = max(terms, key=terms.get)
    return dict(bound_ms=terms[top],
                bound_by=("bytes" if "bytes" in top else "operations"),
                bound_terms=terms)


def reuse_bound(prev: np.ndarray, valid: np.ndarray) -> dict:
    """Least time for the reuse-distance pass over ``prev``/``valid``:

    - ``bytes_ms``: ``prev`` (4 B) and ``valid`` (1 B) read once and the
      distances (4 B) written once, over the HBM rate;
    - ``ops_ms``: the compares a direct count needs, ``j - P[j] - 1`` for
      each real position ``j`` with ``P[j] >= 0`` (the keys strictly
      between the two accesses), over the int32 rate.

    An O(L log L) count (a Fenwick tree over ``P``) would need fewer
    operations; this bound prices the algorithm the kernel runs."""
    S, L = prev.shape
    j = np.arange(L, dtype=np.int64)[None, :]
    reused = valid & (prev >= 0)
    compares = int(np.where(reused, j - prev.astype(np.int64) - 1, 0).sum())
    return dict(_largest(dict(bytes_ms=1e3 * 9 * S * L / HBM_BYTES_PER_S,
                              ops_ms=1e3 * compares / INT32_OPS_PER_S)),
                compares=compares)


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


def check_report(rep, ctr, ctx: str) -> None:
    """A sweep report's per-shard and windowed counters equal
    ``tier1_counters``'s ``ctr`` in every field."""
    from repro_torch.sim.engine import _ffill_weights
    for f in ("requests", "reads", "writes", "hits", "misses",
              "prefetch_hits", "tier2_reads", "tier2_writes", "evictions"):
        if [getattr(sh, f) for sh in rep.shards] != getattr(ctr, f).tolist():
            raise AssertionError(f"{ctx} != tier1_counters in {f}")
    for f in ("requests", "hits", "misses", "prefetch_hits", "tier2_reads",
              "tier2_writes", "evictions", "expert_use"):
        if not np.array_equal(getattr(rep.windows, f),
                              getattr(ctr, "win_" + f)):
            raise AssertionError(f"{ctx} != tier1_counters in windows.{f}")
    if not np.array_equal(rep.windows.weights, _ffill_weights(
            ctr.win_weights, ctr.win_requests)):
        raise AssertionError(f"{ctx}: window weights differ")


def fmt_bound(b: dict) -> str:
    def terms(d):
        return ", ".join(f"{k[:-3]} {v:.4f}" for k, v in d.items())
    text = (f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"{terms(b['bound_terms'])}")
    for name in ("bound_terms_block_barrier", "bound_terms_per_head_cb"):
        if name in b:
            text += f"; not applied: {terms(b[name])}"
    if "plan" in b:
        p = b["plan"]
        where = "shared memory" if p["smem_state"] else "device scratch"
        text += (f"; plan: state in {where}, K {p['K']}, {p['threads']} "
                 f"threads, cluster {p['cluster']}")
    return text + ")"


def check_over_bound(tag: str, ms: float, bound_ms: float) -> None:
    """A kernel time under its own bound means the bound prices work the
    kernel does not do: fail."""
    if not ms >= bound_ms:
        raise AssertionError(f"[{tag}] kernel {ms} ms under its bound "
                             f"{bound_ms} ms")


def check_kernels_over_bounds(kernels: list) -> None:
    """Every ``<x>ms`` of the kernels line at or above its
    ``<x>bound_ms``."""
    for entry in kernels:
        for key, b in entry.items():
            if key.endswith("bound_ms") and b is not None:
                ms = entry.get(key[:-len("bound_ms")] + "ms")
                if ms is not None:
                    check_over_bound(f"{entry['name']} {key}", ms, b)


def phase_build():
    """Build every CUDA source at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import probe
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.build import build_library
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda f: f(), (
            cs.build_cache_scan, rd.build_reuse_distance, probe.build_probe,
            fa.build_flash_attention, pa.build_paged_attention,
            pg.build_page_copy, ss.build_ssd_scan, rs.build_rglru_scan)))
    dt = time.perf_counter() - t0
    for lib in libs:
        report = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                  .splitlines() if "registers" in ln or "smem" in ln]
        log(f"[build] {lib.name}; ptxas: {' | '.join(report)}")
    log(f"[build] {len(libs)} libraries in {dt:.2f} s")
    # The redesigned kernels' logs, found by source (the libraries exist
    # now, so build_library only returns their paths).
    logs = {src: ptxas_functions(build_library(src).with_suffix(".log")
                                 .read_text())
            for src in (fa.SOURCE, pa.SOURCE)}
    for src, fns in logs.items():
        log(f"[build] {src.name}, each kernel (registers, spill stores / "
            f"loads in bytes): " + "; ".join(
                f"{f['name']} {f['registers']}, {f['spill_stores']} / "
                f"{f['spill_loads']}" for f in fns))
    # The tensor-core flash kernel at mistral's and recurrentgemma's head
    # dims: both must be in the log, and neither may spill.
    tc = {f["name"]: f for f in logs[fa.SOURCE]
          if f["name"] in ("tc<128>", "tc<256>")
          and f["registers"] is not None}
    if len(tc) != 2:
        raise AssertionError(f"ptxas's log of {fa.SOURCE.name} does not "
                             f"report both tc<128> and tc<256>: {sorted(tc)}")
    spilled = [n for n, f in tc.items()
               if f["spill_stores"] + f["spill_loads"]]
    if spilled:
        raise AssertionError(f"the tensor-core flash kernel spills: "
                             f"{spilled}")


def ptxas_functions(text: str) -> list:
    """Each kernel of a ``ptxas -v`` log: a short name (``tc<HD>`` and
    ``f32<HD>`` for flash attention's two paths, ``paged<type, GT>``),
    its registers and its spill stores and loads in bytes."""
    import re
    fns, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            for pat, fmt in ((r"2tc6kernelILi(\d+)E", "tc<{}>"),
                             (r"3f326kernelILi(\d+)E", "f32<{}>"),
                             (r"paged_attention_kernelI(\w+?)Li(\d+)E",
                              "paged<{}, {}>")):
                hit = re.search(pat, name)
                if hit:
                    name = fmt.format(*(("bf16" if "bfloat16" in g else
                                         "f32" if g == "f" else g)
                                        for g in hit.groups()))
                    break
            cur = dict(name=name, registers=None, spill_stores=0,
                       spill_loads=0)
            fns.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                              m.groups())
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return fns


def phase_probes() -> dict:
    """The card's L2 and shared-memory read rates, for the bound's
    state-bytes terms."""
    from repro_torch.kernels import probe
    rates = dict(l2=probe.l2_read_rate("cuda"),
                 smem=probe.smem_read_rate("cuda"))
    log(f"[probes] L2 read rate {rates['l2'] / 1e12:.3f} TB/s "
        f"(l2_read_probe), shared-memory read rate "
        f"{rates['smem'] / 1e12:.3f} TB/s (smem_read_probe); CUDA events")
    return rates


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


def phase_kernel_vs_plain(rates: dict) -> None:
    """Kernel vs plain version on the card, every policy x prefetch."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.storage.tiered_store import StoreConfig
    B, L, N, W = 4, 4096, 512, 8
    dev = torch.device("cuda")
    rows = _rows(L, W)
    pages, writes, win = (torch.as_tensor(x, device=dev) for x in rows)
    keys = cs.cold_keys(9, B, dev)
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
            b = cache_scan_bound(policy, out, rows[0], cfg, W, rates)
            check_over_bound(f"policy={policy} prefetch={prefetch}", k_ms,
                             b["bound_ms"])
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


def phase_full_size(rates: dict) -> dict:
    """The paper's many-core deployment: 16 processes, one 16,384-line
    tier-1 cache each, 2^22 IRM requests, through the two entry points
    ``simulate`` composes."""
    from repro_torch.kernels import cache_scan as cs
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
    main_b = cache_scan_bound("ws", out, sh_pages, cfg, W, rates)
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
    pre_b = cache_scan_bound("ws", pout, sh_pages[:, :P], cfg, W, rates)
    log(f"[full size, kernel vs plain] {B} rows x first {P} requests, "
        f"n_lines={cfg.n_lines}, {W} windows, ws: equal (tolerance 0: "
        f"integers exact, f32 bit for bit); kernel {pk_ms:.1f} ms, plain "
        f"{pp_ms:.1f} ms, {fmt_bound(pre_b)}; evictions/row "
        f"{int(pout['evictions'].min())}..{int(pout['evictions'].max())}")
    return dict(counters=ctr, launches=launches, ms=pk_ms, plain_ms=pp_ms,
                max_abs_err=err, **pre_b,
                shape=f"{B}x{P} (first {P} requests of the main path's "
                      f"rows), n_lines={cfg.n_lines}, n_windows={W}, ws",
                main_ms=k_ms, main_bound_ms=main_b["bound_ms"],
                main_bound_by=main_b["bound_by"],
                main_bound_terms=main_b["bound_terms"],
                main_bound_terms_block_barrier=main_b[
                    "bound_terms_block_barrier"],
                main_plan=main_b["plan"],
                main_shape=f"{B}x{L} rows, n_lines={cfg.n_lines}, "
                           f"n_windows={W}, ws")


def reset_launch_counts() -> None:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import reuse_distance as rd
    cs.reset_cache_scan_launch_count()
    rd.reset_reuse_compile_count()


def launch_counts() -> dict:
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.kernels import reuse_distance as rd
    return dict(cache_scan=cs.cache_scan_launch_count(),
                reuse_distance=rd.reuse_compile_count())


def phase_reuse_vs_plain() -> None:
    """Kernel 2 against its plain version at small shapes: rows of several
    lengths (none a multiple of the 256-query tile but the first), a row of
    first accesses only, a row of pads only, ragged pads."""
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels.ref import reuse_distance_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    for S, L, n_pages in ((2, 256, 40), (1, 1, 1), (3, 1000, 97),
                          (4, 4097, 600), (16, 3001, 300), (2, 70001, 9000)):
        pages = rng.integers(0, n_pages, (S, L)).astype(np.int32)
        counts = rng.integers(0, L + 1, S)
        counts[0] = L
        pages[0] = np.arange(L)            # first accesses only
        if S > 2:
            counts[1] = 0                  # pads only
        prev, valid = rd.prev_occurrence(pages, counts)
        p = torch.as_tensor(prev, device=dev)
        v = torch.as_tensor(valid, device=dev)
        got = rd.reuse_distance_cuda(p, v)
        torch.cuda.synchronize()
        want = reuse_distance_ref(p, v)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(
                f"reuse kernel != plain at S={S} L={L}: {bad} positions")
        log(f"[reuse kernel vs plain] S={S} L={L}: equal in every integer "
            f"(tolerance 0); first accesses {int((prev < 0).sum())}, pads "
            f"{int((~valid).sum())}")


def phase_mixed_knobs(rates: dict) -> None:
    """Kernel 1 with its own policy and beta on each of 8 rows in one
    launch, against the plain version on the same rows."""
    from repro_torch.core.traffic import TrafficSpec, make_stream
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.storage.tiered_store import (
        POLICY_TO_IDX, StoreConfig, StoreHyper, stream_window_ids)
    B, L, N, W = 8, 4096, 512, 8
    dev = torch.device("cuda")
    streams = [make_stream(TrafficSpec(
        kind="irm", n_requests=L, n_pages=2048 << (b % 3),
        write_fraction=0.3, seed=20 + b)) for b in range(B)]
    pages = np.stack([p for p, _ in streams])
    win = np.tile(stream_window_ids(L, W), (B, 1))
    win[:, L - 64:] = W
    policies = ["ws", "lru", "lfu", "random"] * 2
    betas = [0.5, 0.7, 0.9, 0.7, 0.9, 0.5, 0.7, 0.9]
    hyper = StoreHyper(
        alpha=torch.full((B,), 0.5, device=dev),
        beta=torch.tensor(betas, dtype=torch.float32, device=dev),
        threshold=torch.full((B,), 0.25, device=dev),
        policy_idx=torch.tensor([POLICY_TO_IDX[p] for p in policies],
                                dtype=torch.int32, device=dev))
    cfg = StoreConfig(n_lines=N).static_config()
    args = (cfg, hyper, cs.cold_keys(0, B, dev),
            torch.as_tensor(pages, device=dev),
            torch.as_tensor(np.stack([w for _, w in streams]), device=dev),
            torch.as_tensor(win, device=dev))
    cs.cache_scan_cuda(*args, n_windows=W)  # warm-up
    k_ms, out = cuda_ms(lambda: cs.cache_scan_cuda(*args, n_windows=W),
                        reps=3)
    p_ms, want = cuda_ms(lambda: cs.cache_scan_plain(*args, n_windows=W))
    compare(out, want, "8 rows, mixed policy and beta")
    if not (out["evictions"] > 0).all():
        raise AssertionError("a mixed-knob row never evicted")
    b = cache_scan_bound(policies, out, pages, cfg, W, rates)
    check_over_bound("mixed knobs", k_ms, b["bound_ms"])
    log(f"[mixed knobs] {B} rows x {L} requests, n_lines={N}, {W} windows, "
        f"policies {policies}, betas {betas}, one launch: equal (tolerance "
        f"0: integers exact, f32 bit for bit); kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.1f} ms, {fmt_bound(b)}; evictions "
        f"{out['evictions'].tolist()}")


def mrc_sizes() -> list:
    """64 distinct cache sizes, geometric from 2^8 to 2^18, the one
    nearest 16,384 set to it."""
    sizes = np.round(2.0 ** np.linspace(8, 18, 64)).astype(np.int64)
    sizes[np.argmin(np.abs(sizes - 16384))] = 16384
    if len(set(sizes.tolist())) != 64:
        raise AssertionError("MRC sizes are not distinct")
    return sizes.tolist()


def phase_mrc(spec) -> dict:
    """The MRC route at full width: the full-size deployment under LRU in
    one window, 64 cache sizes from one reuse-distance pass."""
    from repro_torch.kernels import reuse_distance as rd
    from repro_torch.kernels.ref import reuse_distance_ref
    from repro_torch.sim import sweep, tier1_counters
    from repro_torch.sim.engine import fault_owner, stream_for_spec
    from repro_torch.sim.mrc import _bucket_cap
    from repro_torch.storage.tiered_store import partition_streams
    sizes = mrc_sizes()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = sweep(spec, {"store.n_lines": sizes}, mrc="require", stream="off",
                profile=True, device="cuda")
    sweep_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != dict(cache_scan=0, reuse_distance=1):
        raise AssertionError(f"MRC sweep launched {launches}, want no "
                             "cache-scan launch and one reuse launch")
    for pt, rep in zip(res.points, res.reports):
        if not (np.isfinite(rep.response_s) and rep.requests == 2**22):
            raise AssertionError(f"MRC report {pt} not finite / complete")
    rep16 = res.reports[sizes.index(16384)]
    check_report(rep16, tier1_counters(
        spec.replace(**{"store.n_lines": 16384}), device="cuda"),
        "MRC sweep at 16,384 lines")

    # The pass's stages again, one by one, on the same inputs: their times,
    # and the distance array the plain version is held against.
    t0 = time.perf_counter()
    pages, is_write, times, n_pages, W, _ = stream_for_spec(spec)
    owner = fault_owner(spec, pages, times, n_pages)
    t1 = time.perf_counter()
    sh_pages, _, counts, _, _ = partition_streams(
        pages, is_write, n_shards=spec.n_shards, mapping=spec.mapping,
        n_pages=n_pages, n_windows=W, owner=owner)
    t2 = time.perf_counter()
    capb = _bucket_cap(sh_pages.shape[1])
    sh_pages = np.pad(sh_pages, ((0, 0), (0, capb - sh_pages.shape[1])))
    prev, valid = rd.prev_occurrence(sh_pages, counts)
    t3 = time.perf_counter()
    dev = torch.device("cuda")
    p = torch.as_tensor(prev, device=dev)
    v = torch.as_tensor(valid, device=dev)
    rd.reuse_distance_cuda(p, v).cpu()
    t4 = time.perf_counter()
    stages = dict(stream=t1 - t0, partition=t2 - t1,
                  prev_occurrence=t3 - t2, distance=t4 - t3)
    # The sweep's MRC route is its engine stage; what the stages above do
    # not cover is the host histogram and write-back intervals.
    stages["histogram"] = res.profile["engine_dispatch"] - sum(
        stages.values())
    k_ms, got_d = cuda_ms(lambda: rd.reuse_distance_cuda(p, v), reps=3)
    p_ms, want_d = cuda_ms(lambda: reuse_distance_ref(p, v))
    if not torch.equal(got_d, want_d):
        raise AssertionError(
            f"reuse kernel != plain on the full [{p.shape[0]}, {capb}] "
            f"array: {int((got_d != want_d).sum())} positions")
    b = reuse_bound(prev, valid)
    S, L = prev.shape
    log(f"[MRC route] {spec.n_shards} shards x {L} (bucket; loads "
        f"{int(counts.min())}..{int(counts.max())}), {len(sizes)} sizes "
        f"{sizes[0]}..{sizes[-1]}: sweep {sweep_s:.2f} s (MRC pass "
        f"{res.profile['engine_dispatch']:.2f} s, reports "
        f"{res.profile['report_solve']:.3f} s), launches {launches}; "
        f"counters at 16,384 lines equal the cache-scan kernel's in every "
        f"field; stages timed alone: stream {stages['stream']:.2f} s, "
        f"partition {stages['partition']:.2f} s, prev_occurrence "
        f"{stages['prev_occurrence']:.2f} s, distance pass (copies "
        f"included) {stages['distance']:.3f} s, histogram (the MRC pass "
        f"less those) {stages['histogram']:.2f} s; kernel {k_ms:.2f} ms "
        f"(CUDA events), plain {p_ms:.1f} ms, equal on the whole [{S}, {L}] "
        f"array (tolerance 0); {fmt_bound(b)}, {b['compares']} compares; "
        f"miss rate at 16,384 lines {rep16.miss_rate:.6f}")
    return dict(launches=launches["reuse_distance"], max_abs_err=0.0,
                ms=k_ms, plain_ms=p_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], bound_terms=b["bound_terms"],
                compares=b["compares"],
                shape=f"{S}x{L} (the MRC route's rows, full size, lru)")


def phase_megabatch(full_ctr, rates: dict) -> dict:
    """The sweep's megabatch at full width: 4 policies x 2 betas (8 cache
    signatures) x 2 rates, one 2^19 bucket, one launch of 128 rows; then
    that launch's rows against the plain version on their first
    MEGA_PREFIX steps."""
    from repro_torch.kernels import cache_scan as cs
    from repro_torch.sim import sweep
    from repro_torch.storage.tiered_store import POLICY_TO_IDX
    spec = full_size_spec()
    axes = {"store.policy": ["ws", "lru", "lfu", "random"],
            "store.beta": [0.5, 0.7], "lam": [100.0, 200.0]}
    timed = []
    launch = cs.cache_scan_cuda

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        stop.record()
        timed.append((start, stop, args, kw, out))
        return out

    reset_launch_counts()
    cs.cache_scan_cuda = timed_launch
    try:
        t0 = time.perf_counter()
        res = sweep(spec, axes, stream="off", profile=True, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        cs.cache_scan_cuda = launch
    launches = launch_counts()
    if launches != dict(cache_scan=1, reuse_distance=0):
        raise AssertionError(f"megabatch sweep launched {launches}, want "
                             "one cache-scan launch and no reuse launch")
    (start, stop, args, kw, out), = timed
    k_ms = start.elapsed_time(stop)
    for pt, rep in zip(res.points, res.reports):
        vals = (rep.response_s, rep.lam_eff, rep.rho1, rep.rho2,
                rep.miss_rate)
        if not all(np.isfinite(x) for x in vals):
            raise AssertionError(f"report {pt} is not finite: {vals}")
    i = res.points.index({"store.policy": "ws", "store.beta": 0.7,
                          "lam": 200.0})
    check_report(res.reports[i], full_ctr, "(ws, 0.7) sweep point")

    cfg, hyper, keys, pages, writes, win = args
    B, L = pages.shape
    name = {v: k for k, v in POLICY_TO_IDX.items()}
    policies = [name[i] for i in hyper.policy_idx.tolist()]
    knobs = set(zip(policies, hyper.beta.tolist()))
    if len(knobs) != 8:
        raise AssertionError(f"the launch's rows carry {len(knobs)} "
                             "(policy, beta) pairs, want 8")
    W = kw["n_windows"]
    mega_b = cache_scan_bound(policies, out, pages.cpu().numpy(), cfg, W,
                              rates)

    # The launch's rows against the plain version on their first
    # MEGA_PREFIX steps, with their own knobs, keys and window ids.
    P = MEGA_PREFIX
    pre = (cfg, hyper, keys, *(x[:, :P].contiguous()
                               for x in (pages, writes, win)))
    pk_ms, pout = cuda_ms(lambda: cs.cache_scan_cuda(*pre, **kw))
    pp_ms, want = cuda_ms(lambda: cs.cache_scan_plain(*pre, **kw))
    err = compare(pout, want, f"megabatch rows, first {P} steps")
    pre_b = cache_scan_bound(policies, pout, pages[:, :P].cpu().numpy(),
                             cfg, W, rates)
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.profile.items()
                       if isinstance(v, float))
    log(f"[megabatch] {len(res.points)} points, 8 cache signatures, one "
        f"launch of {B} rows x {L} steps (n_lines={cfg.n_lines}, {W} "
        f"windows): kernel {k_ms:.1f} ms (CUDA events), {fmt_bound(mega_b)}; "
        f"sweep {wall:.2f} s; profile: {stages}; (ws, 0.7) counters equal "
        f"phase 5's tier1_counters; every report finite; launches "
        f"{launches}")
    log(f"[megabatch, kernel vs plain] the launch's {B} rows (policies x "
        f"betas {sorted(knobs)}), first {P} steps, n_lines={cfg.n_lines}, "
        f"{W} windows: equal (tolerance 0: integers exact, f32 bit for "
        f"bit); kernel {pk_ms:.1f} ms, plain {pp_ms:.1f} ms, "
        f"{fmt_bound(pre_b)}; misses/row "
        f"{int(pout['misses'].min())}..{int(pout['misses'].max())}, "
        f"evictions/row "
        f"{int(pout['evictions'].min())}..{int(pout['evictions'].max())}")
    return dict(sweep_launches=launches["cache_scan"], sweep_ms=k_ms,
                sweep_bound_ms=mega_b["bound_ms"],
                sweep_bound_by=mega_b["bound_by"],
                sweep_bound_terms=mega_b["bound_terms"],
                sweep_bound_terms_block_barrier=mega_b[
                    "bound_terms_block_barrier"],
                sweep_plan=mega_b["plan"],
                sweep_shape=f"{B}x{L} rows (16 points, 8 signatures, mixed "
                            f"policy and beta), n_lines={cfg.n_lines}, "
                            f"n_windows={W}",
                sweep_prefix_ms=pk_ms, sweep_prefix_plain_ms=pp_ms,
                sweep_prefix_max_abs_err=err,
                sweep_prefix_bound_ms=pre_b["bound_ms"],
                sweep_prefix_bound_by=pre_b["bound_by"],
                sweep_prefix_bound_terms=pre_b["bound_terms"],
                sweep_prefix_shape=f"{B}x{P} (first {P} steps of the "
                                   f"megabatch rows)")


def _rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    den = float(want.double().abs().max().clamp(min=1e-30))
    return float((got.double() - want.double()).abs().max()) / den


def _bf16_step_excess(got, want) -> float:
    """Largest ``|got - want| / (FLASH_ULP |want| + FLASH_ABS)``, element
    by element: at most 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (FLASH_ULP * w.abs() + FLASH_ABS)).max())


def _with_hidden(run_fn):
    """``run_fn()`` (a serve) with the final hidden state that each step
    unembeds recorded: ``(result, f32 [steps, B, d])``."""
    from repro_torch.serving import engine as eng
    hidden = []
    unembed0 = eng.unembed_greedy

    def hook(x, w):
        hidden.append(x.float())
        return unembed0(x, w)
    eng.unembed_greedy = hook
    try:
        res = run_fn()
    finally:
        eng.unembed_greedy = unembed0
    return res, torch.stack(hidden)


def _hidden_err(h, ref) -> float:
    """Largest ``|h - ref| / |ref|`` of one sequence's hidden state at one
    step, over the steps both runs made."""
    n = min(len(h), len(ref))
    return float(((h[:n] - ref[:n]).norm(dim=-1)
                  / ref[:n].norm(dim=-1)).max())


def _flash_bound(q, k, window=None) -> dict:
    """Causal (sliding-window) GQA attention on q ``[B, H, S, hd]``: 4
    flops a visible (query, key) pair and head dim (QK^T and PV) at the
    bf16 tensor-core rate; q, k, v read once and the output written once
    at HBM's rate."""
    B, H, S, hd = q.shape
    pairs = sum(min(i + 1, window or S) for i in range(S))
    flops = 4 * B * H * pairs * hd
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / BF16_FLOPS_PER_S)),
                flops=flops, bytes=nbytes)


def _paged_bound(calls, page: int) -> dict:
    """Decode attention over both tiers of one layer: every live K and V
    row of the owned pages read once (each page from one tier; inside the
    sliding window where there is one), q read and the partials written,
    at HBM's rate; 4 flops a live token, head dim and query head at the
    f32 rate of the data sheet (67 TFLOP/s)."""
    nbytes = flops = 0
    for q, pool, slot, live, window in calls:
        B, H, hd = q.shape
        KV = pool.shape[3]
        tok = torch.arange(slot.shape[1] * page, device=slot.device)
        n_live = live.to(slot.device)[:, None]
        on = (slot >= 0).repeat_interleave(page, 1) & (tok[None] < n_live)
        if window > 0:
            on &= tok[None] >= n_live - window
        n = int(on.sum())
        nbytes += n * 2 * KV * hd * pool.element_size() + 4 * q.numel() \
            + 4 * (B * H * hd + 2 * B * H)
        flops += 4 * n * hd * H
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / 67e12)),
                bytes=nbytes, flops=flops)


def _copy_bound(n_rows: int, row_bytes: int) -> dict:
    """Each moved byte read once and written once, at HBM's rate."""
    return dict(_largest(dict(bytes_ms=1e3 * 2 * n_rows * row_bytes
                              / HBM_BYTES_PER_S)), bytes=2 * n_rows * row_bytes)


def _profile_decode(cfg, params, run, S: dict, dev, tag: str = "serve"
                    ) -> None:
    """Where a decode step's time goes: PROFILE_STEPS more steps of the
    kernel run (its pools hold pages past the last token), after one
    untraced step, under ``torch.profiler``; kernel time by group, its
    share of the run's own (untraced) step time, kernel launches and
    synchronizations a step. The profiler's own host cost makes the
    traced steps far slower, so their wall time is not the step's."""
    from repro_torch.serving import engine as eng
    page = cfg.page_size
    sc = eng.ServeConfig(max_seq=-(-(S["prompt"] + S["new"]) // page) * page,
                         batch_local=S["requests"],
                         hbm_fraction=S["hbm_fraction"])
    dec = eng.make_decode_step(cfg, sc)
    state = run.state
    tok = torch.as_tensor(run.tokens[:, -1], device=dev)
    state, (tok, _) = dec(params, state, tok)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            state, (tok, _) = dec(params, state, tok)
        torch.cuda.synchronize()
    step_ms = 1e3 * run.decode_s / (S["new"] - 1)
    groups = dict(paged=0.0, gemm=0.0, other=0.0)
    kernels = syncs = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += 1
            name = e.name.lower()
            g = ("paged" if "paged_attention" in name else
                 "gemm" if any(x in name for x in ("gemm", "nvjet", "cutlass",
                                                   "sm90_xmma")) else "other")
            groups[g] += e.time_range.elapsed_us() / 1e3 / PROFILE_STEPS
        elif "Synchronize" in e.name:
            syncs += 1
    busy = sum(groups.values())
    if run.state.kv is not None and groups["paged"] <= 0:
        raise AssertionError("the profiled decode steps ran no paged kernel")
    log(f"[{tag}, profile] {PROFILE_STEPS} decode steps after the run "
        f"(torch.profiler): kernels {busy:.2f} ms a step, "
        f"{100 * busy / step_ms:.1f}% of the run's {step_ms:.2f} ms step: "
        f"paged attention {groups['paged']:.2f} ms, GEMMs "
        f"{groups['gemm']:.2f} ms, other {groups['other']:.2f} ms; "
        f"{kernels / PROFILE_STEPS:.0f} kernel launches and "
        f"{syncs / PROFILE_STEPS:.1f} synchronizations a step")


def phase_serve(dev=torch.device("cuda")) -> list:
    """Serving at full width through ``repro_torch.launch.serve``; returns
    the flash-attention, paged-attention and page-copy kernel entries."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels.ref import (attention_ref, page_copy_ref,
                                         paged_attention_ref)
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = SERVE
    t0 = time.perf_counter()
    cfg, params = serve.build(S["arch"], full=S["full"], seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = cfg.total_params()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    steps = S["new"] - 1
    L = cfg.n_layers

    # Capture kernel inputs from the run: layer 0's prefill q/k/v, the
    # last decode step's paged launches at the first and last layers, and
    # the first prefill population into tier 2.
    calls = dict(paged=0)
    cap: dict = {}
    flash0, paged0, copy0 = fa.flash_attention, pa.paged_attention, \
        pg.page_copy
    last = (steps - 1) * 2 * L

    def flash_hook(q, k, v, **kw):
        if "flash" not in cap:
            cap["flash"] = (q.clone(), k.clone(), v.clone(), kw)
        return flash0(q, k, v, **kw)

    def paged_hook(q, pool, slot, live, window=0):
        i = calls["paged"] - last
        if i in (0, 1, 2 * L - 2, 2 * L - 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window)

    def copy_hook(dst, src, di, si):
        if "copy" not in cap:
            cap["copy"] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    fa.flash_attention, pa.paged_attention, pg.page_copy = \
        flash_hook, paged_hook, copy_hook
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        run, run_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"],
            promote_every=S["promote_every"]))
    finally:
        fa.flash_attention, pa.paged_attention, pg.page_copy = \
            flash0, paged0, copy0
    launches = serve.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(launches[k] for k in ("flash_attention", "paged_attention",
                                     "page_copy")) or \
            launches["ssd_scan"] or launches["rglru_scan"]:
        raise AssertionError(f"a serving kernel never launched, or a scan "
                             f"kernel did: {launches}")
    if launches["flash_attention"] != L or \
            launches["paged_attention"] != 2 * L * steps:
        raise AssertionError(f"launches {launches}, want {L} flash and "
                             f"{2 * L * steps} paged")
    kv = run.state.kv
    B = S["requests"]
    if run.tokens.shape != (B, S["new"]) or not np.isfinite(
            run.logprobs).all() or not ((run.tokens >= 0)
                                        & (run.tokens < cfg.vocab)).all():
        raise AssertionError("serve output is not finite tokens/logprobs "
                             "of the expected shape")
    if not (kv.lengths == S["prompt"] + steps).all():
        raise AssertionError(f"lengths {kv.lengths.tolist()}")
    t1, t2 = int(kv.t1_reads[0]), int(kv.t2_reads[0])
    log(f"[serve] {cfg.name} ({n_params / 1e9:.2f} B params, bf16, seed 0; "
        f"init {init_s:.1f} s), {B} requests x {S['prompt']} prompt tokens, "
        f"{steps} decode steps, hbm_fraction {S['hbm_fraction']}: prefill "
        f"{run.prefill_s:.3f} s, decode {run.decode_s:.3f} s "
        f"({B * steps / run.decode_s:.1f} tok/s, "
        f"{1e3 * run.decode_s / steps:.2f} ms/step); tier-1 page reads {t1}, "
        f"tier-2 {t2}, evictions {int(kv.evictions[0])}, write-backs "
        f"{int(kv.writebacks[0])}; OL weights {kv.ols.weights.tolist()}; "
        f"launches {launches}; peak memory {peak_gb:.1f} GB")

    # The whole path again with the plain versions selected, fed the
    # kernel run's tokens.
    forced = torch.as_tensor(run.tokens[:, :-1], device=dev)
    serve.reset_launch_counts()
    with plain_versions():
        plain, plain_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"],
            forced=forced))
    if any(serve.launch_counts().values()):
        raise AssertionError("the plain run launched a kernel")
    pkv = plain.state.kv
    for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads", "t2_reads",
              "evictions", "writebacks"):
        if not torch.equal(getattr(kv, f), getattr(pkv, f)):
            raise AssertionError(f"kernel run != plain run in {f}")
    for x, y in zip(kv.meta + kv.ols, pkv.meta + pkv.ols):
        if not torch.equal(x, y):
            raise AssertionError("kernel run != plain run in the metadata "
                                 "or the learner")
    if kv.key != pkv.key or not torch.equal(
            kv.ols.weights.view(torch.int32), pkv.ols.weights.view(torch.int32)):
        raise AssertionError("kernel run != plain run in the key / weights")
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())
    h_err = _hidden_err(run_h, plain_h)
    # The noise floor: the plain path again, the first CONTROL_STEPS decode
    # steps, with only the prefill attention's summation order changed
    # (blockwise attention in 512-blocks instead of one softmax).
    from repro_torch.models.attention import blockwise_attention
    from repro_torch.serving import engine as eng
    n_ctl = min(CONTROL_STEPS, steps)
    n = n_ctl + 1
    short = dict(new=n, hbm_fraction=S["hbm_fraction"],
                 promote_every=S["promote_every"], forced=forced[:, :n_ctl],
                 max_seq=kv.page_slot.shape[1] * cfg.page_size)
    flash_plain = fa.flash_attention
    fa.flash_attention = lambda q, k, v, **kw: blockwise_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2)
    try:
        with plain_versions():
            ctl, ctl_h = _with_hidden(
                lambda: serve.serve(cfg, params, prompts, **short))
    finally:
        fa.flash_attention = flash_plain
    floor = float(np.abs(ctl.logprobs - plain.logprobs[:, :n]).max())
    head = float(np.abs(run.logprobs[:, :n] - plain.logprobs[:, :n]).max())
    h_floor = _hidden_err(ctl_h, plain_h)
    h_head = _hidden_err(run_h[:n], plain_h)
    # Planted faults through the same comparison, on the kernel path and
    # the first n_ctl steps: the tier-2 partial dropped from the merge, and
    # the tier-2 launches skipping page 0 of every sequence (a prompt page
    # that lives only in tier 2). Each must fail the bar.
    comb0, paged_k = eng.combine_partials, pa.paged_attention
    seen = dict(n=0)

    def skip_page0(q, pool, slot, live, window=0):
        seen["n"] += 1
        if seen["n"] % 2 == 0:   # the engine launches tier 1, then tier 2
            slot = slot.clone()
            slot[:, 0] = -1
        return paged_k(q, pool, slot, live, window)
    faults = {}
    for name, patch in (
            ("tier-2 partial dropped",
             lambda: setattr(eng, "combine_partials",
                             lambda parts: comb0(parts[:1]))),
            ("page 0 skipped in tier 2",
             lambda: setattr(pa, "paged_attention", skip_page0))):
        patch()
        try:
            bad, bad_h = _with_hidden(
                lambda: serve.serve(cfg, params, prompts, **short))
        finally:
            eng.combine_partials, pa.paged_attention = comb0, paged_k
        faults[name] = (
            _hidden_err(bad_h, plain_h),
            float(np.abs(bad.logprobs - plain.logprobs[:, :n]).max()))
        del bad, bad_h
    log(f"[serve, plain path] the same run with the plain versions, "
        f"teacher-forced on the kernel run's tokens: prefill "
        f"{plain.prefill_s:.3f} s, decode {plain.decode_s:.3f} s; tier state "
        f"and learner equal (integers exact, f32 weights bit for bit); "
        f"final hidden state |h - h_plain| / |h_plain| largest "
        f"{h_err:.3e} over all steps, {h_head:.3e} over the first {n_ctl} "
        f"(tolerance {HIDDEN_TOL}); noise floor (plain vs plain with "
        f"blockwise prefill attention, first {n_ctl} steps) {h_floor:.3e}; "
        f"planted faults (kernel path, first {n_ctl} steps): "
        + "; ".join(f"{k} {v[0]:.3e} (logprobs {v[1]:.3e})"
                    for k, v in faults.items())
        + f"; logprobs max |diff| {lp_err:.3e} over all steps, {head:.3e} "
        f"over the first {n_ctl} (tolerance {LOGPROB_TOL}), noise floor "
        f"{floor:.3e}; greedy tokens equal in "
        f"{int((plain.tokens == run.tokens).sum())} of {run.tokens.size}")
    if not h_err <= HIDDEN_TOL:
        raise AssertionError(f"hidden states differ by {h_err} > "
                             f"{HIDDEN_TOL}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"logprobs differ by {lp_err} > {LOGPROB_TOL}")
    for name, (e, _) in faults.items():
        if not e > HIDDEN_TOL:
            raise AssertionError(f"planted fault '{name}' passes the "
                                 f"comparison: {e} <= {HIDDEN_TOL}")
    del plain, pkv, ctl, run_h, plain_h, ctl_h

    # Flash attention: layer 0's prefill q/k/v, all 8 sequences.
    q, k, v, kw = cap["flash"]
    fa.flash_attention_cuda(q, k, v, **kw)  # warm-up
    f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    fp_ms, want = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_err = float((got.float() - want.float()).abs().max())
    f_rel = float(((got.float() - want.float()).abs()
                   / (want.float().abs() + 1)).max())
    f_exc = _bf16_step_excess(got, want)
    # A planted fault: the last 64-query tile of every head off by 1/32.
    bad = got.clone()
    bad[:, :, -64:] = (bad[:, :, -64:].float() * (1 + FLASH_FAULT)).to(
        bad.dtype)
    bad_exc = _bf16_step_excess(bad, want)
    bad_rel = float(((bad.float() - want.float()).abs()
                     / (want.float().abs() + 1)).max())
    del bad
    log(f"[serve, flash vs plain] max |diff| {f_err:.3e}, |diff| / (|plain| "
        f"+ 1) {f_rel:.3e} (tolerance {FLASH_TOL}), |diff| / ({FLASH_ULP:g} "
        f"|plain| + {FLASH_ABS:g}) {f_exc:.3f} (tolerance 1); planted fault "
        f"(last query tile x (1 + {FLASH_FAULT:g})): {bad_exc:.3f} and "
        f"{bad_rel:.3e}")
    if not (f_rel <= FLASH_TOL and f_exc <= 1):
        raise AssertionError(f"flash kernel != plain: {f_err} (rel {f_rel}, "
                             f"element-wise {f_exc})")
    if not bad_exc > 1:
        raise AssertionError("the flash check passes a planted fault")
    sdpa = dict(is_causal=True, enable_gqa=True)
    torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa)
    f_lib, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **sdpa), reps=3)
    fb = _flash_bound(q, k)
    log(f"[serve, flash vs plain] layer 0's prefill, q {list(q.shape)} "
        f"(strided [B, S, H, hd] views), causal: max |diff| {f_err:.3e}, "
        f"element-wise {f_exc:.3f} of its bar; kernel "
        f"{f_ms:.3f} ms, plain {fp_ms:.1f} ms, scaled_dot_product_attention {f_lib:.3f} ms, "
        f"{fmt_bound(fb)}")
    del got, want

    # Paged attention: the last decode step's tier-1 and tier-2 launches at
    # the first and the last layer (the pools hold the state of that step:
    # nothing wrote those layers after it).
    pcalls = cap["paged"]
    p_err = 0.0
    for i, (qq, pool, slot, live, window) in enumerate(pcalls):
        got = pa.paged_attention_cuda(qq, pool, slot, live, window)
        want = paged_attention_ref(qq, pool, slot, live, window)
        for g, w, name in zip(got, want, ("acc", "m", "l")):
            e = _rel_err(g, w)
            p_err = max(p_err, e)
            if not e <= PAGED_REL_TOL:
                raise AssertionError(f"paged kernel != plain in {name} "
                                     f"(call {i}): {e}")
    first = pcalls[:2]
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in first],
                      reps=10)
    conv = [_paged_inputs(c) for c in first]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in first],
                       reps=3)
    pb = _paged_bound(first, cfg.page_size)
    n_split = pa.split_plan(B, cfg.n_kv_heads, kv.page_slot.shape[1],
                            cfg.page_size)
    log(f"[serve, paged vs plain] last decode step, layers 0 and {L - 1}, "
        f"tier 1 and tier 2: largest |diff| / largest |plain| of acc, m, l "
        f"{p_err:.3e} (tolerance {PAGED_REL_TOL}); layer 0, both tiers "
        f"(n_split, span {n_split}): kernel {p_ms:.4f} ms in a loop of "
        f"calls, {p_graph:.4f} ms from a CUDA graph of its launches alone, "
        f"plain {pp_ms:.3f} ms, "
        f"{fmt_bound(pb)}")

    # Page copy, byte for byte on the full-width pools: the first prefill
    # population (layer 0 into tier 2), a whole-slot write-back (tier-1
    # slots of resident pages down to their tier-2 slots) and a whole-slot
    # promotion (tier-2 pages into two tier-1 slots a hand-made state
    # frees).
    dst, src, di, si = cap["copy"]
    pool1, pool2 = kv.pool1, kv.pool2
    res = (kv.page_slot >= 0).reshape(-1).nonzero().reshape(-1)[:8]
    wb_dst = kv.t2_slot.reshape(-1)[res]
    wb_src = kv.page_slot.reshape(-1)[res]
    non = (kv.page_slot < 0).reshape(-1).nonzero().reshape(-1)[:2]
    pr_dst = kv.page_slot.reshape(-1)[res[:2]]
    pr_src = kv.t2_slot.reshape(-1)[non]
    cases = (("prefill population", pool2, dst, src, di, si),
             ("write-back", pool2, pool2, pool1, wb_dst, wb_src),
             ("promotion", pool1, pool1, pool2, pr_dst, pr_src))
    for name, whole, d, s_, i_d, i_s in cases:
        off = (d.data_ptr() - whole.data_ptr()) // whole.element_size()
        outs = []
        for fn in (pg.page_copy_cuda, page_copy_ref):
            buf = whole.clone()
            view = buf.view(-1)[off:].as_strided(d.shape, d.stride())
            fn(view, s_, i_d, i_s)
            torch.cuda.synchronize()
            outs.append(buf)
        if not torch.equal(outs[0].view(torch.uint8).view(-1),
                           outs[1].view(torch.uint8).view(-1)):
            raise AssertionError(f"page copy kernel != plain ({name})")
        del outs, buf
    row_bytes = dst[0].numel() * dst.element_size()
    live = ((di >= 0) & (si >= 0))
    buf = pool2.clone()
    view = buf.view(-1)[(dst.data_ptr() - pool2.data_ptr())
                        // pool2.element_size():].as_strided(dst.shape,
                                                              dst.stride())
    c_ms, _ = cuda_ms(lambda: pg.page_copy_cuda(view, src, di, si), reps=5)
    cp_ms, _ = cuda_ms(lambda: page_copy_ref(view, src, di, si))
    ldi = di[live].long().to(dev)
    lsi = si[live].long().to(dev)

    def library():
        view[ldi] = src[lsi]
    library()
    c_lib, _ = cuda_ms(library, reps=5)
    del buf, view
    cb = _copy_bound(int(live.sum()), row_bytes)
    log(f"[serve, page copy vs plain] prefill population (layer 0, "
        f"{int(live.sum())} pages of {row_bytes} B into tier 2), a "
        f"whole-slot write-back ({len(res)} slots of "
        f"{pool1[0].numel() * 2} B) and a whole-slot promotion (2 slots): "
        f"equal byte for byte; prefill population: kernel {c_ms:.3f} ms, "
        f"plain {cp_ms:.3f} ms, dst[di] = src[si] {c_lib:.3f} ms, "
        f"{fmt_bound(cb)}")

    _profile_decode(cfg, params, run, S, dev)

    def entry(name, src_file, replaces, **kw):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{src_file}",
                    replaces=replaces, launches=launches[name], **kw)
    return [
        entry("flash_attention", "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:77", max_abs_err=f_err,
              ms=f_ms, plain_ms=fp_ms, bound_ms=fb["bound_ms"],
              bound_by=fb["bound_by"], bound_terms=fb["bound_terms"],
              library_ms=f_lib,
              shape=f"q {list(q.shape)}, k/v {list(k.shape)}, causal, bf16 "
                    f"(layer 0 of the prefill)"),
        entry("paged_attention", "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:89", max_abs_err=p_err,
              ms=p_ms, plain_ms=pp_ms, bound_ms=pb["bound_ms"],
              bound_by=pb["bound_by"], bound_terms=pb["bound_terms"],
              library_ms=None, max_abs_err_kind="relative to the largest "
              "|plain| of each field", ms_graph=p_graph,
              ms_kind="a loop of wrapper calls on the captured inputs; "
              "ms_graph: a CUDA graph of the launches alone, on inputs "
              "already in f32 / int32 on the card",
              shape=f"both tiers of layer 0 at the last decode step, "
                    f"q {list(first[0][0].shape)}, pools "
                    f"{list(pool1.shape)} / {list(pool2.shape)} bf16"),
        entry("page_copy", "page_copy.cu",
              "src/repro/kernels/page_gather.py:37", max_abs_err=0.0,
              ms=c_ms, plain_ms=cp_ms, bound_ms=cb["bound_ms"],
              bound_by=cb["bound_by"], bound_terms=cb["bound_terms"],
              library_ms=c_lib,
              shape=f"{int(live.sum())} rows of {row_bytes} B into one layer "
                    f"of tier 2 (prefill population)"),
    ]


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def _serve_pair(tag: str, cfg, params, prompts, S: dict, dev):
    """The full-width serve through ``repro_torch.launch.serve`` with the
    kernels (launch counts set to 0 just before it and read just after),
    its output checked, and the same serve with the plain versions
    selected, teacher-forced on its tokens. Returns ``(run, run_h,
    launches, plain, plain_h, forced, peak_gb)``."""
    from repro_torch.kernels import plain_versions
    from repro_torch.launch import serve
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    run, run_h = _with_hidden(lambda: serve.serve(
        cfg, params, prompts, new=S["new"],
        hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"]))
    launches = serve.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    B, steps = S["requests"], S["new"] - 1
    # Token ids range over the embedding's rows: the vocabulary padded to a
    # multiple of 256, whose extra rows hold random weights here and can
    # win the argmax, as in the reference's unembed_greedy.
    n_rows = params["embed"].shape[0]
    if run.tokens.shape != (B, S["new"]) or not np.isfinite(
            run.logprobs).all() or not ((run.tokens >= 0)
                                        & (run.tokens < n_rows)).all():
        raise AssertionError(
            f"[{tag}] serve output is not finite tokens / logprobs of the "
            f"expected shape: {run.tokens.shape}, tokens in "
            f"[{run.tokens.min()}, {run.tokens.max()}] (rows {n_rows}), "
            f"finite logprobs {np.isfinite(run.logprobs).mean():.3f}")
    if not torch.isfinite(run_h).all() or run_h.shape[0] != S["new"]:
        raise AssertionError(f"[{tag}] hidden states not finite")
    forced = torch.as_tensor(run.tokens[:, :-1], device=dev)
    serve.reset_launch_counts()
    with plain_versions():
        plain, plain_h = _with_hidden(lambda: serve.serve(
            cfg, params, prompts, new=S["new"],
            hbm_fraction=S["hbm_fraction"], promote_every=S["promote_every"],
            forced=forced))
    if any(serve.launch_counts().values()):
        raise AssertionError(f"[{tag}] the plain run launched a kernel")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {cfg.name} ({n_params / 1e9:.2f} B params, bf16, "
        f"seed 0), {B} requests x {S['prompt']} prompt tokens, {steps} "
        f"decode steps: prefill {run.prefill_s:.3f} s, decode "
        f"{run.decode_s:.3f} s ({B * steps / run.decode_s:.1f} tok/s, "
        f"{1e3 * run.decode_s / steps:.2f} ms/step); launches {launches}; "
        f"peak memory {peak_gb:.1f} GB; plain run: prefill "
        f"{plain.prefill_s:.3f} s, decode {plain.decode_s:.3f} s")
    return run, run_h, launches, plain, plain_h, forced, peak_gb


def _rec_err(a, b) -> float:
    """Largest relative difference of the recurrent states, leaf by leaf
    and layer by layer (``|a - b|`` over the largest ``|b|`` of the
    layer's leaf)."""
    err = 0.0
    for ra, rb in ((a.rec, b.rec), (a.rec_tail, b.rec_tail)):
        for da, db in zip(ra, rb):
            for k in da:
                x, y = da[k].float(), db[k].float()
                for i in range(x.shape[0] if x.dim() > 2 else 1):
                    xi, yi = (x[i], y[i]) if x.dim() > 2 else (x, y)
                    err = max(err, _rel_err(xi, yi))
    return err


def _short_runs(cfg, params, prompts, S: dict, forced, plain_h, plain_lp,
                runs: dict, n_steps: int) -> dict:
    """The first ``n_steps`` decode steps of the teacher-forced serve once
    per entry of ``runs`` (name -> (patch, unpatch, plain?)): each one's
    largest hidden-state difference and logprob gap against the plain
    run."""
    from repro_torch.kernels import plain_versions
    from repro_torch.launch import serve
    n_ctl = min(n_steps, S["new"] - 1)
    out = {}
    for name, (patch, unpatch, plain) in runs.items():
        patch()
        try:
            if plain:
                with plain_versions():
                    res, h = _with_hidden(lambda: serve.serve(
                        cfg, params, prompts, new=n_ctl + 1,
                        hbm_fraction=S["hbm_fraction"],
                        promote_every=S["promote_every"],
                        forced=forced[:, :n_ctl], max_seq=S["max_seq"]))
            else:
                res, h = _with_hidden(lambda: serve.serve(
                    cfg, params, prompts, new=n_ctl + 1,
                    hbm_fraction=S["hbm_fraction"],
                    promote_every=S["promote_every"],
                    forced=forced[:, :n_ctl], max_seq=S["max_seq"]))
        finally:
            unpatch()
        out[name] = (_hidden_err(h, plain_h), float(np.abs(
            res.logprobs - plain_lp[:, :n_ctl + 1]).max()))
        del res, h
    return out


def _check_bars(tag: str, h_err: float, lp_err: float, control: dict,
                faults: dict, n_ctl: int, tol: float = HIDDEN_TOL) -> None:
    log(f"[{tag}, plain path] final hidden state |h - h_plain| / |h_plain| "
        f"largest {h_err:.3e} over all steps (tolerance {tol}); "
        + "; ".join(f"{k} (first {n_ctl} steps) {v[0]:.3e} (logprobs "
                    f"{v[1]:.3e})" for k, v in {**control, **faults}.items())
        + f"; logprobs max |diff| {lp_err:.3e} (tolerance {LOGPROB_TOL})")
    if not h_err <= tol:
        raise AssertionError(f"[{tag}] hidden states differ by {h_err} > "
                             f"{tol}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"[{tag}] logprobs differ by {lp_err} > "
                             f"{LOGPROB_TOL}")
    for name, (e, _) in control.items():
        if not e <= tol:
            raise AssertionError(f"[{tag}] the noise floor '{name}' {e} is "
                                 f"above the bar {tol}")
    for name, (e, _) in faults.items():
        if not e > tol:
            raise AssertionError(f"[{tag}] planted fault '{name}' passes the "
                                 f"comparison: {e} <= {tol}")


def _ssd_bound(x, Bm, chunk: int) -> dict:
    """The SSD scan's least time: x, dt, B, C read once and y and the final
    state written once at HBM's rate (``bytes_ms``); the products at the
    bf16 tensor-core rate with C B^T counted once per (sequence, chunk),
    as B and C are shared by the heads (``ops_shared_cb_ms``): C B^T and
    (CB * decay)(dt x) over the q (q + 1) / 2 causal pairs t >= s of a
    chunk of q steps (2 N and 2 P flops a pair; y sums over s <= t only),
    C h and B^T x (2 q N P each). Beside them, not applied, the operations
    with C B^T counted once per head (``ops_ms``, the count before the
    kernel shared it)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    cb = Bsz * sum(q * (q + 1) // 2 * 2 * N for q in lens)
    rest = Bsz * H * sum(q * (q + 1) // 2 * 2 * P + 4 * q * N * P
                         for q in lens)
    nbytes = (2 * x.numel() * x.element_size() + 4 * Bsz * S * H
              + 2 * Bm.numel() * Bm.element_size() + 4 * H
              + 4 * Bsz * H * N * P)
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_shared_cb_ms=1e3 * (cb + rest)
                              / BF16_FLOPS_PER_S)),
                bound_terms_per_head_cb=dict(
                    ops_ms=1e3 * (H * cb + rest) / BF16_FLOPS_PER_S),
                flops=cb + rest, bytes=nbytes)


# f32 operations an RG-LRU element takes: two gates (a multiply-add, an
# exp, an add and a divide each), log a, a, 1 - a^2 (an exp, a subtract, a
# max, a square root), i u, the product and the update's multiply-add.
RGLRU_OPS = 21


def _rglru_bound(u) -> dict:
    """u read once and h written once at HBM's rate (the five [W] vectors
    too); RGLRU_OPS f32 operations an element at the data sheet's f32 rate
    (67 TFLOP/s)."""
    nbytes = 2 * u.numel() * u.element_size() + 5 * 4 * u.shape[-1]
    flops = RGLRU_OPS * u.numel()
    return dict(_largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                              ops_ms=1e3 * flops / 67e12)),
                flops=flops, bytes=nbytes)


def phase_ssd_serve(dev=torch.device("cuda")) -> dict:
    """Phase 11: mamba2-370m served at full width through
    ``repro_torch.launch.serve``; returns the SSD-scan kernel's entry."""
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    S = SSD_SERVE
    tag = "ssd serve"
    gc.collect()  # the previous phase's model
    torch.cuda.empty_cache()
    cfg, params = serve.build(S["arch"], full=True, seed=0, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    S = dict(S, max_seq=-(-(S["prompt"] + S["new"]) // cfg.page_size)
             * cfg.page_size)
    cap = {}
    scan0, cuda0 = ks.ssd_scan, ks.ssd_scan_cuda

    def cuda_hook(x, dt, A, Bm, Cm, chunk):  # the kernel's own inputs
        if "ssd" not in cap:
            cap["ssd"] = (x.clone(), dt.clone(), A.clone(), Bm.clone(),
                          Cm.clone(), chunk)
        return cuda0(x, dt, A, Bm, Cm, chunk)
    ks.ssd_scan_cuda = cuda_hook
    try:
        run, run_h, launches, plain, plain_h, forced, _ = _serve_pair(
            tag, cfg, params, prompts, S, dev)
    finally:
        ks.ssd_scan_cuda = cuda0
    if launches["ssd_scan"] != cfg.n_layers or launches["ssd_scan"] != sum(
            launches.values()) or run.state.kv is not None:
        raise AssertionError(f"[{tag}] launches {launches}, want "
                             f"{cfg.n_layers} ssd_scan and nothing else")
    rec_err = _rec_err(run.state, plain.state)
    h_err = _hidden_err(run_h, plain_h)
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())

    # The noise floor: the plain path with chunks of half the length (the
    # same scan, summed in another order). The planted fault: layer 0's
    # handed-off SSD state zeroed, on the kernel path.
    def half_chunk(x, dt, A, Bm, Cm, *, chunk):
        return scan0(x, dt, A, Bm, Cm, chunk=chunk // 2)
    block0 = tr.ssd_block
    seen = dict(n=0)

    def zero_state(*a, **kw):
        out, st = block0(*a, **kw)
        seen["n"] += 1
        if st is not None and seen["n"] == 1:
            st = dict(st, h=torch.zeros_like(st["h"]))
        return out, st
    runs = {
        "noise floor (plain, chunk / 2)": (
            lambda: setattr(ks, "ssd_scan", half_chunk),
            lambda: setattr(ks, "ssd_scan", scan0), True),
        "fault: layer 0's handed-off state zeroed": (
            lambda: setattr(tr, "ssd_block", zero_state),
            lambda: setattr(tr, "ssd_block", block0), False)}
    short = _short_runs(cfg, params, prompts, S, forced, plain_h,
                        plain.logprobs, runs, CONTROL_STEPS)
    control = {k: v for k, v in short.items() if k.startswith("noise")}
    faults = {k: v for k, v in short.items() if k.startswith("fault")}
    log(f"[{tag}, plain path] recurrent states after the last step, kernel "
        f"run vs plain run: largest |diff| / largest |plain| {rec_err:.3e}")
    _check_bars(tag, h_err, lp_err, control, faults, CONTROL_STEPS,
                SSD_HIDDEN_TOL)
    del plain, plain_h

    # The kernel against its plain version on layer 0's prefill inputs.
    x, dt, A, Bm, Cm, chunk = cap["ssd"]
    ks.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)  # warm-up
    k_ms, (y, h) = cuda_ms(lambda: ks.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk),
                           reps=5)
    p_ms, (yp, hp) = cuda_ms(lambda: ks.ssd_scan_plain(x, dt, A, Bm, Cm,
                                                        chunk))
    y_err = float((y.float() - yp.float()).abs().max())
    y_exc = _bf16_step_excess(y, yp)
    h_rel = _rel_err(h, hp)
    # The same inputs in f32: the kernel's arithmetic without bf16 rounding.
    f32 = [t.float() for t in (x, Bm, Cm)]
    y32, h32 = ks.ssd_scan_cuda(f32[0], dt, A, f32[1], f32[2], chunk)
    y32p, h32p = ks.ssd_scan_plain(f32[0], dt, A, f32[1], f32[2], chunk)
    y32_rel = _rel_err(y32, y32p)
    Bsz, S_, H = dt.shape
    cum_max = float((dt * A).reshape(Bsz, S_ // chunk, chunk, H).sum(2)
                    .abs().max())
    bad = y.clone()
    bad[:, -64:] = (bad[:, -64:].float() * (1 + FLASH_FAULT)).to(bad.dtype)
    bad_exc = _bf16_step_excess(bad, yp)
    del bad, y32, h32, y32p, h32p, f32
    b = _ssd_bound(x, Bm, chunk)
    log(f"[{tag}, ssd_scan vs plain] layer 0's prefill, x {list(x.shape)} "
        f"bf16, N {Bm.shape[-1]}, chunk {chunk}: y max |diff| {y_err:.3e}, "
        f"|diff| / ({FLASH_ULP:g} |plain| + {FLASH_ABS:g}) {y_exc:.3f} "
        f"(tolerance 1; planted fault, the last 64 steps x (1 + "
        f"{FLASH_FAULT:g}): {bad_exc:.3f}); final state |diff| / largest "
        f"|plain| {h_rel:.3e} (tolerance {SSD_F32_TOL}; the largest chunk "
        f"sum of |dt A| is {cum_max:.1f}); in f32, y {y32_rel:.3e} "
        f"(tolerance {SSD_F32_TOL}); kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.1f} ms, {fmt_bound(b)}")
    if not (y_exc <= 1 and h_rel <= SSD_F32_TOL and y32_rel <= SSD_F32_TOL):
        raise AssertionError(f"[{tag}] ssd kernel != plain: y {y_exc}, "
                             f"state {h_rel}, f32 y {y32_rel}")
    if not bad_exc > 1:
        raise AssertionError(f"[{tag}] the y check passes a planted fault")
    _profile_decode(cfg, params, run, S, dev, tag=tag)
    del run, run_h, params
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:68",
        launches=launches["ssd_scan"], max_abs_err=y_err, ms=k_ms,
        plain_ms=p_ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        bound_terms=b["bound_terms"],
        bound_terms_per_head_cb=b["bound_terms_per_head_cb"],
        library_ms=None, state_rel_err=h_rel,
        shape=f"x {list(x.shape)} bf16, B/C {list(Bm.shape)}, chunk {chunk} "
              f"(layer 0 of the prefill)")


def phase_rglru_serve(dev=torch.device("cuda")) -> tuple:
    """Phase 12: recurrentgemma-9b served at full width through
    ``repro_torch.launch.serve``; returns the RG-LRU-scan kernel's entry
    and the serving kernels' numbers at this model's shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import page_gather as pg
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import plain_versions
    from repro_torch.kernels import rglru_scan as kr
    from repro_torch.kernels.ref import (attention_ref, page_copy_ref,
                                         paged_attention_ref)
    from repro_torch.launch import serve
    from repro_torch.models import rglru as rg
    from repro_torch.serving import engine as eng
    from repro_torch.models.attention import blockwise_attention
    S = RG_SERVE
    tag = "rglru serve"
    gc.collect()  # the previous phase's model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params = serve.build(S["arch"], full=True, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (S["requests"], S["prompt"])).astype(np.int32)
    S = dict(S, max_seq=-(-(S["prompt"] + S["new"]) // cfg.page_size)
             * cfg.page_size)
    steps = S["new"] - 1
    kinds = cfg.layer_kinds()
    n_attn = sum(k.startswith("attn") for k in kinds)
    n_rec = kinds.count("rglru")

    cap: dict = {}
    calls = dict(paged=0)
    last = (steps - 1) * 2 * n_attn
    flash0, paged0, copy0, scan0 = (fa.flash_attention, pa.paged_attention,
                                    pg.page_copy, kr.rglru_scan)

    def flash_hook(q, k, v, **kw):
        if "flash" not in cap:
            cap["flash"] = (q.clone(), k.clone(), v.clone(), kw)
        return flash0(q, k, v, **kw)

    def paged_hook(q, pool, slot, live, window=0):
        if calls["paged"] - last in (0, 1):
            cap.setdefault("paged", []).append(
                (q.clone(), pool, slot.clone(), live.clone(), window))
        calls["paged"] += 1
        return paged0(q, pool, slot, live, window)

    def copy_hook(dst, src, di, si):
        if "copy" not in cap:
            cap["copy"] = (dst, src.clone(), di.clone(), si.clone())
        return copy0(dst, src, di, si)

    def scan_hook(u, *ps):
        if "rglru" not in cap:
            cap["rglru"] = (u.clone(), *(p.clone() for p in ps))
        return scan0(u, *ps)
    fa.flash_attention, pa.paged_attention, pg.page_copy, kr.rglru_scan = (
        flash_hook, paged_hook, copy_hook, scan_hook)
    try:
        run, run_h, launches, plain, plain_h, forced, peak = _serve_pair(
            tag, cfg, params, prompts, S, dev)
    finally:
        fa.flash_attention, pa.paged_attention, pg.page_copy, \
            kr.rglru_scan = flash0, paged0, copy0, scan0
    want = dict(flash_attention=n_attn, paged_attention=2 * n_attn * steps,
                rglru_scan=n_rec, ssd_scan=0)
    if any(launches[k] != v for k, v in want.items()) or \
            not launches["page_copy"]:
        raise AssertionError(f"[{tag}] launches {launches}, want {want} and "
                             "page copies")
    kv, pkv = run.state.kv, plain.state.kv
    for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads", "t2_reads",
              "evictions", "writebacks"):
        if not torch.equal(getattr(kv, f), getattr(pkv, f)):
            raise AssertionError(f"[{tag}] kernel run != plain run in {f}")
    for x, y in zip(kv.meta + kv.ols, pkv.meta + pkv.ols):
        if not torch.equal(x, y):
            raise AssertionError(f"[{tag}] kernel run != plain run in the "
                                 "metadata or the learner")
    if kv.key != pkv.key or not torch.equal(
            kv.ols.weights.view(torch.int32), pkv.ols.weights.view(torch.int32)):
        raise AssertionError(f"[{tag}] kernel run != plain run in the key / "
                             "weights")
    if not (kv.lengths == S["prompt"] + steps).all():
        raise AssertionError(f"[{tag}] lengths {kv.lengths.tolist()}")
    spec = eng.make_kv_spec(cfg, eng.ServeConfig(
        max_seq=S["max_seq"], batch_local=S["requests"],
        hbm_fraction=S["hbm_fraction"]))
    log(f"[{tag}] init {init_s:.1f} s; {spec.n_pages} pages a sequence, "
        f"{spec.hbm_slots} tier-1 and {spec.t2_slots} tier-2 slots, read "
        f"window {spec.read_pages} pages "
        f"(window {cfg.window} tokens); tier-1 page reads "
        f"{int(kv.t1_reads[0])}, tier-2 {int(kv.t2_reads[0])}, evictions "
        f"{int(kv.evictions[0])}, write-backs {int(kv.writebacks[0])}; OL "
        f"weights {kv.ols.weights.tolist()}; tier state and learner equal "
        f"to the plain run's (integers exact, f32 weights bit for bit)")
    rec_err = _rec_err(run.state, plain.state)
    h_err = _hidden_err(run_h, plain_h)
    lp_err = float(np.abs(run.logprobs - plain.logprobs).max())

    # The noise floor: the plain path with blockwise prefill attention.
    # Planted faults on the kernel path: (a) the window's token mask
    # dropped (the paged kernel also reads the tokens of the window's
    # first page that are older than the window); (b) the prefill's
    # RG-LRU state handed on unrounded (f32) instead of as the bf16 output.
    def blockwise(q, k, v, **kw):
        return blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw).transpose(1, 2)

    def no_window(q, pool, slot, live, window=0):
        return paged0(q, pool, slot, live, 0)
    handoff0 = rg._handoff
    last_f32 = {}

    def scan_f32(u, *ps):
        last_f32["h"] = kr.rglru_scan_cuda(u.float(), *ps)[:, -1]
        return scan0(u, *ps)

    def unrounded(h):
        return last_f32["h"]

    def patch_f32():
        kr.rglru_scan, rg._handoff = scan_f32, unrounded

    def unpatch_f32():
        kr.rglru_scan, rg._handoff = scan0, handoff0
    runs = {
        "noise floor (plain, blockwise prefill attention)": (
            lambda: setattr(fa, "flash_attention", blockwise),
            lambda: setattr(fa, "flash_attention", flash0), True),
        "fault (a): window token mask dropped": (
            lambda: setattr(pa, "paged_attention", no_window),
            lambda: setattr(pa, "paged_attention", paged0), False),
        "fault (b): RG-LRU handoff unrounded": (patch_f32, unpatch_f32,
                                                False)}
    # A page of decode steps: the token mask of fault (a) admits r + 1
    # tokens older than the window at a step with L % page = r, so only a
    # whole page of steps reaches its full size.
    n_ctl = cfg.page_size
    short = _short_runs(cfg, params, prompts, S, forced, plain_h,
                        plain.logprobs, runs, n_ctl)
    control = {k: v for k, v in short.items() if k.startswith("noise")}
    faults = {k: v for k, v in short.items() if k.startswith("fault")}
    log(f"[{tag}, plain path] recurrent states after the last step, kernel "
        f"run vs plain run: largest |diff| / largest |plain| {rec_err:.3e}")
    _check_bars(tag, h_err, lp_err, control, faults, n_ctl)
    del plain, plain_h, pkv

    # RG-LRU: layer 0's prefill u, element by element within one bf16 step.
    u, *ps = cap["rglru"]
    kr.rglru_scan_cuda(u, *ps)  # warm-up
    r_ms, h = cuda_ms(lambda: kr.rglru_scan_cuda(u, *ps), reps=5)
    rp_ms, hp = cuda_ms(lambda: kr.rglru_scan_plain(u, *ps))
    r_err = float((h.float() - hp.float()).abs().max())
    r_exc = _bf16_step_excess(h, hp)
    bad = h.clone()
    bad[:, -64:] = (bad[:, -64:].float() * (1 + FLASH_FAULT)).to(bad.dtype)
    r_bad = _bf16_step_excess(bad, hp)
    del bad, h, hp
    rb = _rglru_bound(u)
    log(f"[{tag}, rglru_scan vs plain] layer 0's prefill, u "
        f"{list(u.shape)} bf16: max |diff| {r_err:.3e}, |diff| / "
        f"({FLASH_ULP:g} |plain| + {FLASH_ABS:g}) {r_exc:.3f} (tolerance 1; "
        f"planted fault {r_bad:.3f}); kernel {r_ms:.3f} ms, plain "
        f"{rp_ms:.1f} ms, {fmt_bound(rb)}")
    if not r_exc <= 1:
        raise AssertionError(f"[{tag}] rglru kernel != plain: {r_exc}")
    if not r_bad > 1:
        raise AssertionError(f"[{tag}] the rglru check passes a planted "
                             "fault")

    # Flash at hd 256 with the 2,048-token window: layer 2's prefill.
    q, k, v, kw = cap["flash"]
    fa.flash_attention_cuda(q, k, v, **kw)
    f_ms, got = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    fp_ms, want_o = cuda_ms(lambda: attention_ref(q, k, v, **kw))
    f_err = float((got.float() - want_o.float()).abs().max())
    f_exc = _bf16_step_excess(got, want_o)
    del got, want_o
    if not f_exc <= 1:
        raise AssertionError(f"[{tag}] flash kernel != plain: {f_exc}")
    fb = _flash_bound(q, k, kw.get("window"))
    # The yardstick: one PyTorch call for the same function, a boolean band
    # mask (causal, the last `window` keys) with the kv head shared.
    pos = torch.arange(q.shape[2], device=dev)
    band = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - kw["window"])
    sdpa = dict(attn_mask=band, enable_gqa=True)
    torch.nn.functional.scaled_dot_product_attention(q, k, v, **sdpa)
    f_lib, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **sdpa), reps=3)
    del band
    log(f"[{tag}, flash vs plain] layer 2's prefill, q {list(q.shape)}, "
        f"window {kw.get('window')}: max |diff| {f_err:.3e}, element-wise "
        f"{f_exc:.3f} of its bar; kernel {f_ms:.3f} ms, plain {fp_ms:.1f} ms, "
        f"scaled_dot_product_attention (band mask, enable_gqa) {f_lib:.3f} "
        f"ms, {fmt_bound(fb)}")

    # Paged: both tiers of the first attention layer at the last step.
    pcalls = cap["paged"]
    p_err = 0.0
    for qq, pool, slot, live, window in pcalls:
        got = pa.paged_attention_cuda(qq, pool, slot, live, window)
        want_p = paged_attention_ref(qq, pool, slot, live, window)
        for g, w in zip(got, want_p):
            p_err = max(p_err, _rel_err(g, w))
    if not p_err <= PAGED_REL_TOL:
        raise AssertionError(f"[{tag}] paged kernel != plain: {p_err}")
    p_ms, _ = cuda_ms(lambda: [pa.paged_attention_cuda(*c) for c in pcalls],
                      reps=10)
    conv = [_paged_inputs(c) for c in pcalls]
    p_graph = graph_ms(lambda: [pa.paged_attention_cuda(*c) for c in conv])
    pp_ms, _ = cuda_ms(lambda: [paged_attention_ref(*c) for c in pcalls],
                       reps=3)
    pb = _paged_bound(pcalls, cfg.page_size)
    n_split = pa.split_plan(S["requests"], cfg.n_kv_heads,
                            pcalls[0][2].shape[1], cfg.page_size)
    log(f"[{tag}, paged vs plain] last decode step, first attention layer, "
        f"both tiers, window {pcalls[0][4]}: largest |diff| / largest "
        f"|plain| {p_err:.3e} (tolerance {PAGED_REL_TOL}); (n_split, span) "
        f"{n_split}: kernel {p_ms:.4f} ms in a loop of calls, "
        f"{p_graph:.4f} ms from a CUDA graph of its launches alone, plain "
        f"{pp_ms:.3f} ms, {fmt_bound(pb)}")

    # Page copy: the first prefill population, byte for byte.
    dst, src, di, si = cap["copy"]
    whole = kv.pool2
    off = (dst.data_ptr() - whole.data_ptr()) // whole.element_size()
    outs = []
    for fn in (pg.page_copy_cuda, page_copy_ref):
        buf = whole.clone()
        view = buf.view(-1)[off:].as_strided(dst.shape, dst.stride())
        fn(view, src, di, si)
        torch.cuda.synchronize()
        outs.append(buf)
    if not torch.equal(outs[0].view(torch.uint8), outs[1].view(torch.uint8)):
        raise AssertionError(f"[{tag}] page copy kernel != plain")
    view = outs[0].view(-1)[off:].as_strided(dst.shape, dst.stride())
    c_ms, _ = cuda_ms(lambda: pg.page_copy_cuda(view, src, di, si), reps=5)
    live_rows = int(((di >= 0) & (si >= 0)).sum())
    cb = _copy_bound(live_rows, dst[0].numel() * dst.element_size())
    del outs, view
    log(f"[{tag}, page copy vs plain] prefill population of layer 2 into "
        f"tier 2 ({live_rows} pages): equal byte for byte; kernel "
        f"{c_ms:.3f} ms, {fmt_bound(cb)}")
    _profile_decode(cfg, params, run, S, dev, tag=tag)
    del run, run_h, params
    rglru = dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:55",
        launches=launches["rglru_scan"], max_abs_err=r_err, ms=r_ms,
        plain_ms=rp_ms, bound_ms=rb["bound_ms"], bound_by=rb["bound_by"],
        bound_terms=rb["bound_terms"], library_ms=None,
        shape=f"u {list(u.shape)} bf16 (layer 0 of the prefill)")
    at_rg = dict(
        flash_attention=dict(recurrentgemma_ms=f_ms,
                             recurrentgemma_plain_ms=fp_ms,
                             recurrentgemma_library_ms=f_lib,
                             recurrentgemma_bound_ms=fb["bound_ms"],
                             recurrentgemma_launches=launches[
                                 "flash_attention"],
                             recurrentgemma_max_abs_err=f_err),
        paged_attention=dict(recurrentgemma_ms=p_ms,
                             recurrentgemma_ms_graph=p_graph,
                             recurrentgemma_plain_ms=pp_ms,
                             recurrentgemma_bound_ms=pb["bound_ms"],
                             recurrentgemma_launches=launches[
                                 "paged_attention"],
                             recurrentgemma_max_abs_err=p_err),
        page_copy=dict(recurrentgemma_ms=c_ms,
                       recurrentgemma_bound_ms=cb["bound_ms"],
                       recurrentgemma_launches=launches["page_copy"]))
    return rglru, at_rg


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails at once without the repo)
    log(card_line())  # name, power limit: as nvidia-smi prints them
    phase_build()
    rates = phase_probes()
    phase_kernel_vs_plain(rates)
    phase_worked_example()
    full = phase_full_size(rates)
    full_ctr = full.pop("counters")
    phase_reuse_vs_plain()
    phase_mixed_knobs(rates)
    mrc = phase_mrc(full_size_spec().replace(
        **{"store.policy": "lru", "n_windows": 1}))
    mega = phase_megabatch(full_ctr, rates)
    serving = phase_serve()
    ssd = phase_ssd_serve()
    rglru, at_rg = phase_rglru_serve()
    for entry in serving:
        entry.update(at_rg[entry["name"]])
    cache_scan = dict(
        name="cache_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_scan.cu",
        replaces="src/repro/kernels/cache_scan.py:385", library_ms=None,
        **full, **mega)
    reuse = dict(
        name="reuse_distance", route="cuda",
        source="src/repro_torch/kernels/csrc/reuse_distance.cu",
        replaces="src/repro/kernels/reuse_distance.py:142", library_ms=None,
        **mrc)
    kernels = [cache_scan, reuse, *serving, ssd, rglru]
    check_kernels_over_bounds(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
