"""Chunked streaming trace replay: bounded memory, bit-exact, resumable.

The one-shot path (:func:`repro_torch.sim.engine.tier1_counters`)
materializes the whole request stream, partitions it, and pushes
``[n_shards, n]`` rows through one launch — device memory grows linearly
with the trace. This module replays the same workload in fixed-size
*chunks* through the resumable chunk engine
(:func:`repro_torch.storage.tiered_store.stream_chunk_engine`):

- **Bounded memory.** Only one chunk's ``[n_shards, cap]`` buffers plus
  the carried ``(StoreState, Accum)`` live on the card; the cache-scan
  kernel's masked mode updates the carry in place, and every chunk of a
  shape reuses that shape's preallocated buffer set. Peak device memory is
  independent of trace length.
- **Two shapes at most.** Chunks land in one of exactly two per-shard
  length buckets — a primary bucket sized for balanced shard loads and a
  fallback sized for the worst skew — so a replay allocates at most two
  buffer sets (:func:`repro_torch.storage.tiered_store.
  stream_compile_count` counts them).
- **Overlap.** A launch returns while the card works: host-side
  generation, window binning and partitioning of chunk ``k+1`` overlap the
  launch of chunk ``k``, and its pinned host buffers go to the card on a
  side stream.
- **Bit-exact.** Chunk edges straddle window edges, bucket pads and fault
  events freely: pads carry the dropped window id and are *masked no-ops*
  (state untouched, nothing counted), so every counter — whole-stream,
  windowed, faulted — equals the one-shot engine's, for every chunk size.
- **Resume.** :class:`StreamCheckpoint` snapshots everything the replay
  carries (cache state, windowed accumulators, expert weights, traffic
  generator state, fluid backlog) as host numpy data; a later process
  resumes bit-exactly mid-stream.

**Multi-tenant attribution.** ``tenant_mix`` traffic
(:func:`repro_torch.core.traffic.tenant_mix`) is generated chunk by chunk
on the host (:class:`repro_torch.core.traffic.TenantStream` — never
materialized whole), and per-tenant windowed counters cost no extra
launch: the windowed counters run over composite ``window * n_tenants +
tenant`` ids, and the host collapses the composite axis back into
per-window totals (sum over tenants) plus per-tenant series (sum over
shards).
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Optional

import numpy as np
import torch

from repro_torch.core.queuing import transient_two_tier
from repro_torch.core.traffic import TenantStream
from repro_torch.device import resolve_device
from repro_torch.sim.engine import (
    SimReport,
    TenantCounters,
    _assemble_counters,
    fault_owner,
    report_from_counters,
    stream_for_spec,
)
from repro_torch.sim.spec import SimSpec
from repro_torch.storage.tiered_store import (
    init_stream_carry,
    partition_streams,
    stream_chunk_engine,
    stream_stats_from_carry,
    stream_window_ids,
    timestamp_window_ids,
    tree_map,
)

__all__ = [
    "DEFAULT_CHUNK",
    "MIN_CAP",
    "StreamCheckpoint",
    "stream_tier1_counters",
    "simulate_stream",
]

# Default requests per chunk. Large enough that per-chunk dispatch overhead
# amortizes, small enough that one chunk's device buffers stay modest.
DEFAULT_CHUNK = 1 << 18

# Floor of the primary per-shard length bucket (balanced-load sizing).
MIN_CAP = 512


def _next_pow2(n: int) -> int:
    cap = 1
    while cap < n:
        cap <<= 1
    return cap


def _chunk_caps(chunk: int, n_shards: int) -> tuple[int, int]:
    """The two per-shard length buckets every chunk of a replay lands in.

    The primary bucket assumes roughly balanced shard loads (2x headroom
    over ``chunk / n_shards``); a chunk whose worst shard overflows it —
    pathological mapping skew — takes the fallback bucket, which fits any
    chunk (one shard owning everything). Two buckets -> at most two buffer
    sets per replay, no matter how many chunks stream through."""
    fallback = _next_pow2(max(chunk, 1))
    primary = min(_next_pow2(max(MIN_CAP, -(-2 * chunk // n_shards))),
                  fallback)
    return primary, fallback


@dataclasses.dataclass
class StreamCheckpoint:
    """Everything a chunked replay carries between chunks, as host data.

    Snapshot of a replay frontier: the per-shard cache/learner state and
    windowed accumulators (``carry`` — numpy copies of the chunk-engine
    carry, safe to pickle), the consumed-request offset and per-shard
    tallies, the traffic generator's mid-stream state (``tenant_state``,
    tenant workloads only), the host-tracked last-tenant table behind
    windowed expert-weight attribution, and the pooled fluid backlog
    ``fluid_q0 = (q1, q2)`` at the frontier — the ``q0`` a continuation
    transient solve resumes from. Resuming validates ``signature`` (the
    spec's :meth:`~repro_torch.sim.spec.SimSpec.cache_signature`) plus the
    stream's length and page space, so a checkpoint cannot silently
    continue a different workload."""

    signature: tuple
    offset: int                  # requests consumed so far
    total: int                   # total requests of the stream
    counts: np.ndarray           # [n_shards] real requests per shard
    shard_writes: np.ndarray     # [n_shards] writes per shard
    carry: object                # host-numpy (StoreState, Accum) pair
    n_pages: int
    n_windows: int               # plain window count W (not composite)
    n_tenants: int               # 0 = single-tenant replay
    tenant_state: Optional[dict] = None
    last_tenant: Optional[np.ndarray] = None   # [n_shards, W], -1 = empty
    fluid_q0: Optional[tuple] = None           # (q1, q2) at the frontier

    @property
    def done(self) -> bool:
        return self.offset >= self.total


def _validate_resume(ck: StreamCheckpoint, signature: tuple, total: int,
                     n_pages: int, n_windows: int, n_tenants: int) -> None:
    if ck.signature != signature:
        raise ValueError(
            "StreamCheckpoint does not match this spec (cache_signature "
            "differs) — a checkpoint resumes only the workload it snapshot")
    if (ck.total, ck.n_pages, ck.n_windows, ck.n_tenants) != (
            total, n_pages, n_windows, n_tenants):
        raise ValueError(
            "StreamCheckpoint stream layout mismatch: checkpoint has "
            f"(total={ck.total}, n_pages={ck.n_pages}, "
            f"n_windows={ck.n_windows}, n_tenants={ck.n_tenants}), replay "
            f"has ({total}, {n_pages}, {n_windows}, {n_tenants})")


def _to_host(carry):
    """The carry as numpy copies (waits for the card)."""
    return tree_map(lambda x: np.array(x.cpu().numpy(), copy=True), carry)


def _to_device(carry, device):
    """A checkpoint's carry (host numpy, or tensors) as tensors on
    ``device``, each leaf its own copy."""
    return tree_map(lambda x: torch.as_tensor(x).to(device, copy=True),
                    carry)


def stream_tier1_counters(
    spec: SimSpec,
    trace=None,
    *,
    chunk: int = DEFAULT_CHUNK,
    unroll: int = 1,
    checkpoint: Optional[StreamCheckpoint] = None,
    max_requests: Optional[int] = None,
    donate: bool = True,
    engine: str = "fused",
    profile: Optional[dict] = None,
    device=None,
):
    """Chunked-replay counterpart of :func:`repro_torch.sim.engine.
    tier1_counters`, on ``device`` (``None`` = the card).

    Returns ``(counters, tenant_counters, checkpoint)``:
    :class:`Tier1Counters` equal to the one-shot engine's for the consumed
    prefix, :class:`TenantCounters` for ``tenant_mix`` workloads (``None``
    otherwise), and the :class:`StreamCheckpoint` at the final frontier
    (``checkpoint.done`` when the stream is exhausted).

    ``tenant_mix`` specs are generated chunk by chunk on the host; any
    other spec (or an explicit ``trace``) is materialized on the host once
    (exactly the one-shot stream) and *fed* in chunks — device memory stays
    bounded either way. ``checkpoint`` resumes a prior partial run;
    ``max_requests`` bounds how many further requests this call consumes
    (``None`` = run to the end). ``donate=False`` is the synchronous
    per-chunk baseline (fresh device arrays and a new carry per chunk,
    each chunk waited for). ``engine`` selects the fused cache-scan loop
    (default) or the per-step ``"scan"`` engine (bit-exact either way).
    ``unroll`` (a ``lax.scan`` knob in the reference) has no effect.

    ``profile`` (a mutable dict) accumulates per-chunk wall-clock
    sub-timings: ``stream_chunk_host`` (generation + binning +
    partitioning), ``stream_chunk_dispatch`` (the copies to the card and
    the launch, which returns before the card finishes),
    ``stream_chunk_wait`` (the final carry's copy to the host, which waits
    for the card; each chunk's wait too when ``donate=False``) and
    ``stream_chunks`` (chunk count)."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    device = resolve_device(device)
    prof = profile
    n_shards = spec.n_shards
    signature = spec.cache_signature()
    tenant = spec.traffic.kind == "tenant_mix" and trace is None
    if tenant:
        gen = TenantStream(spec.traffic)
        n_tenants = gen.n_tenants
        total = spec.traffic.n_requests
        n_pages = spec.traffic.n_pages   # tenant key ranges are bounded
        n_windows, window_dt = spec.window_grid()
        pages = is_write = owner_all = gwin_all = None
    else:
        gen = None
        n_tenants = 0
        pages, is_write, times, n_pages, n_windows, window_dt = (
            stream_for_spec(spec, trace))
        total = int(pages.shape[0])
        # Whole-stream host precompute, identical to the one-shot path:
        # window binning (float64) and the fault-schedule owner remap are
        # global maps, so chunking cannot perturb them.
        if window_dt is not None:
            gwin_all = timestamp_window_ids(times, n_windows, window_dt)
        else:
            gwin_all = stream_window_ids(total, n_windows)
        owner_all = fault_owner(spec, pages, times, n_pages)
    # Composite window ids interleave the tenant axis into the engine's
    # windowed counters: id = window * n_tenants + tenant. The engine runs
    # at W * n_tenants windows; the host collapses the axis afterwards.
    eng_windows = n_windows * max(n_tenants, 1)

    if checkpoint is not None:
        _validate_resume(checkpoint, signature, total, n_pages, n_windows,
                         n_tenants)
        offset = int(checkpoint.offset)
        counts = np.asarray(checkpoint.counts, np.int64).copy()
        shard_writes = np.asarray(checkpoint.shard_writes, np.int64).copy()
        carry = _to_device(checkpoint.carry, device)
        last_tenant = (np.asarray(checkpoint.last_tenant, np.int32).copy()
                       if tenant else None)
        if tenant:
            gen.restore(checkpoint.tenant_state)
    else:
        offset = 0
        counts = np.zeros(n_shards, np.int64)
        shard_writes = np.zeros(n_shards, np.int64)
        carry = init_stream_carry(spec.store, n_shards,
                                  n_windows=eng_windows, device=device)
        last_tenant = (np.full((n_shards, n_windows), -1, np.int32)
                       if tenant else None)

    stop = total if max_requests is None else min(total,
                                                  offset + int(max_requests))
    primary, fallback = _chunk_caps(chunk, n_shards)
    eng = stream_chunk_engine(spec.store, unroll=unroll,
                              n_windows=eng_windows, donate=donate,
                              engine=engine, device=device)
    hyper = spec.store.hyper()

    while offset < stop:
        tc0 = perf_counter()
        m = min(chunk, stop - offset)
        if tenant:
            p, w, t, tids = gen.take(m)
            own = fault_owner(spec, p, t, n_pages)
            if window_dt is not None:
                win = timestamp_window_ids(t, n_windows, window_dt)
            else:
                g = offset + np.arange(m, dtype=np.int64)
                win = ((g * n_windows) // total).astype(np.int32)
            # Last tenant per (shard, window): duplicate fancy-index
            # assignment keeps the final occurrence — exactly "the tenant
            # of this shard's last request in this window so far".
            last_tenant[own, win] = tids
            cwin = win * n_tenants + tids
        else:
            sl = slice(offset, offset + m)
            p, w = pages[sl], is_write[sl]
            own, cwin = owner_all[sl], gwin_all[sl]
        cnt = np.bincount(own, minlength=n_shards)
        cap = primary if int(cnt.max()) <= primary else fallback
        sh_p, sh_w, cnt, _, sh_win = partition_streams(
            p, w, n_shards=n_shards, mapping=spec.mapping, n_pages=n_pages,
            cap=cap, n_windows=eng_windows, window_ids=cwin, owner=own)
        counts += cnt
        shard_writes += np.bincount(own[w], minlength=n_shards)
        tc1 = perf_counter()
        # The launch returns while the card works, so the next iteration's
        # host work (generate, bin, partition) overlaps it. donate=False
        # is the deliberately synchronous baseline.
        carry = eng(hyper, carry, sh_p, sh_w, sh_win)
        tc2 = perf_counter()
        if not donate and device.type == "cuda":
            torch.cuda.synchronize(device)
        offset += m
        if prof is not None:
            prof["stream_chunk_host"] = (
                prof.get("stream_chunk_host", 0.0) + (tc1 - tc0))
            prof["stream_chunk_dispatch"] = (
                prof.get("stream_chunk_dispatch", 0.0) + (tc2 - tc1))
            prof["stream_chunk_wait"] = (
                prof.get("stream_chunk_wait", 0.0)
                + (perf_counter() - tc2))
            prof["stream_chunks"] = prof.get("stream_chunks", 0) + 1

    # Materialize the carry on the host once: the numpy copies feed the
    # counter assembly below and make the checkpoint picklable.
    tw0 = perf_counter()
    carry_host = _to_host(carry)
    if prof is not None:
        prof["stream_chunk_wait"] = (
            prof.get("stream_chunk_wait", 0.0) + (perf_counter() - tw0))
    stats = stream_stats_from_carry(carry_host, counts)

    tenant_ctr = None
    if tenant:
        def collapse(a):
            a = np.asarray(a)
            return a.reshape(n_shards, n_windows, n_tenants,
                             *a.shape[2:]).sum(axis=2)

        # Windowed expert weights: the engine snapshot lives per composite
        # sub-window; the plain window's snapshot is the one at the shard's
        # last request in the window, i.e. the last-tenant sub-window.
        ww = np.asarray(stats.win_weights)
        wwr = ww.reshape(n_shards, n_windows, n_tenants, ww.shape[-1])
        sel = np.maximum(last_tenant, 0)[:, :, None, None]
        w_sel = np.take_along_axis(wwr, sel, axis=2)[:, :, 0, :]
        w_sel = np.where((last_tenant >= 0)[:, :, None], w_sel, 0.0)
        per_tw = np.asarray(stats.win_requests).reshape(
            n_shards, n_windows, n_tenants)
        tenant_ctr = TenantCounters(
            names=tuple(t.name for t in spec.traffic.tenants),
            win_requests=per_tw.sum(axis=0).T,
            win_hits=np.asarray(stats.win_hits).reshape(
                n_shards, n_windows, n_tenants).sum(axis=0).T,
            win_misses=np.asarray(stats.win_misses).reshape(
                n_shards, n_windows, n_tenants).sum(axis=0).T,
        )
        stats = stats._replace(
            win_requests=collapse(stats.win_requests),
            win_hits=collapse(stats.win_hits),
            win_misses=collapse(stats.win_misses),
            win_prefetch_hits=collapse(stats.win_prefetch_hits),
            win_tier2_reads=collapse(stats.win_tier2_reads),
            win_tier2_writes=collapse(stats.win_tier2_writes),
            win_evictions=collapse(stats.win_evictions),
            win_expert_use=collapse(stats.win_expert_use),
            win_weights=w_sel,
        )
    # Masked pads never touched the accumulators, so no padding correction
    # applies — _assemble_counters consumes the stats as they are.
    ctr = _assemble_counters(stats, counts, shard_writes)

    ck = StreamCheckpoint(
        signature=signature,
        offset=offset,
        total=total,
        counts=counts.copy(),
        shard_writes=shard_writes.copy(),
        carry=carry_host,
        n_pages=n_pages,
        n_windows=n_windows,
        n_tenants=n_tenants,
        tenant_state=gen.state() if tenant else None,
        last_tenant=last_tenant.copy() if tenant else None,
    )
    return ctr, tenant_ctr, ck


def _frontier_fluid_q0(spec: SimSpec, rep: SimReport) -> Optional[tuple]:
    """Pooled fluid backlog ``(q1, q2)`` at the consumed frontier of a
    partial replay: the fluid solve re-run over the non-empty prefix of
    the window grid (the report's own solve includes the trailing not-yet-
    streamed windows, which drain the backlog as if the stream had gone
    idle). Healthy service rates — a continuation solve under a fault
    schedule should re-solve from the counters instead."""
    if spec.transient_mode != "fluid" or rep.window_duration_s <= 0:
        return None
    pooled = np.asarray(rep.windows.requests).sum(axis=0)
    nz = np.nonzero(pooled)[0]
    if nz.size == 0:
        return None
    hi = int(nz[-1]) + 1
    rates = spec.rates.resolve()
    tr = rep.transient
    sol = transient_two_tier(
        np.asarray(tr.lam)[:hi], np.asarray(tr.p12)[:hi],
        rates.mu1, rates.mu2, k=spec.k_servers, flow=spec.flow,
        mode="fluid", dt=rep.window_duration_s, mu_load=rates.mu_load,
    )
    return (np.asarray(sol.q1_end), np.asarray(sol.q2_end))


def simulate_stream(
    spec: SimSpec,
    trace=None,
    *,
    chunk: int = DEFAULT_CHUNK,
    unroll: int = 1,
    checkpoint: Optional[StreamCheckpoint] = None,
    max_requests: Optional[int] = None,
    donate: bool = True,
    engine: str = "fused",
    profile: Optional[dict] = None,
    device=None,
):
    """Streaming counterpart of :func:`repro_torch.sim.engine.simulate`, the
    tier-1 stage on ``device`` (``None`` = the card).

    Replays the workload in bounded-memory chunks
    (:func:`stream_tier1_counters`) and solves the queuing network on the
    streamed counters. The resulting :class:`SimReport` equals
    ``simulate(spec)``'s in every counter and windowed series, at a peak
    device footprint independent of trace length; ``tenant_mix`` workloads
    additionally carry per-tenant :class:`~repro_torch.sim.engine.
    TenantReport` attribution.

    With ``max_requests`` set the call returns ``(report, checkpoint)``:
    the report covers the consumed prefix (untouched windows are idle) and
    the checkpoint — including the pooled fluid backlog at the frontier —
    resumes the replay bit-exactly via ``checkpoint=``. Without it the call
    runs to the end of the stream and returns the report alone."""
    ctr, tenant_ctr, ck = stream_tier1_counters(
        spec, trace, chunk=chunk, unroll=unroll, checkpoint=checkpoint,
        max_requests=max_requests, donate=donate, engine=engine,
        profile=profile, device=device)
    rep = report_from_counters(spec, ctr, tenants=tenant_ctr)
    if max_requests is None:
        return rep
    ck.fluid_q0 = _frontier_fluid_q0(spec, rep)
    return rep, ck
