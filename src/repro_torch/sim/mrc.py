"""Miss-rate curves from one pass: exact LRU counters for every cache size.

The cache-scan engine (:func:`repro_torch.sim.engine.tier1_counters`)
re-simulates the whole request stream per cache size. For LRU the classic Mattson stack-distance
result makes that loop unnecessary: a request hits a fully-associative LRU
cache of capacity ``C`` iff its *reuse distance* ``d`` (distinct pages
touched since its previous access; infinity for a first access) satisfies
``d < C``. One distance pass (:mod:`repro_torch.kernels.reuse_distance`: on the
card, a hand-written CUDA kernel) plus a host histogram therefore yields the counters for **all** sizes at once.

:func:`mrc_tier1_counters` reconstructs the *complete*
:class:`~repro_torch.sim.engine.Tier1Counters` — whole-stream and
per-window, including evictions, write-backs and the online-learning
telemetry — so :func:`~repro_torch.sim.engine.report_from_counters` and the
fluid transient path run unchanged on its output. Every field is
**bit-identical** to the cache-scan engine inside the supported domain
(``tests/test_torch_mrc.py`` holds it against the reference, and
``chip_smoke.py`` against the CUDA cache-scan kernel at deployment scale);
outside it the functions raise ``ValueError`` (and ``sweep()``
falls back to the scan engine with a logged reason):

- ``policy`` must be ``"lru"`` — LFU and the learned weight-sharing
  policy have no exact single-pass stack formulation (their eviction
  choice depends on the realized cache content at each capacity).
- ``prefetch`` must be off — the prefetch buffer adds state outside the
  LRU stack.
- Write traffic is exact whole-stream (single window): a dirty page
  evicted in the gap after its access ``j`` produces a write-back for
  exactly the capacities ``M_j < C <= U_j``, where ``U_j`` is the reuse
  distance at the page's next access (or the count of distinct pages
  after its last access) and ``M_j`` is the running max distance since
  the page's last write (0 at a write, infinity if never written) — the
  cache line is dirty at capacity ``C`` iff the insertion that created it
  is not newer than the last write, i.e. ``C > M_j``. With multiple
  windows the write-back lands in the window of the *evicting* access,
  which depends on ``C`` — no cheap all-sizes attribution exists, so
  windowed grids require write-free traffic.

Derived counter identities (per shard, per window ``w``, capacity ``C``):

- ``hits = #{d < C}``; ``misses = requests - hits``;
  ``tier2_reads = misses`` (no prefetch); ``prefetch_hits = 0``.
- ``evictions = misses - clip(C - misses_before_w, 0, misses_in_w)``:
  the cache fills one free line per miss until ``C`` lines are live, so
  exactly the first ``C`` misses of the shard do not evict.
- ``expert_use[lru] = evictions`` (fixed-policy evictions are all issued
  by the LRU expert); ``weights`` are the uniform initial vector wherever
  the window saw a request (fixed policies never adjust weights).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import online_learning as ol
from repro_torch.device import resolve_device
from repro_torch.kernels.reuse_distance import (
    prev_occurrence,
    reuse_distances,
)
from repro_torch.sim.engine import Tier1Counters, fault_owner, stream_for_spec
from repro_torch.sim.spec import SimSpec
from repro_torch.storage.tiered_store import (
    partition_streams,
    timestamp_window_ids,
)

__all__ = [
    "mrc_unsupported_reason",
    "mrc_tier1_counters",
    "mrc_curve",
]

_LRU_EXPERT = ol.EXPERTS.index("lru")

# Distance arrays are padded to power-of-two length buckets, as the
# reference pads them (its compiled shapes; here, the same arrays).
_MIN_BUCKET = 16


def _bucket_cap(n: int) -> int:
    cap = _MIN_BUCKET
    while cap < n:
        cap <<= 1
    return cap


def _traffic_may_write(traffic) -> bool:
    if traffic.write_fraction > 0:
        return True
    phases = getattr(traffic, "phases", None) or ()
    return any(p.write_fraction > 0 for p in phases)


def mrc_unsupported_reason(spec: SimSpec) -> Optional[str]:
    """``None`` when :func:`mrc_tier1_counters` can serve this spec (at any
    ``store.n_lines``) bit-exactly; otherwise a human-readable reason. This
    is the routing predicate ``sweep()`` consults before replacing scan
    runs with the MRC path — conservative by construction (a spec that
    *may* emit writes counts as writing)."""
    if spec.store.policy != "lru":
        return (
            f"policy={spec.store.policy!r} has no exact stack-distance "
            "formulation (only 'lru' does)"
        )
    if spec.store.prefetch:
        return "prefetch=True adds buffer state outside the LRU stack"
    if spec.traffic.kind == "tenant_mix":
        return (
            "tenant_mix workloads route through the chunked streaming "
            "engine (per-tenant attribution needs the streamed composite "
            "windows; the MRC pass also materializes the whole merge)"
        )
    n_windows, _ = spec.window_grid()
    if n_windows > 1 and _traffic_may_write(spec.traffic):
        return (
            "windowed tier2_writes cannot be attributed exactly: a "
            "write-back lands in the window of the evicting access, which "
            "depends on the cache size (write-free traffic or a single "
            "window is exact)"
        )
    return None


def _check_supported(spec: SimSpec) -> None:
    if spec.store.policy != "lru":
        raise ValueError(
            "MRC supports exact stack-distance counters only for "
            f"policy='lru' (got {spec.store.policy!r}); LFU and learned "
            "policies have no exact single-pass formulation — use the "
            "scan engine"
        )
    if spec.store.prefetch:
        raise ValueError(
            "MRC does not support prefetch=True: the prefetch buffer adds "
            "state outside the LRU stack — use the scan engine"
        )


def mrc_tier1_counters(
    spec: SimSpec, sizes: Sequence[int], trace=None, *, device=None,
) -> dict[int, Tier1Counters]:
    """Exact per-shard :class:`~repro_torch.sim.engine.Tier1Counters` for every
    cache size in ``sizes``, from one stream pass.

    The stream (generated or ``trace``-provided), the §III shard
    partition, the fault-schedule owner remap and the window binning are
    all shared with :func:`~repro_torch.sim.engine.tier1_counters` — only the
    per-request cache simulation is replaced by the stack-distance
    histogram. ``spec.store.n_lines`` is ignored (that is the point);
    returns ``{size: counters}``. The distance pass runs on ``device``
    (``None`` = the card); the rest is host numpy.

    Raises ``ValueError`` for non-LRU policies, prefetch, or write traffic
    on a multi-window grid (see the module docstring for why those are
    outside the exactness domain).
    """
    sizes_arr = np.unique(np.asarray(list(sizes), np.int64))
    if sizes_arr.size == 0:
        raise ValueError("sizes must be non-empty")
    if (sizes_arr < 1).any():
        raise ValueError("cache sizes must be >= 1")
    _check_supported(spec)
    device = resolve_device(device)

    pages, is_write, times, n_pages, n_windows, window_dt = stream_for_spec(
        spec, trace)
    owner = fault_owner(spec, pages, times, n_pages)
    has_writes = bool(np.asarray(is_write, bool).any())
    if has_writes and n_windows > 1:
        raise ValueError(
            "MRC windowed counters require write-free traffic: a "
            "write-back lands in the window of the evicting access, which "
            "depends on the cache size — use a single window or the scan "
            "engine"
        )

    S = spec.n_shards
    if times is not None:
        # Same float64 host-side binning as the scan-engine path: the raw
        # (unsharded, full-precision) arrival times become int32 ids which
        # then ride the shard scatter — bit-identical window assignment.
        gwin = timestamp_window_ids(times, n_windows, window_dt)
        sh_pages, sh_writes, counts, owner, sh_win = partition_streams(
            pages, is_write, n_shards=S, mapping=spec.mapping,
            n_pages=n_pages, n_windows=n_windows, window_ids=gwin,
            owner=owner,
        )
    else:
        sh_pages, sh_writes, counts, owner, sh_win = partition_streams(
            pages, is_write, n_shards=S, mapping=spec.mapping,
            n_pages=n_pages, n_windows=n_windows, owner=owner,
        )

    # --- one distance pass (padded to a power-of-two length bucket) -------
    cap = sh_pages.shape[1]
    capb = _bucket_cap(cap)
    sh_pages_b = np.pad(sh_pages, ((0, 0), (0, capb - cap)))
    prev, valid = prev_occurrence(sh_pages_b, counts)
    dist = reuse_distances(prev, valid, device=device)     # int32 [S, capb]
    dist = dist.cpu().numpy()
    win_b = np.full((S, capb), n_windows, np.int32)
    win_b[:, :cap] = sh_win

    # --- histogram: (shard, window, size-bin) -> counts -------------------
    m = int(sizes_arr.size)
    vmask = valid
    s_idx = np.broadcast_to(np.arange(S)[:, None], (S, capb))[vmask]
    w_idx = win_b[vmask].astype(np.int64)
    d_v = dist[vmask].astype(np.int64)
    # bin = number of sizes <= d: request hits size index i iff bin <= i.
    bins = np.searchsorted(sizes_arr, d_v, side="right")
    composite = (s_idx * n_windows + w_idx) * (m + 1) + bins
    hist = np.bincount(
        composite, minlength=S * n_windows * (m + 1)
    ).reshape(S, n_windows, m + 1)
    win_req = hist.sum(axis=-1)                            # [S, W]
    win_hits = np.cumsum(hist, axis=-1)[..., :m]           # [S, W, m]
    win_miss = win_req[..., None] - win_hits
    win_t2r = win_miss
    # Free-line fills: the shard's first C misses (chronological — window
    # ids are nondecreasing along each shard row) insert without evicting.
    miss_before = np.cumsum(win_miss, axis=1) - win_miss
    free = np.clip(sizes_arr[None, None, :] - miss_before, 0, win_miss)
    win_ev = win_miss - free

    win_t2w = np.zeros_like(win_miss)
    if has_writes:
        win_t2w[:, 0, :] = _tier2_writes(
            sizes_arr, s_idx, vmask, sh_pages_b, d_v,
            sh_writes, counts, S,
        )

    # --- assemble Tier1Counters per size ----------------------------------
    counts64 = np.asarray(counts, np.int64)
    writes64 = np.bincount(owner[np.asarray(is_write, bool)],
                           minlength=S).astype(np.int64)
    zeros_w = np.zeros((S, n_windows), np.int64)
    win_eu = np.zeros((S, n_windows, ol.N_EXPERTS, m), np.int64)
    win_eu[:, :, _LRU_EXPERT, :] = win_ev
    # Fixed-policy weights never move: each window with a real request
    # snapshots the uniform initial vector, empty windows stay zero
    # (exactly the engine's accumulator semantics — including the f32
    # representation of 1/E the engine's accumulator carries).
    uniform = (np.ones(ol.N_EXPERTS, np.float32)
               / ol.N_EXPERTS).astype(float)
    win_wt = np.where(
        (win_req > 0)[..., None], uniform, 0.0
    )                                                      # [S, W, E]

    out: dict[int, Tier1Counters] = {}
    for i, size in enumerate(sizes_arr):
        hits_i = win_hits[..., i].astype(np.int64)
        miss_i = win_miss[..., i].astype(np.int64)
        ev_i = win_ev[..., i].astype(np.int64)
        t2w_i = win_t2w[..., i].astype(np.int64)
        out[int(size)] = Tier1Counters(
            requests=counts64,
            reads=counts64 - writes64,
            writes=writes64,
            hits=hits_i.sum(axis=1),
            misses=miss_i.sum(axis=1),
            prefetch_hits=np.zeros(S, np.int64),
            tier2_reads=miss_i.sum(axis=1),
            tier2_writes=t2w_i.sum(axis=1),
            evictions=ev_i.sum(axis=1),
            win_requests=win_req.astype(np.int64),
            win_hits=hits_i,
            win_misses=miss_i,
            win_prefetch_hits=zeros_w,
            win_tier2_reads=miss_i,
            win_tier2_writes=t2w_i,
            win_evictions=ev_i,
            win_expert_use=win_eu[..., i],
            win_weights=win_wt,
        )
    return out


def _tier2_writes(
    sizes_arr, s_idx, vmask, sh_pages_b, d_v, sh_writes, counts, S
):
    """Whole-stream dirty write-backs per shard for every size: interval
    counting over per-access episodes (see the module docstring).

    Each real access ``j`` opens one potential eviction gap, contributing
    a write-back for the capacities ``M_j < C <= U_j``. ``U_j`` is the
    reuse distance at the page's next access (the gap's distinct-page
    count) — or, for the page's final access, the number of distinct pages
    accessed afterwards (suffix count of last-occurrence flags). ``M_j``
    is the segmented running max of ``d`` since the page's last write
    (reset to 0 at writes, infinity while never written). Returns int64
    ``[S, len(sizes)]``.
    """
    m = int(sizes_arr.size)
    # Flat valid-entry views, ordered by (shard, position) — row-major.
    pos_v = np.broadcast_to(
        np.arange(sh_pages_b.shape[1])[None, :], sh_pages_b.shape
    )[vmask].astype(np.int64)
    page_v = sh_pages_b[vmask].astype(np.int64)
    cap = sh_pages_b.shape[1]
    w_b = np.zeros(sh_pages_b.shape, bool)
    w_b[:, : sh_writes.shape[1]] = sh_writes
    w_v = w_b[vmask]

    # Group same-page accesses: stable order (shard, page, position).
    order = np.lexsort((pos_v, page_v, s_idx))
    n = order.size
    if n == 0:
        return np.zeros((S, m), np.int64)
    run_start = np.ones(n, bool)
    run_start[1:] = (s_idx[order[1:]] != s_idx[order[:-1]]) | (
        page_v[order[1:]] != page_v[order[:-1]]
    )
    run_end = np.empty(n, bool)
    run_end[:-1] = run_start[1:]
    run_end[-1] = True

    # d_end: distinct pages after a final access = later last-occurrences
    # in the same shard (in original per-shard position order).
    lastocc = np.zeros(n, np.int64)
    lastocc[order] = run_end.astype(np.int64)
    cum = np.cumsum(lastocc)
    shard_tot = np.bincount(s_idx, weights=lastocc,
                            minlength=S).astype(np.int64)
    d_end = np.cumsum(shard_tot)[s_idx] - cum

    # U per gap (in run order): next access's distance, or d_end at run end.
    d_run = d_v[order]
    u_run = np.empty(n, np.int64)
    u_run[:-1] = d_run[1:]
    u_run[run_end] = d_end[order][run_end]

    # M per gap: segmented cummax of (0 at writes, d otherwise) with
    # segments opening at run starts and at writes. Monotone segment
    # offsets turn the reset-cummax into one np.maximum.accumulate.
    x = np.where(w_v[order], 0, d_run)
    seg = np.cumsum(run_start | w_v[order]).astype(np.int64)
    big = np.int64(1) << 33                                # > DIST_INF
    m_run = np.maximum.accumulate(x + seg * big) - seg * big

    # Gap contributes to size indices [lo, hi): C > M and C <= U. Empty
    # episodes (M >= U: clean line, or no eviction before reuse) must
    # contribute nothing — without the clamp their reversed [hi, lo)
    # difference interval would *subtract* from other episodes' counts.
    lo = np.searchsorted(sizes_arr, m_run, side="right")
    hi = np.maximum(np.searchsorted(sizes_arr, u_run, side="right"), lo)
    s_run = s_idx[order]
    diff = np.zeros((S, m + 1), np.int64)
    np.add.at(diff, (s_run, lo), 1)
    np.add.at(diff, (s_run, hi), -1)
    return np.cumsum(diff, axis=1)[:, :m]


def mrc_curve(spec: SimSpec, sizes: Sequence[int], trace=None, *,
              device=None):
    """Convenience: ``(sizes, miss_rates)`` arrays for a spec over a grid
    of cache sizes — the paper's capacity-planning curve — from one pass
    on ``device`` (``None`` = the card). ``sizes`` is deduplicated and
    sorted ascending."""
    ctrs = mrc_tier1_counters(spec, sizes, trace, device=device)
    sz = np.asarray(sorted(ctrs), np.int64)
    mr = np.asarray([
        ctrs[int(c)].misses.sum() / max(int(ctrs[int(c)].requests.sum()), 1)
        for c in sz
    ])
    return sz, mr
