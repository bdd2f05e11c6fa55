"""The two-tier storage engine (paper §III) on PyTorch.

Semantics per request (page, is_write), faithful to the paper:

1. **Lookup** in the fully-associative tier-1 cache. A hit updates the
   timestamp (LRU), frequency counter (LFU) and dirty bit.
2. A **miss** first probes the prefetch buffer; a buffered page is promoted
   to the cache without a tier-2 access. Otherwise the page is fetched from
   tier 2 (one tier-2 read).
3. Insertion uses a free line if one exists; otherwise **GetVictim**
   (Algorithm 1) selects the eviction expert by probability, every expert's
   proposal is recorded in its prediction vector, and the chosen victim is
   evicted (a dirty victim costs one tier-2 write-back).
4. The **stream identifier** observes the miss stream and issues prefetches
   into free buffer slots ("page misses are prioritized over prefetches").
5. Every ``epoch_width`` iterations, **WeightAdjust** (Algorithm 2) runs and
   prediction vectors are cleared.

The request loop is :func:`repro_torch.kernels.cache_scan.fused_cache_scan`:
a hand-written CUDA kernel on the card (one thread block per shard row)
and its plain PyTorch version on the CPU. Shards are independent (no
replication, no migration), so :func:`run_distributed` runs all of them as
the rows of one launch.

**Windowed telemetry.** Every per-request outcome is also counted in
``n_windows`` window slots by the request's window id: its wall-clock time
bin, or its global stream position ``g`` mapped to ``g * n_windows // T``.
Padding positions carry the out-of-range id ``n_windows`` and drop out, so
windowed counters count real requests only, while the whole-stream
counters include pads and are corrected by :func:`correct_padded_stats`.
``win_expert_use`` counts evictions per expert per window and
``win_weights`` holds the expert weights at each window's last request
(zeros where a window saw none).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import online_learning as ol
from repro_torch.core import prefetch as pfm
from repro_torch.core.mapping import page_to_shard
from repro_torch.device import resolve_device
from repro_torch.kernels import threefry
from repro_torch.kernels.cache_scan import (
    cold_keys, fused_cache_scan, per_row)
from repro_torch.storage.cache_state import CacheState, init_cache

__all__ = [
    "StoreConfig",
    "StoreHyper",
    "StoreState",
    "StreamStats",
    "POLICY_TO_IDX",
    "init_store",
    "init_accum",
    "stack_rows",
    "run_stream",
    "run_distributed",
    "partition_streams",
    "stream_window_ids",
    "timestamp_window_ids",
    "correct_padded_stats",
]

# Policy selector convention: ws (online learning) = -1, experts by their
# index in ol.EXPERTS.
WS_POLICY_IDX = -1
POLICY_TO_IDX = {"ws": WS_POLICY_IDX,
                 **{name: i for i, name in enumerate(ol.EXPERTS)}}


class StoreHyper(NamedTuple):
    """The scalar online-learning knobs of a :class:`StoreConfig` as
    tensors (scalars or one value per row). ``policy_idx`` follows
    :data:`POLICY_TO_IDX` (``-1`` = weight-sharing online learning)."""

    alpha: torch.Tensor      # f32 weight-share rate
    beta: torch.Tensor       # f32 multiplicative penalty base
    threshold: torch.Tensor  # f32 misprediction threshold fraction
    policy_idx: torch.Tensor  # i32 expert index, -1 = online learning


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    n_lines: int = 64
    policy: str = "ws"  # ws | lru | lfu | random
    epoch_width: int = 4
    alpha: float = 0.5
    beta: float = 0.7
    threshold: float = 0.25
    pred_cap: int = 64
    prefetch: bool = False
    prefetch_width: int = 4
    prefetch_buf: int = 16

    def ol_config(self) -> ol.OLConfig:
        return ol.OLConfig(
            epoch_width=self.epoch_width,
            alpha=self.alpha,
            beta=self.beta,
            threshold=self.threshold,
            pred_cap=self.pred_cap,
        )

    def hyper(self, *, device=None) -> StoreHyper:
        """This config's scalar knobs as :class:`StoreHyper` tensors."""
        try:
            idx = POLICY_TO_IDX[self.policy]
        except KeyError:
            raise ValueError(
                f"unknown policy {self.policy!r}; "
                f"options: {sorted(POLICY_TO_IDX)}"
            ) from None
        f32 = dict(dtype=torch.float32, device=device)
        return StoreHyper(
            alpha=torch.tensor(self.alpha, **f32),
            beta=torch.tensor(self.beta, **f32),
            threshold=torch.tensor(self.threshold, **f32),
            policy_idx=torch.tensor(idx, dtype=torch.int32, device=device),
        )


class StoreState(NamedTuple):
    cache: CacheState
    ols: ol.OLState
    pf: pfm.PrefetchState
    t: torch.Tensor     # int32 iteration counter
    key: torch.Tensor   # int64[2] threefry key words (uint32 values)


class StreamStats(NamedTuple):
    """Aggregated counters for processed request streams (one row per
    shard). Scalar fields are whole-stream totals (padding included);
    ``win_*`` fields resolve the same counters over ``n_windows`` time
    windows (last axis; padding excluded)."""

    requests: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    prefetch_hits: torch.Tensor  # misses serviced from the prefetch buffer
    tier2_reads: torch.Tensor    # demand fetches + prefetch fetches
    tier2_writes: torch.Tensor   # dirty write-backs
    evictions: torch.Tensor
    expert_use: torch.Tensor     # int32[..., E] evictions issued per expert
    final_weights: torch.Tensor  # f32[..., E]
    win_requests: torch.Tensor   # int32[..., n_windows]
    win_hits: torch.Tensor
    win_misses: torch.Tensor
    win_prefetch_hits: torch.Tensor
    win_tier2_reads: torch.Tensor
    win_tier2_writes: torch.Tensor
    win_evictions: torch.Tensor
    win_expert_use: torch.Tensor  # int32[..., n_windows, E]
    win_weights: torch.Tensor     # f32[..., n_windows, E]


class Accum(NamedTuple):
    """Counter accumulators of a batch of rows: whole-stream totals plus
    ``n_windows`` windowed slots (the reference's ``_Accum``)."""

    hits: torch.Tensor
    misses: torch.Tensor
    prefetch_hits: torch.Tensor
    tier2_reads: torch.Tensor
    tier2_writes: torch.Tensor
    evictions: torch.Tensor
    expert_use: torch.Tensor      # int32[B, E]
    win_requests: torch.Tensor    # int32[B, W]
    win_hits: torch.Tensor
    win_misses: torch.Tensor
    win_prefetch_hits: torch.Tensor
    win_tier2_reads: torch.Tensor
    win_tier2_writes: torch.Tensor
    win_evictions: torch.Tensor
    win_expert_use: torch.Tensor  # int32[B, W, E]
    win_weights: torch.Tensor     # f32[B, W, E]


def init_store(cfg: StoreConfig, seed: int = 0, *, device=None) -> StoreState:
    """Cold tier-1 state of one shard (:func:`stack_rows` batches it)."""
    return StoreState(
        cache=init_cache(cfg.n_lines, device=device),
        ols=ol.init_ol(cfg.ol_config(), device=device),
        pf=pfm.init_prefetch(cfg.prefetch_buf, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device),
        key=torch.tensor(threefry.prng_key(seed), dtype=torch.int64,
                         device=device),
    )


def stack_rows(state, n_rows: int):
    """Repeat every leaf of a one-row state pytree along a new leading
    row axis."""
    if isinstance(state, torch.Tensor):
        return state[None].repeat((n_rows,) + (1,) * state.dim())
    return type(state)(*(stack_rows(x, n_rows) for x in state))


def init_accum(n_rows: int, n_windows: int, *, device=None) -> Accum:
    i32 = dict(dtype=torch.int32, device=device)
    E = ol.N_EXPERTS
    zero = torch.zeros(n_rows, **i32)
    zw = torch.zeros(n_rows, n_windows, **i32)
    return Accum(
        hits=zero, misses=zero, prefetch_hits=zero, tier2_reads=zero,
        tier2_writes=zero, evictions=zero,
        expert_use=torch.zeros(n_rows, E, **i32),
        win_requests=zw, win_hits=zw, win_misses=zw, win_prefetch_hits=zw,
        win_tier2_reads=zw, win_tier2_writes=zw, win_evictions=zw,
        win_expert_use=torch.zeros(n_rows, n_windows, E, **i32),
        win_weights=torch.zeros(n_rows, n_windows, E, dtype=torch.float32,
                                device=device),
    )


def stream_window_ids(n: int, n_windows: int) -> np.ndarray:
    """Window id per stream position: position ``g`` of an ``n``-long stream
    belongs to window ``g * n_windows // n`` (equal request-count slices of
    the global timeline)."""
    if n_windows < 1:
        raise ValueError("n_windows must be >= 1")
    if n == 0:
        return np.zeros(0, np.int32)
    return (np.arange(n, dtype=np.int64) * n_windows // n).astype(np.int32)


def timestamp_window_ids(times: np.ndarray, n_windows: int,
                         window_dt: float) -> np.ndarray:
    """Wall-clock window id per request: arrival time ``t`` belongs to bin
    ``t // window_dt``, clipped into the last bin. Negative times mark
    padding and map to the dropped id ``n_windows``. Binning is float64 on
    the host: an f32 ratio loses whole-integer resolution past ~2^24."""
    if n_windows < 1:
        raise ValueError("n_windows must be >= 1")
    if window_dt <= 0:
        raise ValueError("window_dt must be positive")
    t = np.asarray(times, np.float64)
    # Clip in float space before the integer cast: a ratio beyond int32
    # must saturate into the last bin, not wrap.
    ids = np.clip(t / np.float64(window_dt), 0,
                  np.float64(n_windows - 1)).astype(np.int32)
    return np.where(t >= 0, ids, n_windows).astype(np.int32)


def _check_engine(engine: str) -> None:
    if engine == "scan":
        raise NotImplementedError(
            "engine='scan' (the per-step reference engine) is not ported "
            "yet; it lands with the chunked-replay slice")
    if engine != "fused":
        raise ValueError(f"unknown engine {engine!r}; options: fused, scan")


def _run_rows(cfg: StoreConfig, pages, writes, win, *, seed: int,
              hyper: Optional[StoreHyper], n_windows: int, device):
    """The fused engine over ``[B, L]`` rows from the cold state, on
    ``device``: returns un-corrected :class:`StreamStats` with a row
    axis."""
    pages = torch.as_tensor(np.asarray(pages, np.int32), device=device)
    writes = torch.as_tensor(np.asarray(writes, bool), device=device)
    win = torch.as_tensor(np.asarray(win, np.int32), device=device)
    B, L = pages.shape
    if hyper is None:
        hyper = cfg.hyper()
    out = fused_cache_scan(cfg, per_row(hyper, B, device),
                           cold_keys(seed, B, device), pages, writes, win,
                           n_windows=n_windows)
    return StreamStats(
        requests=torch.full((B,), L, dtype=torch.int32, device=device),
        **out)


def run_stream(
    cfg: StoreConfig,
    pages,
    is_write,
    *,
    seed: int = 0,
    hyper: Optional[StoreHyper] = None,
    n_windows: int = 1,
    window_ids=None,
    timestamps=None,
    window_dt=None,
    engine: str = "fused",
    device=None,
) -> StreamStats:
    """Process a request stream through one tier-1 shard on ``device``
    (``None`` = the card).

    ``hyper`` overrides the scalar learning knobs of ``cfg``. The window of
    a request is, in precedence order: its wall-clock bin ``t // window_dt``
    when ``timestamps`` (arrival seconds, ``-1`` marking padding) and
    ``window_dt`` are given — binned in f32 as the reference's in-graph
    path does; an explicit ``window_ids`` assignment (values in
    ``[0, n_windows]``, ``n_windows`` = padding); by default, equal
    request-count slices of this stream.

    Only ``engine="fused"`` is ported; the per-step ``"scan"`` reference
    engine belongs to the chunked-replay slice."""
    _check_engine(engine)
    device = resolve_device(device)
    pages = np.asarray(pages, np.int32)
    is_write = np.asarray(is_write, bool)
    if timestamps is not None:
        if window_dt is None:
            raise ValueError("timestamps need a window_dt (seconds per bin)")
        ts = torch.as_tensor(np.asarray(timestamps, np.float32))
        ratio = ts / torch.tensor(window_dt, dtype=torch.float32)
        ids = ratio.clamp(0.0, float(n_windows - 1)).to(torch.int32)
        window_ids = torch.where(ts >= 0, ids, n_windows).numpy()
    elif window_ids is None:
        window_ids = stream_window_ids(pages.shape[0], n_windows)
    stats = _run_rows(cfg, pages[None], is_write[None],
                      np.asarray(window_ids, np.int32)[None], seed=seed,
                      hyper=hyper, n_windows=n_windows, device=device)
    return StreamStats(*(x[0] for x in stats))


def partition_streams(
    pages: np.ndarray,
    is_write: np.ndarray,
    *,
    n_shards: int,
    mapping: str = "block",
    n_pages: Optional[int] = None,
    cap: Optional[int] = None,
    n_windows: Optional[int] = None,
    window_ids: Optional[np.ndarray] = None,
    times: Optional[np.ndarray] = None,
    owner: Optional[np.ndarray] = None,
):
    """Partition a request stream into per-shard substreams (§III mapping).

    Each shard's substream is padded to ``cap`` (default: the max shard load)
    with repeats of its own last page — pure hits, so every counter except
    ``requests``/``hits`` is unaffected and those two are correctable from
    the pad length. Returns ``(sh_pages [S, cap], sh_writes [S, cap],
    counts [S], owner [n])``; with ``n_windows`` set, additionally
    ``sh_win [S, cap]`` window ids (global ``window_ids`` when given, else
    equal-count slices of the global stream; pads carry ``n_windows``).
    With ``times`` set, additionally ``sh_times [S, cap]`` float32 arrival
    timestamps (pads carry ``-1``). ``owner`` overrides the mapping with
    precomputed (e.g. failover-remapped) owners.
    """
    pages = np.asarray(pages)
    is_write = np.asarray(is_write, bool)
    n_pages = int(n_pages if n_pages is not None else (pages.max() + 1))
    if owner is None:
        owner = page_to_shard(pages, n_shards, n_pages, mapping)
    else:
        owner = np.asarray(owner)
        if owner.shape != pages.shape:
            raise ValueError("owner must align with the request stream")
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(cap if cap is not None else max(int(counts.max()), 1))
    if cap < counts.max():
        raise ValueError(f"cap={cap} < max shard load {int(counts.max())}")
    # Stable shard sort: request j lands at row owner[j], column = its rank
    # within its shard.
    order, row, col = _shard_positions(owner, counts)
    sh_pages = np.zeros((n_shards, cap), np.int32)
    sh_writes = np.zeros((n_shards, cap), bool)
    sh_pages[row, col] = pages[order]
    sh_writes[row, col] = is_write[order]
    # Pad each shard with its own last page — pure hits (empty shards keep
    # page 0, whose first access is the phantom miss correct_padded_stats
    # zeroes out).
    last = sh_pages[np.arange(n_shards), np.maximum(counts - 1, 0)]
    pad = np.arange(cap)[None, :] >= counts[:, None]
    sh_pages = np.where(pad, last[:, None], sh_pages)
    out = [sh_pages, sh_writes, counts, owner]
    if window_ids is not None:
        if n_windows is None:
            raise ValueError("window_ids need n_windows (the dropped pad id)")
        window_ids = np.asarray(window_ids, np.int32)
        if window_ids.shape != owner.shape:
            raise ValueError("window_ids must align with the request stream")
    elif n_windows is not None:
        window_ids = stream_window_ids(owner.shape[0], n_windows)
    if window_ids is not None:
        sh_win = np.full((n_shards, cap), n_windows, np.int32)
        sh_win[row, col] = window_ids[order]
        out.append(sh_win)
    if times is not None:
        times = np.asarray(times, np.float32)
        if times.shape != owner.shape:
            raise ValueError("times must align with the request stream")
        sh_times = np.full((n_shards, cap), -1.0, np.float32)
        sh_times[row, col] = times[order]
        out.append(sh_times)
    return tuple(out)


def _shard_positions(owner: np.ndarray, counts: np.ndarray):
    """(order, row, col) scatter coordinates: the stable shard-sort of the
    request indices, and for each sorted request its owning shard and rank
    within that shard."""
    order = np.argsort(owner, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    row = owner[order]
    col = np.arange(owner.shape[0]) - starts[row]
    return order, row, col


def correct_padded_stats(stats: StreamStats, counts, cap: int) -> StreamStats:
    """Undo padding artifacts in per-shard stats from padded substreams
    (see :func:`partition_streams`): padded requests are pure hits on each
    shard's last page (subtracted from ``hits``), and a shard with no real
    requests ran a pure-padding stream whose first access is a phantom
    miss (all its counters are zeroed). Windowed counters need no
    correction: pads carry the dropped window id."""
    dev = stats.hits.device
    counts = torch.as_tensor(np.asarray(counts), dtype=torch.int32,
                             device=dev)
    pad = cap - counts
    nonempty = counts > 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return stats._replace(
        requests=counts,
        hits=torch.clamp(stats.hits - pad, min=0),
        misses=torch.where(nonempty, stats.misses, zero),
        prefetch_hits=torch.where(nonempty, stats.prefetch_hits, zero),
        tier2_reads=torch.where(nonempty, stats.tier2_reads, zero),
        tier2_writes=torch.where(nonempty, stats.tier2_writes, zero),
        evictions=torch.where(nonempty, stats.evictions, zero),
    )


def run_distributed(
    cfg: StoreConfig,
    pages: np.ndarray,
    is_write: np.ndarray,
    *,
    n_shards: int,
    mapping: str = "block",
    n_pages: Optional[int] = None,
    seed: int = 0,
    n_windows: int = 1,
    timestamps: Optional[np.ndarray] = None,
    window_dt: Optional[float] = None,
    owner: Optional[np.ndarray] = None,
    engine: str = "fused",
    device=None,
):
    """Distributed tier-1 cache: requests partitioned to per-shard caches by
    the §III mapping policy; the ``[n_shards, cap]`` shard rows run as one
    batched engine call on ``device`` (``None`` = the card).

    Returns ``(per_shard_stats, shard_request_counts)``; per-shard stats are
    padding-corrected. ``n_windows`` resolves every counter over time
    windows of the *global* stream: wall-clock bins of ``window_dt``
    seconds when ``timestamps`` are supplied (binned in float64 on the
    host), equal request-count slices otherwise. ``owner`` optionally
    overrides the mapping policy with precomputed owners.
    """
    _check_engine(engine)
    device = resolve_device(device)
    gwin = None
    if timestamps is not None:
        if window_dt is None:
            raise ValueError("timestamps need a window_dt (seconds per bin)")
        gwin = timestamp_window_ids(timestamps, n_windows, window_dt)
    sh_pages, sh_writes, counts, owner, sh_win = partition_streams(
        pages, is_write, n_shards=n_shards, mapping=mapping,
        n_pages=n_pages, n_windows=n_windows, window_ids=gwin, owner=owner,
    )
    stats = _run_rows(cfg, sh_pages, sh_writes, sh_win, seed=seed,
                      hyper=None, n_windows=n_windows, device=device)
    return correct_padded_stats(stats, counts, sh_pages.shape[1]), counts
