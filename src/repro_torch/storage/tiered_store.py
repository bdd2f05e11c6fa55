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
the rows of one launch. ``engine="scan"`` selects the per-step engine
instead (:func:`_step` / :func:`_fold`, plain PyTorch on the device asked
for, no kernel): the golden the fused engine is bit-exact against.

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
from repro_torch.kernels import cache_scan as _cs
from repro_torch.kernels import threefry
from repro_torch.kernels.cache_scan import (
    cold_keys, fused_cache_scan, per_row)
from repro_torch.kernels.ref import _select, _wrap32
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
    "run_stream_chunked",
    "init_stream_carry",
    "stream_chunk_engine",
    "stream_stats_from_carry",
    "stream_compile_count",
    "reset_stream_compile_count",
    "tree_map",
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

    def static_config(self) -> "StoreConfig":
        """The structural residue of this config: every field that shapes
        the engine (array sizes, loop structure), with the per-row knobs
        (:class:`StoreHyper` fields) reset to class defaults. Rows of
        configs with equal ``static_config()`` share one kernel launch."""
        defaults = {
            f.name: f.default
            for f in dataclasses.fields(StoreConfig)
            if f.name in ("alpha", "beta", "threshold", "policy")
        }
        return dataclasses.replace(self, **defaults)


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
    if engine not in ("fused", "scan"):
        raise ValueError(f"unknown engine {engine!r}; options: fused, scan")


def _step(cfg: StoreConfig, hyper: StoreHyper, state: StoreState, page,
          is_write, pw):
    """One request on every row, the per-step engine: ``state`` is a
    :class:`StoreState` with a leading row axis, ``page`` / ``is_write``
    are ``[B]``, ``hyper`` holds ``[B]`` knobs and ``pw`` their
    :func:`~repro_torch.core.online_learning.pow_table`. Every select is
    the reference step's; the learner's update is
    :func:`repro_torch.core.online_learning.weight_adjust`. Returns
    ``(state, out)`` with ``out`` the step's ``[B]`` outcomes."""
    cache, ols, pf = state.cache, state.ols, state.pf
    t = state.t
    i32 = torch.int32
    page = page.to(i32)
    B, N = cache.tags.shape
    dev = page.device
    rows = torch.arange(B, device=dev)
    # The key chain on the host (a split is two threefry blocks a row).
    splits = [threefry.split(k) for k in state.key.tolist()]
    key = torch.tensor([k for k, _ in splits], dtype=torch.int64, device=dev)
    pg = page[:, None]

    # --- 1. lookup -------------------------------------------------------
    match = cache.valid & (cache.tags == pg)
    hit = match.any(-1)
    hit_idx = match.to(torch.uint8).argmax(-1)

    # --- 2/3. miss path ---------------------------------------------------
    miss = ~hit
    m1 = miss[:, None]
    hit_pred = (ols.pred == page[:, None, None]).any(-1)            # [B, E]
    ols = ols._replace(
        mispred=torch.where(m1, ols.mispred + hit_pred.to(i32), ols.mispred),
        epoch_misses=torch.where(m1, ols.epoch_misses + 1,
                                 ols.epoch_misses))
    if cfg.prefetch:
        pmatch = pf.pvalid & (pf.ptags == pg)
        in_buf = pmatch.any(-1)
        pf = pf._replace(
            pvalid=torch.where(m1 & pmatch, False, pf.pvalid),
            useful=torch.where(miss, pf.useful + in_buf.to(i32), pf.useful))
        promoted = miss & in_buf
    else:
        promoted = torch.zeros_like(miss)

    free = ~cache.valid
    has_free = free.any(-1)
    free_idx = free.to(torch.uint8).argmax(-1)

    # GetVictim: every expert proposes; the chosen expert's proposal is used.
    # The Random expert's uniforms are observable only on an eviction, so
    # they are drawn only when a row evicts.
    evict = miss & ~has_free
    if bool(evict.any()):
        vk = torch.tensor([v for _, v in splits], dtype=torch.int64,
                          device=dev)
        noise = threefry.uniform_f32(vk[:, 0], vk[:, 1], N, device=dev)
    else:
        noise = torch.zeros(B, N, dtype=torch.float32, device=dev)
    big = torch.iinfo(i32).max
    proposals = torch.stack([
        torch.where(cache.valid, cache.ts, big).argmin(-1),
        torch.where(cache.valid, cache.freq, big).argmin(-1),
        torch.where(cache.valid, noise, torch.full_like(noise, -1.0))
        .argmax(-1)], dim=1)                                        # [B, E]
    victim_pages = torch.gather(cache.tags, 1, proposals)
    chosen = ol.choose_expert(ols, hyper.policy_idx)
    victim_idx = proposals[rows, chosen.long()]

    slot = torch.where(has_free, free_idx, victim_idx)
    writeback = evict & cache.dirty[rows, slot]

    # Prediction vectors only when an eviction happens.
    col = (ols.pred_n % cfg.pred_cap).long()                        # [B, E]
    col_oh = (torch.arange(cfg.pred_cap, device=dev)
              == col[:, :, None])
    ev1 = evict[:, None]
    ols = ols._replace(
        pred=torch.where(ev1[:, :, None] & col_oh, victim_pages[:, :, None],
                         ols.pred),
        pred_n=torch.where(ev1, ols.pred_n + 1, ols.pred_n),
        chosen=torch.where(evict, chosen, ols.chosen[:, 0])[:, None])

    # Insert the missed page; a hit touches its own line.
    line = torch.arange(N, device=dev)
    at_slot = line == slot[:, None]
    at_hit = line == hit_idx[:, None]
    on_miss = m1 & at_slot
    on_hit = hit[:, None] & at_hit
    cache = CacheState(
        tags=torch.where(on_miss, pg, cache.tags),
        valid=cache.valid | on_miss,
        dirty=torch.where(on_miss, is_write[:, None], torch.where(
            on_hit, cache.dirty | is_write[:, None], cache.dirty)),
        freq=torch.where(on_miss, 1, torch.where(on_hit, cache.freq + 1,
                                                 cache.freq)),
        ts=torch.where(on_miss | on_hit, t[:, None], cache.ts),
    )

    # --- 4. stream identifier + prefetch issue ----------------------------
    if cfg.prefetch:
        delta = _wrap32(page.long() - pf.last_miss.long())
        same = (delta == pf.stride) & (pf.last_miss >= 0) & (delta != 0)
        pf = pf._replace(
            last_miss=torch.where(miss, page, pf.last_miss),
            stride=torch.where(miss, torch.where(
                same, pf.stride, torch.where(delta != 0, delta, pf.stride)),
                pf.stride),
            conf=torch.where(miss, torch.where(
                same, pf.conf + 1, torch.where(delta != 0, 1, pf.conf)),
                pf.conf))
        n_before = pf.issued
        active = pf.conf >= 2
        ptags, pvalid, issued = pf.ptags, pf.pvalid, pf.issued
        buf = torch.arange(ptags.shape[-1], device=dev)
        for k in range(cfg.prefetch_width):
            cand = _wrap32(page.long() + (k + 1) * pf.stride.long())
            in_cache = (cache.valid & (cache.tags == cand[:, None])).any(-1)
            in_b = (pvalid & (ptags == cand[:, None])).any(-1)
            bfree = ~pvalid
            do = active & bfree.any(-1) & ~in_cache & ~in_b & (cand >= 0)
            boh = (buf == bfree.to(torch.uint8).argmax(-1)[:, None]) \
                & do[:, None]
            ptags = torch.where(boh, cand[:, None], ptags)
            pvalid = pvalid | boh
            issued = issued + do.to(i32)
        pf = pf._replace(ptags=torch.where(m1, ptags, pf.ptags),
                         pvalid=torch.where(m1, pvalid, pf.pvalid),
                         issued=torch.where(miss, issued, pf.issued))
        prefetch_fetches = torch.where(miss, pf.issued - n_before, 0)
    else:
        prefetch_fetches = torch.zeros_like(page)

    # --- 5. epoch boundary (WeightAdjust, ws rows only) ---------------------
    fire = ((t + 1) % cfg.epoch_width == 0) & (hyper.policy_idx < 0)
    if bool(fire.any()):
        adj = ol.weight_adjust(ols, ol.OLConfig(
            epoch_width=cfg.epoch_width, alpha=hyper.alpha, beta=hyper.beta,
            threshold=hyper.threshold, pred_cap=cfg.pred_cap), pw)
        ols = _select(fire, adj, ols)

    out = dict(
        hit=hit,
        miss=miss,
        prefetch_hit=promoted,
        tier2_read=(miss & ~promoted).to(i32) + prefetch_fetches,
        tier2_write=writeback.to(i32),
        evict=evict,
        chosen=torch.where(evict, chosen, -1),
    )
    return StoreState(cache=cache, ols=ols, pf=pf, t=t + 1, key=key), out


def _fold(acc: Accum, out: dict, win, weights, n_windows: int) -> Accum:
    """Fold one request's outcome on every row into the accumulators.
    ``win[b] == n_windows`` (padding) drops out of the windowed counters
    but still counts toward the scalar totals. ``weights`` is the
    post-step weight vector: overwriting the window's row every step
    leaves each row holding the weights at that window's last request."""
    i32 = torch.int32
    hit, miss = out["hit"].to(i32), out["miss"].to(i32)
    pfh, ev = out["prefetch_hit"].to(i32), out["evict"].to(i32)
    t2r, t2w = out["tier2_read"].to(i32), out["tier2_write"].to(i32)
    expert = torch.where(out["evict"], out["chosen"], 0).long()
    eoh = torch.nn.functional.one_hot(expert, ol.N_EXPERTS).to(i32) \
        * ev[:, None]
    woh = (torch.arange(n_windows, device=win.device)
           == win[:, None])                                         # [B, W]
    wi = woh.to(i32)
    return Accum(
        hits=acc.hits + hit,
        misses=acc.misses + miss,
        prefetch_hits=acc.prefetch_hits + pfh,
        tier2_reads=acc.tier2_reads + t2r,
        tier2_writes=acc.tier2_writes + t2w,
        evictions=acc.evictions + ev,
        expert_use=acc.expert_use + eoh,
        win_requests=acc.win_requests + wi,
        win_hits=acc.win_hits + wi * hit[:, None],
        win_misses=acc.win_misses + wi * miss[:, None],
        win_prefetch_hits=acc.win_prefetch_hits + wi * pfh[:, None],
        win_tier2_reads=acc.win_tier2_reads + wi * t2r[:, None],
        win_tier2_writes=acc.win_tier2_writes + wi * t2w[:, None],
        win_evictions=acc.win_evictions + wi * ev[:, None],
        win_expert_use=acc.win_expert_use + wi[:, :, None] * eoh[:, None],
        win_weights=torch.where(woh[:, :, None], weights[:, None],
                                acc.win_weights),
    )


def _scan_rows(cfg: StoreConfig, hyper: StoreHyper, state, acc, pages,
               writes, win, *, n_windows: int, masked: bool):
    """The per-step engine over ``[B, L]`` rows on their device, from
    ``(state, acc)``; returns the new pair. ``masked=True`` is the chunk
    engine's mode: a pad (``win >= n_windows``) leaves the state (``t``
    and the key included) untouched and adds 0 to every counter."""
    real = win < n_windows
    if masked:
        # Positions that are pads on every row change nothing: dropped.
        keep = real.any(0)
        pages, writes, win, real = (x[:, keep] for x in
                                    (pages, writes, win, real))
    B, L = pages.shape
    hyper = per_row(hyper, B, pages.device)
    pw = ol.pow_table(hyper.beta, cfg.epoch_width).to(pages.device)
    writes = writes.to(torch.bool)
    for t in range(L):
        new, out = _step(cfg, hyper, state, pages[:, t], writes[:, t], pw)
        if masked:
            ok = real[:, t]
            new = _select(ok, new, state)
            out = {k: (v if k == "chosen" else v & ok if v.dtype == torch.bool
                       else torch.where(ok, v, 0)) for k, v in out.items()}
        state = new
        acc = _fold(acc, out, win[:, t], state.ols.weights, n_windows)
    return state, acc


def _run_rows(cfg: StoreConfig, pages, writes, win, *, seed: int,
              hyper: Optional[StoreHyper], n_windows: int, device,
              engine: str = "fused"):
    """The engine over ``[B, L]`` rows from the cold state, on ``device``:
    returns un-corrected :class:`StreamStats` with a row axis."""
    pages = torch.as_tensor(np.asarray(pages, np.int32), device=device)
    writes = torch.as_tensor(np.asarray(writes, bool), device=device)
    win = torch.as_tensor(np.asarray(win, np.int32), device=device)
    B, L = pages.shape
    if hyper is None:
        hyper = cfg.hyper()
    requests = torch.full((B,), L, dtype=torch.int32, device=device)
    if engine == "scan":
        state, acc = _scan_rows(
            cfg, hyper, stack_rows(init_store(cfg, seed, device=device), B),
            init_accum(B, n_windows, device=device), pages, writes, win,
            n_windows=n_windows, masked=False)
        return StreamStats(requests=requests, **acc._asdict(),
                           final_weights=state.ols.weights)
    out = fused_cache_scan(cfg, per_row(hyper, B, device),
                           cold_keys(seed, B, device), pages, writes, win,
                           n_windows=n_windows)
    return StreamStats(requests=requests, **out)


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

    ``engine`` selects the request loop: ``"fused"`` (the cache-scan
    kernel on the card, its plain version on the CPU) or ``"scan"``, the
    per-step engine the fused one is bit-exact against."""
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
                      hyper=hyper, n_windows=n_windows, device=device,
                      engine=engine)
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
                      hyper=None, n_windows=n_windows, device=device,
                      engine=engine)
    return correct_padded_stats(stats, counts, sh_pages.shape[1]), counts


# ---------------------------------------------------------------------------
# Chunked streaming replay: the masked engine over a carried state.
#
# The one-shot paths above hold the whole trace in one [shard, len] device
# array. The streaming path instead carries the full engine state — the
# [S]-stacked (StoreState, Accum) pair — across fixed-size chunks, so a
# trace of any length replays in O(S * chunk) device memory. Bit-exactness
# with the one-shot engine comes from masking: a chunk row's padding
# positions (window id >= n_windows) leave the carried state untouched
# (t not advanced, key not split) and add 0 to every counter, so the state
# seen by real request j of a shard is the same whatever the chunking.
# (The one-shot path instead runs trailing pads as pure hits and corrects
# the totals afterwards.)
#
# On the card the carry lives on the device and the cache-scan kernel's
# masked mode updates it in place. Each chunk shape has one preallocated
# buffer set: pinned host buffers the host partitions into, and device
# buffers a side stream copies them to with non_blocking copies, ordered
# after the previous launch that read them; the launch waits for the copy.
# So chunk k+1 is generated, binned and partitioned on the host while
# chunk k's launch runs.
# ---------------------------------------------------------------------------

# Chunk engines are cached per (static store, n_windows, donate, engine,
# device); the counter counts the chunk shapes they take, one per distinct
# (n_shards, cap) — on the card, one buffer set each.
_STREAM_CACHE: dict = {}
_STREAM_COMPILES = [0]


def stream_compile_count() -> int:
    """Number of chunk shapes the chunk engines have taken so far, one per
    shape and engine — on the card with donation, the buffer sets they
    allocated. The counterpart of the reference's XLA compiles of its
    chunk engine."""
    return _STREAM_COMPILES[0]


def reset_stream_compile_count() -> None:
    _STREAM_COMPILES[0] = 0


def init_stream_carry(cfg: StoreConfig, n_shards: int, *, seed: int = 0,
                      n_windows: int = 1, device=None):
    """Fresh ``[n_shards]``-stacked ``(StoreState, Accum)`` chunk-engine
    carry on ``device`` (``None`` = the card): every shard starts from the
    cold :func:`init_store` state (same seed, as :func:`run_distributed`
    starts each shard) with zeroed accumulators. Every leaf is its own
    contiguous tensor, so the kernel may update it in place."""
    device = resolve_device(device)
    state = stack_rows(init_store(cfg, seed, device=device), n_shards)
    acc = Accum(*(x.clone() for x in init_accum(n_shards, n_windows,
                                                device=device)))
    return state, acc


def tree_map(fn, tree):
    """``fn`` on every leaf (a tensor or an array) of a carry: nested
    tuples and named tuples, rebuilt with the same types."""
    if not isinstance(tree, tuple):
        return fn(tree)
    parts = [tree_map(fn, x) for x in tree]
    return tuple(parts) if type(tree) is tuple else type(tree)(*parts)


class _Buffers:
    """One chunk shape's buffers on the card: pinned host arrays the host
    fills, device arrays a side stream copies them to, and the events that
    order the two against the launches."""

    def __init__(self, shape, device):
        i32 = torch.int32
        self.host = [torch.empty(shape, dtype=i32).pin_memory()
                     for _ in range(3)]
        self.dev = [torch.empty(shape, dtype=i32, device=device)
                    for _ in range(3)]
        self.copied = torch.cuda.Event()    # the host arrays are free again
        self.consumed = torch.cuda.Event()  # the device arrays are read


class _ChunkEngine:
    """``(hyper, carry, pages [S, L], writes [S, L], win [S, L]) -> carry``
    for one structural store config; see :func:`stream_chunk_engine`."""

    def __init__(self, cfg: StoreConfig, n_windows: int, donate: bool,
                 engine: str, device: torch.device):
        self.cfg, self.n_windows = cfg, n_windows
        self.donate, self.engine, self.device = donate, engine, device
        self.shapes: set = set()
        self.buffers: dict = {}
        self.knobs = None
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     and donate and engine == "fused" else None)

    def _count(self, shape) -> None:
        if shape not in self.shapes:
            self.shapes.add(shape)
            _STREAM_COMPILES[0] += 1

    def _rows_knobs(self, hyper, B: int):
        """The hyper knobs as ``[B]`` tensors on the device, built once per
        setting (a host-to-device copy of pageable memory would wait for
        the launches queued before it)."""
        key = (B,) + tuple(tuple(torch.as_tensor(x).reshape(-1).tolist())
                           for x in hyper)
        if self.knobs is None or self.knobs[0] != key:
            rows = per_row(hyper, B, self.device)
            pw = ol.pow_table(rows.beta, self.cfg.epoch_width).to(self.device)
            self.knobs = (key, rows, pw)
        return self.knobs[1:]

    def __call__(self, hyper, carry, pages, writes, win):
        pages = np.asarray(pages)
        shape = tuple(pages.shape)
        if pages.size and int(pages.min()) < 0:
            raise ValueError("page ids must be non-negative (-1 marks a free "
                             "cache line)")
        self._count(shape)
        state, acc = carry
        dev = self.device
        if self.side is None:
            # The plain paths and the synchronous baseline: fresh device
            # tensors for every chunk, and (without donation) a new carry.
            p, w, wi = (torch.as_tensor(np.asarray(x, np.int32), device=dev)
                        for x in (pages, writes, win))
            if not self.donate:
                state, acc = tree_map(torch.clone, (state, acc))
            if self.engine == "scan":
                return _scan_rows(self.cfg, hyper, state, acc, p, w, wi,
                                  n_windows=self.n_windows, masked=True)
            return _cs.masked_cache_scan(self.cfg, hyper, state, acc, p, w,
                                         wi, n_windows=self.n_windows)
        bufs = self.buffers.get(shape)
        if bufs is None:
            bufs = self.buffers[shape] = _Buffers(shape, dev)
        bufs.copied.synchronize()  # the last copy out of the host arrays
        for h, x in zip(bufs.host, (pages, writes, win)):
            np.copyto(h.numpy(), x, casting="unsafe")
        main = torch.cuda.current_stream(dev)
        with torch.cuda.stream(self.side):
            self.side.wait_event(bufs.consumed)
            for d, h in zip(bufs.dev, bufs.host):
                d.copy_(h, non_blocking=True)
            bufs.copied.record(self.side)
        main.wait_event(bufs.copied)
        rows, pw = self._rows_knobs(hyper, shape[0])
        out = _cs.masked_cache_scan_cuda(
            self.cfg, rows, state, acc, *bufs.dev, n_windows=self.n_windows,
            pw=pw, check_pages=False)
        bufs.consumed.record(main)
        return out


def stream_chunk_engine(cfg: StoreConfig, *, unroll: int = 1,
                        n_windows: int = 1, donate: bool = True,
                        engine: str = "fused", device=None):
    """The chunk engine for a structural store config on ``device``
    (``None`` = the card): ``(hyper, carry, pages [S, L], writes [S, L],
    win [S, L]) -> carry``, the chunk rows as host arrays.

    On the card the fused engine is the cache-scan kernel's masked mode:
    it updates the carry in place, and the chunk goes through the buffer
    set of its shape (pinned host arrays, a side-stream copy, device
    arrays), so peak device memory is the carry plus one set a shape, and
    the call returns while the launch runs. ``donate=False`` is the
    synchronous per-chunk baseline: fresh device arrays, a new carry, and
    the caller waits for each chunk. ``hyper`` may change between calls;
    padding positions carry window id ``n_windows`` and are masked no-ops.
    ``engine="scan"`` runs the per-step engine instead (plain PyTorch on
    the device, bit-exact, masked pads included). ``unroll`` (a
    ``lax.scan`` knob in the reference) is accepted and has no effect."""
    _check_engine(engine)
    device = resolve_device(device)
    static = cfg.static_config()
    key = (static, n_windows, donate, engine, device)
    eng = _STREAM_CACHE.get(key)
    if eng is None:
        eng = _STREAM_CACHE[key] = _ChunkEngine(static, n_windows, donate,
                                                engine, device)
    return eng


def stream_stats_from_carry(carry, counts) -> StreamStats:
    """:class:`StreamStats` from a chunk-engine carry. ``counts`` is the
    per-shard count of real requests streamed so far. No padding
    correction applies — masked pads never touched the accumulators — so
    the result compares directly with :func:`run_distributed`'s
    padding-corrected per-shard stats."""
    state, acc = carry
    if isinstance(acc.hits, torch.Tensor):
        requests = torch.as_tensor(np.asarray(counts), dtype=torch.int32,
                                   device=acc.hits.device)
    else:  # a host-numpy carry (a checkpoint's)
        requests = np.asarray(counts, np.int32)
    return StreamStats(requests=requests, final_weights=state.ols.weights,
                       **acc._asdict())


def run_stream_chunked(
    cfg: StoreConfig,
    pages: np.ndarray,
    is_write: np.ndarray,
    *,
    chunk: int,
    seed: int = 0,
    hyper: Optional[StoreHyper] = None,
    unroll: int = 1,
    n_windows: int = 1,
    window_ids: Optional[np.ndarray] = None,
    engine: str = "fused",
    device=None,
) -> StreamStats:
    """Single-shard chunked replay on ``device`` (``None`` = the card):
    :func:`run_stream` semantics, consumed ``chunk`` requests at a time
    through the resumable chunk engine. Equal to ``run_stream(cfg, pages,
    is_write, ...)`` in every counter (``final_weights`` may differ only
    where that one-shot call was itself padded). The multi-shard,
    generator-fed path is :func:`repro_torch.sim.stream.simulate_stream`."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    pages = np.asarray(pages, np.int32)
    is_write = np.asarray(is_write, bool)
    n = pages.shape[0]
    if window_ids is None:
        window_ids = stream_window_ids(n, n_windows)
    window_ids = np.asarray(window_ids, np.int32)
    if hyper is None:
        hyper = cfg.hyper()
    eng = stream_chunk_engine(cfg, unroll=unroll, n_windows=n_windows,
                              engine=engine, device=device)
    carry = init_stream_carry(cfg, 1, seed=seed, n_windows=n_windows,
                              device=device)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        p = np.zeros(chunk, np.int32)
        w = np.zeros(chunk, bool)
        wi = np.full(chunk, n_windows, np.int32)  # tail padding: masked
        p[: stop - start] = pages[start:stop]
        w[: stop - start] = is_write[start:stop]
        wi[: stop - start] = window_ids[start:stop]
        carry = eng(hyper, carry, p[None], w[None], wi[None])
    stats = stream_stats_from_carry(carry, np.array([n], np.int32))
    return StreamStats(*(x[0] for x in stats))
