"""Plain PyTorch version of the fused tier-1 cache scan.

One request step of the storage engine on a batch of shard rows, written
with whole-tensor selects (``torch.where`` on one-hot masks) the way the
reference's one-hot step is. It is the CPU path of
:func:`repro_torch.kernels.cache_scan.fused_cache_scan` and the version
the CUDA kernel is held against on the card, field for field.

Layout: every state leaf carries a leading row axis ``[B, ...]`` (the
reference ``vmap``s over shards instead), and the request loop is a Python
loop over the stream axis (the reference's ``lax.scan``). The per-request
outcomes are stacked and folded into the counters afterwards
(:func:`fused_fold`), since the fold is commutative.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import online_learning as _ol
from repro_torch.kernels import threefry

__all__ = ["fused_cache_step", "fused_fold", "cache_scan_ref",
           "NOISE_CHUNK"]

# Steps per batch of Random-expert draws when no shared table is given.
NOISE_CHUNK = 256
_I32_MIN, _I32_SPAN = -(2**31), 2**32


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around (the reference's
    int32 arithmetic)."""
    return ((x - _I32_MIN) % _I32_SPAN + _I32_MIN).to(torch.int32)


class _ScanCache(NamedTuple):
    """Slim cache carry: the ``CacheState`` fields the scan needs, with
    ``valid`` replaced by a fill count. Lines fill strictly in order
    (inserts take the lowest free index, nothing invalidates), so
    ``valid`` is exactly ``tags >= 0`` and the next free index is the
    fill count itself."""

    tags: torch.Tensor     # int32[B, N]
    dirty: torch.Tensor    # bool[B, N]
    freq: torch.Tensor     # int32[B, N]
    ts: torch.Tensor       # int32[B, N]
    n_valid: torch.Tensor  # int32[B]


def fused_cache_step(state, page, is_write, noise, hyper, *,
                     epoch_width: int, pred_cap: int, prefetch: bool,
                     prefetch_width: int, pw: Optional[torch.Tensor] = None):
    """One request on every row. ``state`` has the ``StoreState`` fields
    with a leading row axis (``cache`` a :class:`_ScanCache`), ``page`` and
    ``is_write`` are ``[B]``, ``noise`` is this step's Random-expert draw
    (``[B, N]`` or a shared ``[N]``), ``hyper`` holds ``[B]`` or scalar
    knobs and ``pw`` is their :func:`~repro_torch.core.online_learning.
    pow_table`. The PRNG key is the caller's. Returns ``(state, out)``
    with ``out`` the reference step's dict of ``[B]`` outcomes."""
    cache, ols, pf = state.cache, state.ols, state.pf
    t = state.t
    i32 = torch.int32
    page = page.to(i32)
    B, n_lines = cache.tags.shape
    dev = cache.tags.device
    line = torch.arange(n_lines, device=dev)
    E = _ol.N_EXPERTS
    pg = page[:, None]

    # --- 1. lookup: free lines hold -1, never a page id ------------------
    match = cache.tags == pg
    hit = match.any(-1)

    # --- 2/3. miss path ---------------------------------------------------
    miss = ~hit
    hit_pred = (ols.pred == page[:, None, None]).any(-1)           # [B, E]
    ols = ols._replace(
        mispred=ols.mispred + torch.where(miss[:, None], hit_pred.to(i32), 0),
        epoch_misses=ols.epoch_misses + miss.to(i32)[:, None],
    )
    if prefetch:
        pmatch = pf.pvalid & (pf.ptags == pg)
        in_buf = pmatch.any(-1)
        pf = pf._replace(
            pvalid=torch.where(miss[:, None] & pmatch, False, pf.pvalid),
            useful=pf.useful + (miss & in_buf).to(i32),
        )
        promoted = miss & in_buf
    else:
        promoted = torch.zeros_like(miss)

    has_free = cache.n_valid < n_lines
    free_idx = cache.n_valid

    # GetVictim: arg-reductions (first index on ties, as torch documents),
    # unmasked — the victims are observable only on an eviction, where
    # every line is valid.
    noise = noise.expand(B, n_lines)
    proposals = torch.stack([cache.ts.argmin(-1), cache.freq.argmin(-1),
                             noise.argmax(-1)], dim=1)              # [B, E]
    victim_pages = torch.gather(cache.tags, 1, proposals)           # [B, E]
    chosen = _ol.choose_expert(ols, hyper.policy_idx)
    victim_idx = torch.gather(proposals, 1, chosen.long()[:, None])[:, 0]

    evict = miss & ~has_free
    slot = torch.where(has_free, free_idx.long(), victim_idx)
    slot_oh = line == slot[:, None]
    writeback = evict & torch.gather(cache.dirty, 1, slot[:, None])[:, 0]

    # Prediction rings, gated by evict; the modulo follows the carried
    # ring width (cache_scan_ref truncates it).
    ring = ols.pred.shape[-1]
    col_oh = (torch.arange(ring, device=dev)
              == (ols.pred_n % ring)[:, :, None])                   # [B,E,C]
    pred_new = torch.where(col_oh, victim_pages[:, :, None], ols.pred)
    ev1 = evict[:, None]
    ols = ols._replace(
        pred=torch.where(evict[:, None, None], pred_new, ols.pred),
        pred_n=torch.where(ev1, ols.pred_n + 1, ols.pred_n),
        chosen=torch.where(evict, chosen, ols.chosen[:, 0])[:, None],
    )

    # Touched line: the hit line on a hit, the insert slot on a miss.
    touch = torch.where(miss[:, None], slot_oh, match)
    cache = cache._replace(
        tags=torch.where(touch, pg, cache.tags),
        dirty=torch.where(touch, (cache.dirty & hit[:, None])
                          | is_write[:, None], cache.dirty),
        freq=torch.where(touch, torch.where(miss[:, None], 0, cache.freq) + 1,
                         cache.freq),
        ts=torch.where(touch, t[:, None], cache.ts),
        n_valid=cache.n_valid + (miss & has_free).to(i32),
    )

    # --- 4. stream identifier + prefetch issue ----------------------------
    if prefetch:
        delta = page - pf.last_miss
        same = (delta == pf.stride) & (pf.last_miss >= 0) & (delta != 0)
        conf_o = torch.where(same, pf.conf + 1,
                             torch.where(delta != 0, 1, pf.conf))
        stride_o = torch.where(same, pf.stride,
                               torch.where(delta != 0, delta, pf.stride))
        pf = pf._replace(
            last_miss=torch.where(miss, page, pf.last_miss),
            stride=torch.where(miss, stride_o, pf.stride),
            conf=torch.where(miss, conf_o, pf.conf),
        )
        n_before = pf.issued
        active = pf.conf >= 2
        buf = torch.arange(pf.ptags.shape[-1], device=dev)
        ptags, pvalid, issued = pf.ptags, pf.pvalid, pf.issued
        # Rows that did not miss, or have no confirmed stride, issue
        # nothing: skip the candidates when no row does.
        if bool((miss & active).any()):
            for k in range(prefetch_width):
                cand = _wrap32(page.long() + (k + 1) * pf.stride.long())
                in_cache = (cache.tags == cand[:, None]).any(-1)
                in_buf2 = (pvalid & (ptags == cand[:, None])).any(-1)
                bfree = ~pvalid
                do = (active & bfree.any(-1) & ~in_cache & ~in_buf2
                      & (cand >= 0))
                slot_b = bfree.to(torch.uint8).argmax(-1)  # first free slot
                boh = (buf == slot_b[:, None]) & do[:, None]
                ptags = torch.where(boh, cand[:, None], ptags)
                pvalid = pvalid | boh
                issued = issued + do.to(i32)
        m1 = miss[:, None]
        pf = pf._replace(
            ptags=torch.where(m1, ptags, pf.ptags),
            pvalid=torch.where(m1, pvalid, pf.pvalid),
            issued=torch.where(miss, issued, pf.issued),
        )
        prefetch_fetches = torch.where(miss, pf.issued - n_before, 0)
    else:
        prefetch_fetches = torch.zeros_like(page)

    # --- 5. epoch boundary (WeightAdjust, ws rows only) ---------------------
    fire = ((t + 1) % epoch_width == 0) & (hyper.policy_idx < 0)
    if bool(fire.any()):  # skips the update's arithmetic between epochs
        ol_cfg = _ol.OLConfig(epoch_width=epoch_width, alpha=hyper.alpha,
                              beta=hyper.beta, threshold=hyper.threshold,
                              pred_cap=pred_cap)
        adj = _ol.weight_adjust(ols, ol_cfg, pw)
        ols = _ol.OLState(*(
            torch.where(fire.reshape((B,) + (1,) * (new.dim() - 1)), new,
                        old)
            for new, old in zip(adj, ols)))

    out = dict(
        hit=hit,
        miss=miss,
        prefetch_hit=promoted,
        tier2_read=(miss & ~promoted).to(i32) + prefetch_fetches,
        tier2_write=writeback.to(i32),
        evict=evict,
        chosen=torch.where(evict, chosen, -1),
    )
    return state._replace(cache=cache, ols=ols, pf=pf, t=t + 1), out


def fused_fold(acc, outs, win, weights, n_windows: int):
    """Fold the stacked ``[B, L]`` per-request outcomes into the
    accumulators ``acc`` (leading row axis). ``win == n_windows`` marks a
    pad: it counts toward the scalar totals and drops out of every window.
    ``weights`` is the ``[B, L, E]`` stack of post-step expert weights:
    each window takes the weights at its last request."""
    i32 = torch.int32
    hit = outs["hit"].to(i32)
    miss = outs["miss"].to(i32)
    pfh = outs["prefetch_hit"].to(i32)
    t2r = outs["tier2_read"].to(i32)
    t2w = outs["tier2_write"].to(i32)
    ev = outs["evict"].to(i32)
    expert = torch.where(outs["evict"], outs["chosen"], 0).long()
    B, L = hit.shape
    E = _ol.N_EXPERTS
    W = n_windows
    dev = hit.device
    # Windows [0, W) plus one drop slot for pads.
    wid = torch.where((win >= 0) & (win < W), win, W).long()        # [B, L]
    eoh = (torch.nn.functional.one_hot(expert, E).to(i32)
           * ev[:, :, None])                                        # [B,L,E]
    vals = torch.stack([torch.ones_like(hit), hit, miss, pfh, t2r, t2w, ev],
                       dim=2)                                       # [B,L,7]
    winc = torch.zeros(B, W + 1, 7, dtype=i32, device=dev).scatter_add_(
        1, wid[:, :, None].expand(B, L, 7), vals)[:, :W]            # [B,W,7]
    weu = torch.zeros(B, W + 1, E, dtype=i32, device=dev).scatter_add_(
        1, wid[:, :, None].expand(B, L, E), eoh)[:, :W]
    # Last request per window (-1 = no request this scan).
    pos = torch.full((B, W + 1), -1, dtype=torch.int64, device=dev)
    pos = pos.scatter_reduce_(
        1, wid, torch.arange(L, device=dev).expand(B, L), "amax")[:, :W]
    wsel = torch.gather(weights, 1, pos.clamp(min=0)[:, :, None]
                        .expand(B, W, E))
    return acc._replace(
        hits=acc.hits + hit.sum(1, dtype=i32),
        misses=acc.misses + miss.sum(1, dtype=i32),
        prefetch_hits=acc.prefetch_hits + pfh.sum(1, dtype=i32),
        tier2_reads=acc.tier2_reads + t2r.sum(1, dtype=i32),
        tier2_writes=acc.tier2_writes + t2w.sum(1, dtype=i32),
        evictions=acc.evictions + ev.sum(1, dtype=i32),
        expert_use=acc.expert_use + eoh.sum(1, dtype=i32),
        win_requests=acc.win_requests + winc[:, :, 0],
        win_hits=acc.win_hits + winc[:, :, 1],
        win_misses=acc.win_misses + winc[:, :, 2],
        win_prefetch_hits=acc.win_prefetch_hits + winc[:, :, 3],
        win_tier2_reads=acc.win_tier2_reads + winc[:, :, 4],
        win_tier2_writes=acc.win_tier2_writes + winc[:, :, 5],
        win_evictions=acc.win_evictions + winc[:, :, 6],
        win_expert_use=acc.win_expert_use + weu,
        win_weights=torch.where((pos >= 0)[:, :, None], wsel,
                                acc.win_weights),
    )


def _noise_chunks(keys: torch.Tensor, length: int, n_lines: int):
    """The Random expert's draws of successive steps, ``NOISE_CHUNK`` steps
    at a time: yields ``(draws [U, chunk, N], row_of [B])``, where row
    ``b`` follows the split chain of ``keys[b]`` (uint32 words in int64)
    and rows with equal keys share one of the ``U`` draw rows."""
    dev = keys.device
    uniq, row_of = torch.unique(keys.cpu(), dim=0, return_inverse=True)
    vkeys = torch.tensor([threefry.key_chain(k, length)
                          for k in uniq.tolist()],
                         dtype=torch.int64).reshape(len(uniq), length, 2)
    vkeys, row_of = vkeys.to(dev), row_of.to(dev)
    for s in range(0, length, NOISE_CHUNK):
        vk = vkeys[:, s:s + NOISE_CHUNK]
        yield threefry.uniform_f32(vk[..., 0], vk[..., 1], n_lines,
                                   device=dev), row_of


def cache_scan_ref(state0, acc0, pages, writes, win, hyper, *,
                   epoch_width: int, pred_cap: int, prefetch: bool,
                   prefetch_width: int, n_windows: int):
    """Rows of the fused cache engine, plain PyTorch: ``pages``,
    ``writes`` and ``win`` are ``[B, L]``, ``state0`` and ``acc0`` carry a
    leading row axis. Each row draws the Random expert's uniforms from its
    own ``state0.key`` chain, :data:`NOISE_CHUNK` steps at a time — the
    draws of the reference's table and of its in-loop splits alike. The
    final state's key is ``state0.key`` untouched, as in the reference's
    table mode. Returns ``(final_state, acc)``.

    The prediction ring is carried truncated to ``min(pred_cap,
    epoch_width)`` columns: under ``ws`` it is cleared every epoch and
    takes at most one eviction per step, so later columns stay ``-1``;
    under a fixed policy neither ring nor ``mispred`` is observable. The
    untouched tail columns are spliced back onto the final state."""
    c_eff = min(pred_cap, epoch_width)
    ols0, cache0 = state0.ols, state0.cache
    B, L = pages.shape
    n_lines = cache0.tags.shape[-1]
    state = state0._replace(
        ols=ols0._replace(pred=ols0.pred[:, :, :c_eff]),
        cache=_ScanCache(tags=cache0.tags, dirty=cache0.dirty,
                         freq=cache0.freq, ts=cache0.ts,
                         n_valid=cache0.valid.sum(-1, dtype=torch.int32)),
    )
    if L == 0:
        return state0, acc0
    pw = _ol.pow_table(hyper.beta, epoch_width).to(pages.device)
    pages = pages.to(torch.int32)
    writes = writes.to(torch.bool)
    draws = _noise_chunks(state0.key, L, n_lines)
    outs = {k: [] for k in ("hit", "miss", "prefetch_hit", "tier2_read",
                            "tier2_write", "evict", "chosen")}
    wts = []
    for t in range(L):
        if t % NOISE_CHUNK == 0:
            chunk, row_of = next(draws)
        nrow = chunk[row_of, t % NOISE_CHUNK]
        state, out = fused_cache_step(
            state, pages[:, t], writes[:, t], nrow, hyper,
            epoch_width=epoch_width, pred_cap=pred_cap, prefetch=prefetch,
            prefetch_width=prefetch_width, pw=pw)
        for k, v in out.items():
            outs[k].append(v)
        wts.append(state.ols.weights)
    fc = state.cache
    final = state._replace(
        ols=state.ols._replace(pred=torch.cat(
            [state.ols.pred, ols0.pred[:, :, c_eff:]], dim=2)),
        cache=type(cache0)(tags=fc.tags, valid=fc.tags >= 0, dirty=fc.dirty,
                           freq=fc.freq, ts=fc.ts),
    )
    stacked = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    return final, fused_fold(acc0, stacked, win, torch.stack(wts, dim=1),
                             n_windows)
