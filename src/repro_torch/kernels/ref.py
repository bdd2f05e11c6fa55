"""Plain PyTorch versions of the port's hand kernels.

- :func:`attention_ref`: GQA attention, full, causal, sliding-window or
  prefix-LM, the golden of ``csrc/flash_attention.cu``.
- :func:`paged_attention_ref`: the decode-attention partial over the
  pages of one pool reached through a page table, the golden of
  ``csrc/paged_attention.cu``.
- :func:`page_copy_ref`: ``dst[dst_idx[i]] = src[src_idx[i]]``, the
  golden of ``csrc/page_copy.cu``.
- :func:`reuse_distance_ref`: the reuse-distance (Mattson LRU stack
  distance) dominance count, the golden of ``csrc/reuse_distance.cu``.
- :func:`cache_scan_ref`: the fused tier-1 cache scan, the golden of
  ``csrc/cache_scan.cu``.
- :func:`ssd_ref`, :func:`rglru_ref`: the sequential Mamba-2 SSD and
  RG-LRU recurrences, one step at a time; the chunk-by-chunk plain
  versions that the kernels mirror live beside their wrappers
  (:mod:`repro_torch.kernels.ssd_scan`, :mod:`repro_torch.kernels.
  rglru_scan`).

Cache scan: one request step of the storage engine on a batch of shard rows, written
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

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import online_learning as _ol
from repro_torch.kernels import threefry

__all__ = ["attention_ref", "paged_attention_ref", "page_copy_ref",
           "softplus", "ssd_ref", "rglru_ref",
           "DIST_INF", "reuse_distance_ref", "fused_cache_step",
           "fused_fold", "cache_scan_ref", "NOISE_CHUNK"]

# Reuse distance of a first-ever access (compulsory miss): larger than any
# possible cache size, so `d < C` is False for every C.
DIST_INF = 2**31 - 1

# Steps per batch of Random-expert draws when no shared table is given.
NOISE_CHUNK = 256
_I32_MIN, _I32_SPAN = -(2**31), 2**32


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """Softmax attention in f32, one sequence at a time (so the ``[H, Sq,
    Skv]`` scores of one sequence are the largest temporary). q ``[B, H,
    Sq, hd]``, k/v ``[B, KV, Skv, hd]`` (any strides) -> ``[B, H, Sq,
    hd]`` in q's dtype. Without ``causal`` every key is visible; with it,
    key ``j`` is visible to query ``i`` if ``i >= j`` and ``j > i -
    window`` (window), or if ``j < prefix_len`` (a prefix-LM's
    bidirectional prefix)."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    mask = None
    if causal:
        mask = qpos >= kpos
        if window is not None:
            mask &= kpos > qpos - window
        if prefix_len:
            mask |= kpos < prefix_len
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    for b in range(B):
        qf = q[b].to(torch.float32).reshape(KV, G, Sq, hd)
        s = torch.einsum("kgqh,ksh->kgqs", qf, k[b].to(torch.float32))
        s = s / math.sqrt(hd)
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("kgqs,ksh->kgqh", p, v[b].to(torch.float32))
        out[b] = o.reshape(H, Sq, hd).to(q.dtype)
    return out


def paged_attention_ref(q: torch.Tensor, pool: torch.Tensor,
                        page_slot: torch.Tensor, lengths: torch.Tensor,
                        window: int = 0, scale=None):
    """Partial decode attention over the pages of one pool.

    q ``[B, H, hd]``; pool ``[slots, page, 2, KV, hd]`` (any slot stride,
    e.g. one layer of a ``[slots, Lp, page, 2, KV, hd]`` pool);
    ``page_slot [B, n_pages]`` int32 (``-1``, or a slot past the pool =
    skip the page); ``lengths [B]`` int32: token ``t`` is live if ``t <
    lengths[b]`` and, with a ``window`` > 0, ``t >= lengths[b] - window``.
    An int8 pool comes with ``scale [slots, page, 2]`` f32, one scale a
    (token, k/v), and reads as the reference's ``bf16(f32(q) * sc)``.
    Returns f32 ``(acc [B, H, hd], m [B, H], l [B, H])``; a row with no
    live token has ``m = -1e30``, ``l = 0``, ``acc = 0``."""
    B, H, hd = q.shape
    n_pages = page_slot.shape[1]
    slots, page, KV = pool.shape[0], pool.shape[1], pool.shape[3]
    G = H // KV
    ps = page_slot.to(pool.device).long()
    on = (ps >= 0) & (ps < slots)
    at = torch.where(on, ps, 0)
    data = pool[at]                          # [B, n_pages, page, 2, KV, hd]
    if scale is not None:
        data = (data.to(torch.float32) * scale[at][..., None, None]).to(
            torch.bfloat16)
    k = data[..., 0, :, :].reshape(B, n_pages * page, KV, hd)
    v = data[..., 1, :, :].reshape(B, n_pages * page, KV, hd)
    tok = torch.arange(n_pages * page, device=pool.device)
    valid = on.repeat_interleave(page, dim=1)
    n = lengths.to(pool.device)[:, None]
    valid &= tok[None, :] < n
    if window > 0:
        valid &= tok[None, :] >= n - window
    qf = q.to(torch.float32).reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qf, k.to(torch.float32))
    s = s / math.sqrt(hd)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, -1e30))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.to(torch.float32))
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``max(x, 0) + log1p(exp(-|x|))``, the form
    of ``jax.nn.softplus``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def ssd_ref(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Sequential SSD scan, one step at a time in f32: ``h_t = exp(dt_t
    A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t . h_t``. x ``[B, S, H, P]``,
    dt ``[B, S, H]``, A ``[H]``, Bm/Cm ``[B, S, N]``; returns y ``[B, S,
    H, P]`` f32."""
    f = torch.float32
    Bsz, S, H, P = x.shape
    xf, dtf, Af = x.to(f), dt.to(f), A.to(f)
    Bf, Cf = Bm.to(f), Cm.to(f)
    h = torch.zeros((Bsz, H, Bm.shape[-1], P), dtype=f, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                       # [B, H]
        h = h * decay[..., None, None] + torch.einsum(
            "bn,bhp->bhnp", Bf[:, t], dtf[:, t, :, None] * xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1)


def rglru_ref(u, w_a, b_a, w_x, b_x, lam) -> torch.Tensor:
    """Sequential RG-LRU recurrence in f32: ``h_t = a_t h_{t-1} + b_t``
    with ``r, i = sigmoid(u w + b)``, ``log a = -8 softplus(lam) r``, ``b
    = sqrt(max(1 - a^2, 1e-12)) i u``. u ``[B, S, W]`` -> h ``[B, S, W]``
    f32."""
    f = torch.float32
    uf = u.to(f)
    r = torch.sigmoid(uf * w_a.to(f) + b_a.to(f))
    i = torch.sigmoid(uf * w_x.to(f) + b_x.to(f))
    log_a = -8.0 * softplus(lam.to(f)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i * uf)
    h = torch.zeros_like(uf[:, 0])
    hs = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def page_copy_ref(dst: torch.Tensor, src: torch.Tensor,
                  dst_idx: torch.Tensor, src_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Tier movement in place: ``dst[dst_idx[i]] = src[src_idx[i]]`` for
    each pair where neither index is ``-1``, in pair order. ``dst`` and
    ``src`` may be row-strided views (one layer of a pool); returns
    ``dst``."""
    for di, si in zip(dst_idx.tolist(), src_idx.tolist()):
        if di >= 0 and si >= 0:
            dst[di] = src[si]
    return dst


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around (the reference's
    int32 arithmetic)."""
    return ((x - _I32_MIN) % _I32_SPAN + _I32_MIN).to(torch.int32)


def reuse_distance_ref(prev: torch.Tensor, valid: torch.Tensor, *,
                       block: int = 128) -> torch.Tensor:
    """LRU stack (Mattson reuse) distance per request, on ``prev``'s
    device.

    For request ``j`` of row ``s`` with previous same-page occurrence
    ``i = prev[s, j]``, the reuse distance is the number of *distinct*
    pages touched strictly between the two accesses — counted as the
    positions ``k`` in ``(i, j)`` whose own previous occurrence lies at or
    before ``i`` (``prev[s, k] <= i``), i.e. the first in-gap occurrence of
    each distinct page; pads (``valid`` False) never count. First-ever
    accesses return :data:`DIST_INF`, padding returns ``-1``; distances
    never cross rows. Returns int32 ``[S, L]``.

    The O(L^2) dominance count is blocked over ``block`` queries at a time
    on every row at once: a ``[S, block, j0 + block]`` compare against the
    keys before the block's end (keys at or past a query never count).
    """
    prev = torch.as_tensor(prev).to(torch.int32)
    valid = torch.as_tensor(valid, device=prev.device).to(torch.bool)
    S, L = prev.shape
    out = torch.empty((S, L), dtype=torch.int32, device=prev.device)
    kidx = torch.arange(L, dtype=torch.int32, device=prev.device)
    for j0 in range(0, L, block):
        j1 = min(j0 + block, L)
        pj = prev[:, j0:j1, None]                          # [S, b, 1]
        m = ((kidx[:j1] > pj)
             & (kidx[:j1] < kidx[j0:j1, None])
             & (prev[:, None, :j1] <= pj)
             & valid[:, None, :j1])
        d = m.sum(-1, dtype=torch.int32)
        d = torch.where(pj[..., 0] >= 0, d, DIST_INF)
        out[:, j0:j1] = torch.where(valid[:, j0:j1], d, -1)
    return out


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


def _noise_step(n_rows: int, n_lines: int) -> int:
    """Steps per batch of masked-mode draws: :data:`NOISE_CHUNK`, fewer
    where a ``[n_rows, steps, n_lines]`` batch would pass 2^24 draws."""
    return max(1, min(NOISE_CHUNK, (1 << 24) // max(n_rows * n_lines, 1)))


def _masked_draw_keys(keys: torch.Tensor, real: torch.Tensor):
    """The masked mode's key chains: row ``b`` splits its key once per
    real request (``real[b]`` True), in order, so position ``t`` draws
    with the split of its rank among the row's real requests (a pad takes
    the next one's and discards it). Returns ``(draw keys [B, L, 2] int64
    on the host, advanced keys [B, 2])``."""
    B, L = real.shape
    n_real = real.sum(1).tolist()
    chains, finals = zip(*(threefry.split_chain(k, n) for k, n in
                           zip(keys.cpu().tolist(), n_real)))
    vkeys = torch.zeros(B, max(max(n_real), 1), 2, dtype=torch.int64)
    for b, chain in enumerate(chains):
        if chain:
            vkeys[b, :len(chain)] = torch.tensor(chain, dtype=torch.int64)
    rank = (real.cumsum(1) - real.to(torch.int64)).cpu()
    rank = rank.clamp(max=vkeys.shape[1] - 1)
    per_pos = torch.gather(vkeys, 1, rank[:, :, None].expand(B, L, 2))
    return per_pos, torch.tensor(finals, dtype=torch.int64)


def _select(keep_new: torch.Tensor, new, old):
    """``new`` where ``keep_new[b]``, else ``old``, leaf by leaf over a
    state pytree with a leading row axis."""
    if isinstance(new, torch.Tensor):
        return torch.where(
            keep_new.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    return type(new)(*(_select(keep_new, n, o) for n, o in zip(new, old)))


def cache_scan_ref(state0, acc0, pages, writes, win, hyper, *,
                   epoch_width: int, pred_cap: int, prefetch: bool,
                   prefetch_width: int, n_windows: int,
                   masked: bool = False):
    """Rows of the fused cache engine, plain PyTorch: ``pages``,
    ``writes`` and ``win`` are ``[B, L]``, ``state0`` and ``acc0`` carry a
    leading row axis and may hold any state. Returns ``(final_state,
    acc)``, ``acc`` being ``acc0`` plus this run's counters.

    One-shot mode (``masked=False``): every position is a step. Each row
    draws the Random expert's uniforms from its own ``state0.key`` chain,
    :data:`NOISE_CHUNK` steps at a time — the draws of the reference's
    table. The final state's key is ``state0.key`` untouched, as in the
    reference's table mode.

    Masked mode (``masked=True``, the resumable chunk engine's): a
    position with ``win >= n_windows`` is a pad and leaves the state
    untouched — cache lines, learner, prediction ring, prefetcher, ``t``
    and key — and adds 0 to every counter. Each real request splits the
    row's carried key once, in order (the reference's in-loop splits), and
    the final state carries the advanced key. A window the run does not
    touch keeps its incoming ``win_weights``.

    The prediction ring is carried truncated to ``min(pred_cap,
    epoch_width)`` columns: under ``ws`` it is cleared every epoch and
    takes at most one eviction per step, so later columns stay ``-1``;
    under a fixed policy neither ring nor ``mispred`` is observable. The
    untouched tail columns are spliced back onto the final state."""
    c_eff = min(pred_cap, epoch_width)
    ols0, cache0 = state0.ols, state0.cache
    B, L = pages.shape
    n_lines = cache0.tags.shape[-1]
    dev = pages.device
    state = state0._replace(
        ols=ols0._replace(pred=ols0.pred[:, :, :c_eff]),
        cache=_ScanCache(tags=cache0.tags, dirty=cache0.dirty,
                         freq=cache0.freq, ts=cache0.ts,
                         n_valid=cache0.valid.sum(-1, dtype=torch.int32)),
    )
    if masked:
        # A position that is a pad on every row changes nothing and counts
        # nothing: drop it (the chunk buffers' tails are mostly such).
        keep = (win < n_windows).any(0)
        if not bool(keep.all()):
            pages, writes, win = pages[:, keep], writes[:, keep], win[:, keep]
            L = pages.shape[1]
    if L == 0:
        return state0, acc0
    pw = _ol.pow_table(hyper.beta, epoch_width).to(dev)
    pages = pages.to(torch.int32)
    writes = writes.to(torch.bool)
    if masked:
        real = win < n_windows
        vkeys, key_end = _masked_draw_keys(state0.key, real)
        step, s = _noise_step(B, n_lines), -1
    else:
        draws = _noise_chunks(state0.key, L, n_lines)
        step = NOISE_CHUNK
    outs = {k: [] for k in ("hit", "miss", "prefetch_hit", "tier2_read",
                            "tier2_write", "evict", "chosen")}
    wts = []
    for t in range(L):
        if masked:
            if t - t % step != s:
                s = t - t % step
                vk = vkeys[:, s:s + step].to(dev)
                chunk = threefry.uniform_f32(vk[..., 0], vk[..., 1],
                                             n_lines, device=dev)
            nrow = chunk[:, t - s]
        else:
            if t % step == 0:
                chunk, row_of = next(draws)
            nrow = chunk[row_of, t % step]
        new, out = fused_cache_step(
            state, pages[:, t], writes[:, t], nrow, hyper,
            epoch_width=epoch_width, pred_cap=pred_cap, prefetch=prefetch,
            prefetch_width=prefetch_width, pw=pw)
        if masked:
            ok = real[:, t]
            new = _select(ok, new, state)
            out = {k: (v if k == "chosen" else v & ok if v.dtype == torch.bool
                       else torch.where(ok, v, 0)) for k, v in out.items()}
        state = new
        for k, v in out.items():
            outs[k].append(v)
        wts.append(state.ols.weights)
    if masked:
        state = state._replace(key=key_end.to(dev))
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
