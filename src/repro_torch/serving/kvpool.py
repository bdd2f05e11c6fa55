"""Paged two-tier KV cache: the paper's tier-1 / tier-2 store on one card.

- **cache line / page**: ``page_size`` consecutive tokens of one sequence's
  KV across every attention layer; the unit of residency and of tier
  movement.
- **tier 1**: a fixed pool of page slots on the card (``pool1``). Its
  states (tags / valid / dirty / freq / ts) mirror §III and live apart
  from the data, on the host, as the paper keeps its cache states in CPU
  RAM and its data on NVMe: the allocation, eviction and learner logic
  runs in host tensors once a step, and only its plan reaches the card.
- **tier 2**: the full backing pool (``pool2``), a second array on the
  card. The cache is *inclusive* and *write-back*: dirty tier-1 pages are
  copied down on eviction.
- **OL eviction**: :mod:`repro_torch.core.online_learning` runs over the
  page metadata exactly as in the reference: every eviction records all
  experts' proposals, a tier-2 read of a recently evicted page is a
  misprediction, the weights adjust every epoch.

Pool layout and slot rules are the reference's (``[slots + 1, layers,
page, 2, KV, hd]`` for tier 1, with its scratch row; ``[t2_slots, ...]``
for tier 2, the last row its scratch). The pools are updated in place
(the reference returns new arrays). All tier movement goes through the
page-copy kernel (:mod:`repro_torch.kernels.page_gather`), and masked
writes skip (``-1``) where the reference scatters them to the scratch rows;
so the scratch rows stay zero here.

In int8 mode (``KVSpec.dtype == "int8"``) each token's K and each its V
are quantized with one f32 scale apiece, as the reference does:
``sc = max(max |x|, 1e-30) / 127`` over ``(KV, hd)`` and ``q =
clip(round(x / sc), -127, 127)``; the scales live in two f32 pools
beside the data, ``scale1 [hbm_slots + 1, layers, page, 2]`` and
``scale2 [t2_slots, ...]``, and move with their pages in every copy.
A read dequantizes to ``bf16(f32(q) * sc)``. Outside int8 mode the scale
pools are ``[1]`` placeholders. Functions that move data take ``pools``
as ``(pool1, pool2)``, or ``(pool1, pool2, scale1, scale2)`` in int8
mode (:func:`pools_of`).

Page shards. Under a mesh the pages are spread over the ranks of the
page-shard axes by :func:`repro_torch.core.mapping.page_to_shard`
(block, cyclic, random or round-robin; ``KVSpec.n_shards`` and
``mapping``), and each rank is a page shard ``me``: it keeps tier 1 and
tier 2 for the pages it owns and runs its own learner. Its tier-2 slot
table (:func:`t2_slot_table`) numbers the owned pages in flat-id order
and holds -1 for the others; every data path here skips a page whose
slot is -1 (it reads as no page at all), the page table never gives an
unowned page a tier-1 slot, and only the rank that owns a sequence's
current page writes its token (``AllocPlan.write_here``). The PRNG key
is split once per sequence and step on every shard, whether it owns the
page or not, as the reference splits it. On one card (``n_shards`` = 1)
the card owns every page and a page's tier-2 slot is its flat id.

With a read window (``read_pages`` > 0, for sliding-window attention)
only the pages ``[lo, lo + read_pages)`` of a sequence are read,
touched, counted as misses and promoted, ``lo`` being
:func:`read_window_start`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import online_learning as ol
from repro_torch.core.mapping import page_to_shard
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels import threefry
from repro_torch.kernels import page_gather as pg
from repro_torch.storage.cache_state import CacheState, init_cache

__all__ = ["KVSpec", "PagedKV", "AllocPlan", "init_paged_kv", "alloc_step",
           "write_back_evicted", "token_index", "write_token_kv", "read_pages",
           "prefill_residency", "prefill_index", "prefill_write",
           "promote_pages",
           "read_window_start", "n_attn_layers", "pools_of", "quantize",
           "t2_slot_table"]

_I32 = torch.int32


def n_attn_layers(cfg: ModelConfig) -> tuple[int, ...]:
    """Indices of attention positions within the block pattern."""
    return tuple(
        i for i, k in enumerate(cfg.block_pattern) if k.startswith("attn"))


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Static geometry of the paged pool (per page shard)."""

    b_local: int           # sequences
    n_pages: int           # pages per sequence (max_seq / page_size)
    page_size: int
    n_kv: int
    head_dim: int
    layers_per_slot: int   # attention layers stored per page (stacked dim)
    hbm_slots: int         # tier-1 capacity (pages)
    t2_slots: int          # tier-2 capacity (>= owned pages)
    n_shards: int = 1      # page-shard group size (product of page axes)
    mapping: str = "block_cyclic"
    read_pages: int = 0    # pages visible to decode attention (0 = all)
    window: int = 0        # sliding-window size in tokens (0 = full)
    dtype: str = "bfloat16"  # "int8" => per-(token, k/v) scaled quantization

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def total_pages(self) -> int:
        return self.b_local * self.n_pages

    def owner(self, flat_id) -> torch.Tensor:
        """The page shard that owns each flat page id (int32)."""
        return torch.as_tensor(page_to_shard(
            torch.as_tensor(flat_id).numpy(), self.n_shards,
            self.total_pages, self.mapping))


def t2_slot_table(spec: KVSpec, me: int) -> torch.Tensor:
    """int32 ``[B, n_pages]``: each owned page's tier-2 slot (the owned
    pages numbered in flat-id order), -1 for the pages shard ``me`` does
    not own."""
    mine = spec.owner(torch.arange(spec.total_pages, dtype=_I32)) == me
    rank = torch.cumsum(mine.to(_I32), 0, dtype=_I32) - 1
    return torch.where(mine, rank, -1).to(_I32).reshape(
        spec.b_local, spec.n_pages)


class PagedKV(NamedTuple):
    """Paged KV state: the pools on the card, the rest on the host."""

    pool1: torch.Tensor      # [hbm_slots + 1, Lp, page, 2, KV, hd]
    pool2: torch.Tensor      # [t2_slots, Lp, page, 2, KV, hd]
    scale1: torch.Tensor     # [hbm_slots + 1, Lp, page, 2] f32 (int8; or [1])
    scale2: torch.Tensor     # [t2_slots, Lp, page, 2] f32
    meta: CacheState         # over hbm_slots; tags = flat page id
    page_slot: torch.Tensor  # int32 [B, n_pages] tier-1 slot or -1
    t2_slot: torch.Tensor    # int32 [B, n_pages] tier-2 slot
    ols: ol.OLState
    lengths: torch.Tensor    # int32 [B] tokens present
    t: torch.Tensor          # int32 [1] step counter
    key: tuple               # PRNG key of the Random expert: 2 uint32 words
    t2_reads: torch.Tensor   # int32 [1] pages read from tier 2
    t1_reads: torch.Tensor   # int32 [1] pages read from tier 1
    # Counters the reference does not keep:
    evictions: torch.Tensor  # int32 [1] tier-1 pages evicted
    writebacks: torch.Tensor  # int32 [1] dirty evicted pages copied down


class AllocPlan(NamedTuple):
    cur_slot: torch.Tensor    # [B] tier-1 slot of each current page
    evict_slot: torch.Tensor  # [B] slot evicted to make room (-1 = none)
    evict_t2: torch.Tensor    # [B] tier-2 slot of the evicted page
    writeback: torch.Tensor   # [B] bool — evicted page dirty?
    write_here: torch.Tensor  # [B] bool — this shard owns the current page


def init_paged_kv(spec: KVSpec, seed: int = 0, *, device=None,
                  me: int = 0) -> PagedKV:
    """Empty pools on ``device`` (``None`` = the card), the scales at 1;
    metadata on the host, with page shard ``me``'s tier-2 slot table."""
    device = resolve_device(device)
    dt = getattr(torch, spec.dtype)
    shape1 = (spec.hbm_slots + 1, spec.layers_per_slot, spec.page_size, 2,
              spec.n_kv, spec.head_dim)
    shape2 = (spec.t2_slots,) + shape1[1:]
    f32 = dict(dtype=torch.float32, device=device)
    sc1, sc2 = ((shape1[:4], shape2[:4]) if spec.quantized
                else ((1,), (1,)))
    return PagedKV(
        pool1=torch.zeros(shape1, dtype=dt, device=device),
        pool2=torch.zeros(shape2, dtype=dt, device=device),
        scale1=torch.ones(sc1, **f32),
        scale2=torch.ones(sc2, **f32),
        meta=init_cache(spec.hbm_slots),
        page_slot=torch.full((spec.b_local, spec.n_pages), -1, dtype=_I32),
        t2_slot=t2_slot_table(spec, me),
        ols=ol.init_ol(ol.OLConfig()),
        lengths=torch.zeros(spec.b_local, dtype=_I32),
        t=torch.zeros(1, dtype=_I32),
        key=threefry.prng_key(seed),
        t2_reads=torch.zeros(1, dtype=_I32),
        t1_reads=torch.zeros(1, dtype=_I32),
        evictions=torch.zeros(1, dtype=_I32),
        writebacks=torch.zeros(1, dtype=_I32),
    )


def pools_of(kv: PagedKV, spec: KVSpec) -> tuple:
    """The pools that move data: ``(pool1, pool2)``, with ``(scale1,
    scale2)`` after them in int8 mode."""
    if spec.quantized:
        return kv.pool1, kv.pool2, kv.scale1, kv.scale2
    return kv.pool1, kv.pool2


def quantize(x: torch.Tensor) -> tuple:
    """The reference's int8 quantization over the last two axes ``(KV,
    hd)``: ``(codes int8, scales f32 [...])``, the scale ``max(amax,
    1e-30) / 127`` as a division, the code ``round(x / sc)`` (half to
    even) clipped to ``[-127, 127]``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    sc = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / sc[..., None, None]), -127, 127)
    return q.to(torch.int8), sc


def read_window_start(lengths: torch.Tensor, spec: KVSpec) -> torch.Tensor:
    """The first page decode reads: ``read_pages - 1`` pages before the
    current one (0 without a read window)."""
    if spec.read_pages <= 0:
        return torch.zeros_like(lengths)
    first = lengths // spec.page_size - (spec.read_pages - 1)
    return torch.clamp(first, min=0)


def _readable(kv: PagedKV, spec: KVSpec) -> torch.Tensor:
    """Owned pages holding tokens before the current one, inside the read
    window."""
    p_range = torch.arange(spec.n_pages)[None, :]
    lo = read_window_start(kv.lengths, spec)
    return ((p_range * spec.page_size < kv.lengths[:, None])
            & (p_range >= lo[:, None]) & (kv.t2_slot >= 0))


# ---------------------------------------------------------------------------
# Metadata phase: allocation + OL eviction decisions, once per decode step,
# on the host.
# ---------------------------------------------------------------------------


def alloc_step(kv: PagedKV, spec: KVSpec, cfg_ol: ol.OLConfig,
               pw: torch.Tensor, me: int = 0) -> tuple[PagedKV, AllocPlan]:
    """Allocate tier-1 slots for each sequence's current page that page
    shard ``me`` owns; evict via the OL policy when full; update LRU/LFU
    metadata and the OL learner. ``pw`` is the learner's ``pow_table`` (as
    wide as the most mispredictions an epoch can count)."""
    B, NP, P = spec.b_local, spec.n_pages, spec.page_size
    page_idx = (kv.lengths // P).tolist()
    flat = kv.lengths // P + torch.arange(B, dtype=_I32) * NP
    mine = spec.owner(flat) == me
    boundary = ((kv.lengths % P == 0) & mine).tolist()
    t = int(kv.t[0])

    tags, valid, dirty, freq, ts = (x.clone() for x in kv.meta)
    page_slot = kv.page_slot.clone()
    ols, key = kv.ols, kv.key
    cur_slot = torch.zeros(B, dtype=_I32)
    evict_slot = torch.full((B,), -1, dtype=_I32)
    evict_t2 = torch.full((B,), -1, dtype=_I32)
    writeback = torch.zeros(B, dtype=torch.bool)
    # Every sequence's current page is pinned (single writer: in-flight
    # lines are not eviction candidates).
    pinned = torch.isin(tags, flat) & valid

    for b in range(B):
        pi = page_idx[b]
        do_alloc = boundary[b] and int(page_slot[b, pi]) < 0
        key, vkey = threefry.split(key)
        free = ~valid
        has_free = bool(free.any())
        slot = int(free.to(torch.uint8).argmax())
        if do_alloc and not has_free:  # evict
            meta = CacheState(tags, valid, dirty, freq, ts)
            proposals = ol.propose_victims(meta, vkey, pinned)
            ols = ol.record_predictions(ols, cfg_ol, tags[proposals.long()])
            slot = int(proposals[int(ol.choose_expert(ols))])
            v_b, v_p = divmod(int(tags[slot]), NP)
            page_slot[v_b, v_p] = -1
            evict_slot[b] = slot
            evict_t2[b] = kv.t2_slot[v_b, v_p]
            writeback[b] = dirty[slot]
        if do_alloc:
            tags[slot], valid[slot], dirty[slot] = int(flat[b]), True, True
            freq[slot], ts[slot] = 1, t
            page_slot[b, pi] = slot
            pinned[slot] = True
        cur_slot[b] = page_slot[b, pi]

    # The current page receives this step's token KV (write-back cache:
    # mark it dirty so eviction copies it down to tier 2).
    dirty[cur_slot[(cur_slot >= 0) & mine].long()] = True

    # Touch the resident owned pages read this step (LRU ts / LFU freq);
    # count tier-2 reads of owned pages as misses for the learner.
    readable = _readable(kv, spec)
    resident = page_slot >= 0
    read_res = readable & resident
    read_miss = readable & ~resident
    slot_hit = torch.zeros(spec.hbm_slots, dtype=torch.bool)
    slot_hit[page_slot.clamp(0, spec.hbm_slots - 1)[read_res].long()] = True
    freq = freq + slot_hit.to(_I32)
    ts = torch.where(slot_hit, torch.full_like(ts, t), ts)
    n_miss = int(read_miss.sum())
    miss_pages = (torch.arange(NP)[None, :]
                  + torch.arange(B)[:, None] * NP)[read_miss]
    hit_pred = (ols.pred[None] == miss_pages[:, None, None].to(_I32)).any(
        -1).sum(0, dtype=_I32)
    ols = ols._replace(mispred=ols.mispred + hit_pred,
                       epoch_misses=ols.epoch_misses + n_miss)
    if (t + 1) % cfg_ol.epoch_width == 0:
        ols = ol.weight_adjust(ols, cfg_ol, pw)

    kv = kv._replace(
        meta=CacheState(tags, valid, dirty, freq, ts), ols=ols, key=key,
        page_slot=page_slot, t2_reads=kv.t2_reads + n_miss,
        t1_reads=kv.t1_reads + int(read_res.sum()),
        evictions=kv.evictions + int((evict_slot >= 0).sum()),
        writebacks=kv.writebacks + int(writeback.sum()))
    plan = AllocPlan(cur_slot=cur_slot, evict_slot=evict_slot,
                     evict_t2=evict_t2, writeback=writeback, write_here=mine)
    return kv, plan


# ---------------------------------------------------------------------------
# Data phase on the card.
# ---------------------------------------------------------------------------


def write_back_evicted(pools, plan: AllocPlan) -> bool:
    """Copy every dirty evicted page down to tier 2, whole slots (all
    layers) at once, in one page-copy launch (and one more for the slots'
    scales in int8 mode); returns whether it launched.

    The reference writes back layer by layer inside the layer loop, each
    layer before that layer's token lands. One copy before the loop moves
    the same bytes: ``alloc_step`` pins each freshly allocated slot, so no
    sequence writes this step's token into a slot another sequence evicts.
    """
    live = plan.writeback & (plan.evict_slot >= 0)
    if not bool(live.any()):
        return False
    for lo, up in zip(pools[0::2], pools[1::2]):  # data, then scales
        pg.page_copy(up, lo, plan.evict_t2[live], plan.evict_slot[live])
    return True


def token_index(plan: AllocPlan, lengths: torch.Tensor, spec: KVSpec,
                device) -> tuple:
    """Where this step's tokens land, on ``device``, once a step: each
    sequence's current tier-1 slot (clipped at 0, as the reference does)
    and the offset in its page, then the rows this shard writes (None
    where it writes every row: it owns every current page)."""
    rows = None
    if not bool(plan.write_here.all()):
        rows = torch.nonzero(plan.write_here)[:, 0]
    slot = plan.cur_slot.clamp(min=0)
    off = lengths % spec.page_size
    if rows is not None:
        slot, off = slot[rows], off[rows]
        rows = to_device(rows, device)
    return tuple(to_device(x.long(), device) for x in (slot, off)) + (rows,)


def write_token_kv(pool1: torch.Tensor, kv_new, index: tuple,
                   li: int, scale1=None) -> None:
    """Write this step's K/V of layer ``li`` (``k_new``, ``v_new``: [B, KV,
    hd]) into the current tier-1 pages at ``index`` (:func:`token_index`),
    in place, for the rows this shard writes; with ``scale1`` (int8 mode)
    quantized, each token's K and V scale beside it."""
    slot, off, rows = index
    new = torch.stack(kv_new, dim=1)                   # [B, 2, KV, hd]
    if rows is not None:
        new = new[rows]
    if scale1 is None:
        pool1[:, li][slot, off] = new.to(pool1.dtype)
        return
    q, sc = quantize(new)
    pool1[:, li][slot, off] = q
    scale1[:, li][slot, off] = sc


def read_pages(pools, kv: PagedKV, spec: KVSpec, li: int):
    """Gather the readable KV of layer ``li`` (the reference's single-pass
    read): ``(k, v, valid)``, ``[B, R * page, KV, hd]`` over the ``R``
    pages from :func:`read_window_start` (``read_pages``, or every page
    without a read window) with the mask of live tokens of owned pages: at
    or before the current one, and inside the sliding window where there
    is one — resident pages from tier 1, the others from their tier-2
    home (a page this shard does not own is masked, as the reference's
    ``owned = t2 >= 0``). The
    decode step reads the two tiers with the paged-attention kernel
    instead; this is the plain read the tests hold it against.

    A window that runs past the last page masks the pages past it; the
    reference clips their indices to the last page instead, which reads
    that page more than once (ROADMAP faults item (h)).

    In int8 mode (four pools) K and V come out dequantized as the
    reference's are, ``bf16(f32(q) * sc)``."""
    pool1, pool2 = pools[:2]
    B, NP, P = spec.b_local, spec.n_pages, spec.page_size
    R = spec.read_pages if spec.read_pages > 0 else NP
    dev = pool1.device
    lengths = kv.lengths.to(dev)
    p_idx = read_window_start(lengths, spec)[:, None] + torch.arange(
        R, device=dev)[None, :]                                # [B, R]
    inside = p_idx < NP
    p_idx = p_idx.clamp(max=NP - 1).long()
    slot = torch.gather(kv.page_slot.to(dev), 1, p_idx).long()
    t2 = torch.gather(kv.t2_slot.to(dev), 1, p_idx).long()
    owned = t2 >= 0
    t2 = t2.clamp(min=0)
    res = slot >= 0
    data = torch.where(res[..., None, None, None, None],
                       pool1[slot.clamp(min=0), li], pool2[t2, li])
    if len(pools) == 4:
        scale1, scale2 = pools[2:]
        sc = torch.where(res[..., None, None], scale1[slot.clamp(min=0), li],
                         scale2[t2, li])
        data = (data.to(torch.float32) * sc[..., None, None]).to(
            torch.bfloat16)
    k = data[..., 0, :, :].reshape(B, R * P, spec.n_kv, spec.head_dim)
    v = data[..., 1, :, :].reshape(B, R * P, spec.n_kv, spec.head_dim)
    tok = p_idx[..., None] * P + torch.arange(P, device=dev)  # [B, R, P]
    valid = (tok <= lengths[:, None, None]) & (inside & owned)[..., None]
    if spec.window > 0:
        valid &= tok > lengths[:, None, None] - spec.window
    return k, v, valid.reshape(B, R * P)


# ---------------------------------------------------------------------------
# Prefill: residency init + bulk page writes.
# ---------------------------------------------------------------------------


def prefill_residency(kv: PagedKV, spec: KVSpec,
                      prompt_len: torch.Tensor) -> PagedKV:
    """Tier-1 residency after a prefill of ``prompt_len`` tokens: the most
    recent owned pages become resident, older ones live only in tier 2.
    Sets meta / page_slot / lengths (the pools are filled per layer by
    :func:`prefill_write`, which writes the owned pages alone)."""
    B, NP = spec.b_local, spec.n_pages
    p_range = torch.arange(NP)[None, :]
    prompt_len = prompt_len.to(_I32).cpu()
    in_prompt = p_range * spec.page_size < prompt_len[:, None]
    cand = (in_prompt & (kv.t2_slot >= 0)).reshape(-1)
    key = (p_range * B + torch.arange(B)[:, None]).reshape(-1)
    big = torch.iinfo(_I32).max
    sort_key = torch.where(cand, -key, torch.full_like(key, big))
    order = torch.argsort(sort_key, stable=True)
    n_res = min(spec.hbm_slots, B * NP)
    chosen = order[:n_res]
    is_cand = cand[chosen]
    slots = torch.arange(n_res, dtype=_I32)
    page_slot = torch.full((B * NP,), -1, dtype=_I32)
    page_slot[chosen] = torch.where(is_cand, slots, -1).to(_I32)
    flat_ids = chosen.to(_I32)
    H = spec.hbm_slots
    tags = torch.full((H,), -1, dtype=_I32)
    tags[:n_res] = torch.where(is_cand, flat_ids, -1).to(_I32)
    valid = torch.zeros(H, dtype=torch.bool)
    valid[:n_res] = is_cand
    freq = torch.zeros(H, dtype=_I32)
    freq[:n_res] = is_cand.to(_I32)
    ts = torch.zeros(H, dtype=_I32)
    ts[:n_res] = torch.where(is_cand, flat_ids % NP, 0).to(_I32)
    meta = CacheState(tags=tags, valid=valid,
                      dirty=torch.zeros(H, dtype=torch.bool),  # clean
                      freq=freq, ts=ts)
    return kv._replace(meta=meta, page_slot=page_slot.reshape(B, NP),
                       lengths=prompt_len, t=torch.zeros(1, dtype=_I32))


def prefill_index(kv: PagedKV, npg: int, device=None) -> tuple:
    """The index vectors of every layer's :func:`prefill_write` of ``npg``
    pages a sequence: the pages in order, their tier-2 slots and their
    tier-1 slots (-1 where not resident). With a card ``device`` they are
    moved there once a prefill, in one copy without a host synchronization
    (``page_gather.card_index``); else they stay on the host."""
    idx = (torch.arange(kv.t2_slot.shape[0] * npg, dtype=_I32),
           kv.t2_slot[:, :npg].reshape(-1), kv.page_slot[:, :npg].reshape(-1))
    return idx if device is None else pg.card_index(device, *idx)


def prefill_write(pools, kv: PagedKV, spec: KVSpec, li: int,
                  k: torch.Tensor, v: torch.Tensor, index=None) -> None:
    """Write one layer's prefill KV (``[B, S, KV, hd]``, S a page multiple)
    into both pools with two page-copy launches: every owned page into
    tier 2, the resident ones into tier 1 too (an unowned page's slots are
    -1, so the copy skips it). In int8 mode the pages are
    quantized first and their scales copied alike (two launches more).
    ``index`` is :func:`prefill_index`'s, built once a prefill (by default
    it is built here, on the host)."""
    B, S = k.shape[:2]
    npg = S // spec.page_size
    data = torch.stack([k, v], dim=2).reshape(
        B * npg, spec.page_size, 2, spec.n_kv, spec.head_dim)
    if len(pools) == 4:
        srcs = quantize(data)
    else:
        srcs = (data.to(pools[0].dtype),)
    src, t2, t1 = prefill_index(kv, npg) if index is None else index
    for (lo, up), x in zip(zip(pools[0::2], pools[1::2]), srcs):
        pg.page_copy(up[:, li], x, t2, src)
        pg.page_copy(lo[:, li], x, t1, src)


# ---------------------------------------------------------------------------
# IO-thread analog: promotion of hot tier-2 pages between decode steps.
# ---------------------------------------------------------------------------


def promote_pages(kv: PagedKV, spec: KVSpec, n_promote: int = 2) -> PagedKV:
    """Promote up to ``n_promote`` readable-but-nonresident owned pages into
    free tier-1 slots ("prefetching is performed only if there are empty
    slots"): the choice on the host, the copies of whole slots in one
    page-copy launch (and one more for their scales in int8 mode)."""
    cand = (_readable(kv, spec) & (kv.page_slot < 0)).reshape(-1)
    tags, valid, dirty, freq, ts = (x.clone() for x in kv.meta)
    page_slot = kv.page_slot.clone().reshape(-1)
    t = int(kv.t[0])
    dst, src = [], []
    for _ in range(n_promote):
        free = ~valid
        slot = int(free.to(torch.uint8).argmax())
        nxt = int((cand & (page_slot < 0)).to(torch.uint8).argmax())
        if not (bool(free.any()) and bool(cand[nxt])
                and int(page_slot[nxt]) < 0):
            continue
        b, p = divmod(nxt, spec.n_pages)
        dst.append(slot)
        src.append(int(kv.t2_slot[b, p]))
        tags[slot], valid[slot], dirty[slot] = nxt, True, False
        freq[slot], ts[slot] = 1, t
        page_slot[nxt] = slot
    if dst:
        di, si = (torch.tensor(x, dtype=_I32) for x in (dst, src))
        pools = pools_of(kv, spec)
        for lo, up in zip(pools[0::2], pools[1::2]):
            pg.page_copy(lo, up, di, si)
    return kv._replace(meta=CacheState(tags, valid, dirty, freq, ts),
                       page_slot=page_slot.reshape(kv.page_slot.shape))
