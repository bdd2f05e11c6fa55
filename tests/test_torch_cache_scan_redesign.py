"""The redesigned cache-scan kernel's algorithm, emulated on the CPU.

``csrc/cache_scan.cu`` looks up the pages of the next ``K`` requests in
one block-wide pass against the tags of the filled lines, then one warp
walks the ``K`` steps in order, correcting each looked-up line with what
the walk changed since the pass: a miss that fills a slot points the later
requests of the same page in the window at that slot, and a looked-up line
is a hit only if it still holds the page. Where a row is a cluster of
``C`` blocks, each block draws the Random expert's uniforms for its share
of the lines and the packed ``(~u, line)`` minima are merged. Window
counters accumulate over a run of steps in one window.

This file holds a plain model of that walk (numpy and Python scalars,
the learner's f32 arithmetic spelled as the kernel spells it) and holds it
against ``cache_scan_ref``: the hit line of every step, every counter and
the f32 weights bit for bit, for K in {1, 7, 64}, N in {64, 2500}, every
policy x prefetch, on phase 3's four rows (``chip_smoke.py:_rows``), a
strided row that turns the prefetcher on and a row that repeats pages
within and across windows of K. No card and no JAX: the kernel itself is
held against the plain version on the card
(``tests/test_torch_cache_scan_cuda.py``, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import online_learning as _ol
from repro_torch.core.traffic import TrafficSpec, make_stream
from repro_torch.kernels import cache_scan as tcs
from repro_torch.kernels import ref as kref
from repro_torch.kernels import threefry
from repro_torch.storage import tiered_store as T

M32 = 0xFFFFFFFF
F32 = np.float32
THIRD = F32(1) / F32(3)
W = 8  # windows, as phase 3
SEED = 9  # phase 3's keys: cold_keys(9, B)


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _rows(L: int):
    """Phase 3's four rows (``chip_smoke.py:_rows``) at length ``L``, a row
    of random pages with a strided stretch (the prefetcher confirms the
    stride and issues), and a row that repeats a page 1-70 requests later
    three times in ten (repeats inside and across windows of 7 and 64)."""
    specs = [TrafficSpec(kind="irm", n_requests=L, n_pages=4096,
                         write_fraction=0.3, seed=1),
             TrafficSpec(kind="mixed", n_requests=L, n_pages=2048,
                         write_fraction=0.3, seed=2),
             TrafficSpec(kind="strided", n_requests=L, n_pages=8192,
                         stride=3, n_streams=2, write_fraction=0.3, seed=3),
             TrafficSpec(kind="irm", n_requests=L, n_pages=1024,
                         write_fraction=0.5, seed=4)]
    pages, writes = map(list, zip(*(make_stream(s) for s in specs)))
    rng = np.random.default_rng(5)
    strided = rng.integers(0, 4 * L, L)
    m = L // 3
    strided[L // 3: L // 3 + m] = 500 + 3 * np.arange(m)
    repeat = rng.integers(0, 4 * L, L)
    for i in range(1, L):
        if rng.random() < 0.3:
            repeat[i] = repeat[max(0, i - int(rng.integers(1, 71)))]
    for p in (strided, repeat):
        pages.append(p.astype(np.int32))
        writes.append(rng.random(L) < 0.3)
    win = np.tile(T.stream_window_ids(L, W), (len(pages), 1))
    win[:, L - 96:] = W  # trailing pads drop out of every window
    win[5, 100:140] = W  # and a stretch of pads inside a window
    return np.stack(pages), np.stack(writes), win


def _fma(a, b, c) -> F32:
    """``a * b + c`` for f32 values, rounded once to f32, as
    ``__fmaf_rn``: the f64 product is exact, the f64 sum's error comes
    from Knuth's two-sum, and it decides a sum that lies exactly halfway
    between two f32 values (``online_learning.fma_f32``'s method)."""
    p = float(a) * float(b)
    s = p + float(c)
    bv = s - p
    err = (p - (s - bv)) + (float(c) - bv)
    r = F32(s)
    diff = s - float(r)
    up, dn = np.nextafter(r, F32(np.inf)), np.nextafter(r, F32(-np.inf))
    if diff > 0 and 2 * diff == float(up) - float(r) and err > 0:
        return up
    if diff < 0 and -2 * diff == float(r) - float(dn) and err < 0:
        return dn
    return r


def _choose(w) -> int:
    s = (w[0] + w[1]) + w[2]
    p = [x / s if s > 0 else THIRD for x in w]
    c = 0
    if p[1] > p[c]:
        c = 1
    if p[2] > p[c]:
        c = 2
    return c


def _weight_adjust(w, mispred, em, pw, alpha, th, ew):
    """WeightAdjust in f32 as the kernel spells it."""
    thr_em = F32(th) * F32(em)
    pe, d = [], []
    for e in range(3):
        loss = mispred[e] if F32(mispred[e]) >= thr_em else 0
        pe.append(pw[min(max(loss, 0), ew)])
        d.append(_fma(-w[e], pe[e], w[e]))
    lost = (d[0] + d[1]) + d[2]
    gain = (F32(alpha) * THIRD) * lost
    wn = [max(_fma(w[e], pe[e], gain), F32(1e-8)) for e in range(3)]
    s = (wn[0] + wn[1]) + wn[2]
    return [wn[e] / s for e in range(3)]


def _packed_draws(vk0, vk1, n_lines: int) -> np.ndarray:
    """The kernel's packed Random-expert keys ``(~u) << 32 | line`` of
    each step's draw key (``vk0``/``vk1``: int64 ``[T]``): uint64 ``[T,
    n_lines]``; an unsigned minimum is the first-index argmax of the
    uniforms."""
    lines = torch.arange(n_lines, dtype=torch.int64)
    b0, b1 = threefry.threefry2x32(vk0[:, None], vk1[:, None], 0, lines)
    u = ((b0 ^ b1) >> 9).numpy().astype(np.uint64)
    return ((np.uint64(M32) - u) << np.uint64(32)) | lines.numpy().astype(
        np.uint64)


def _split_min(packed: np.ndarray, clusters: int) -> np.ndarray:
    """Each of ``clusters`` blocks takes the minimum of its share of the
    lines (as the kernel splits them), and the shares' minima merge by a
    minimum: the line, per row of ``packed``."""
    n = packed.shape[-1]
    parts = [packed[..., r * n // clusters:(r + 1) * n // clusters]
             .min(-1) for r in range(clusters)]
    return (np.minimum.reduce(parts) & np.uint64(M32)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _row_draws(n_lines: int, length: int) -> np.ndarray:
    """The packed draws of every step of a row keyed by
    ``cold_keys(SEED)``: uint64 ``[length, n_lines]``."""
    vk = torch.tensor(threefry.key_chain(threefry.prng_key(SEED), length),
                      dtype=torch.int64)
    return np.concatenate([
        _packed_draws(vk[s:s + 256, 0], vk[s:s + 256, 1], n_lines)
        for s in range(0, length, 256)])


@functools.lru_cache(maxsize=None)
def _random_victims(n_lines: int, length: int, clusters: int) -> np.ndarray:
    """The Random expert's line at every step of such a row, drawn in
    ``clusters`` shares and merged."""
    return _split_min(_row_draws(n_lines, length), clusters)


@pytest.fixture(autouse=True)
def _one_thread():
    """The reference and the model run thousands of small steps, which
    torch's thread pool only slows down (most of all beside other test
    processes): one thread for these tests, restored after each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(pages, writes, win, cfg, policy: str, K: int, clusters: int):
    """One row through the kernel's walk. Returns ``(hit line per step,
    counters as cache_scan_plain names them, for this row)``."""
    N, L = cfg.n_lines, len(pages)
    ew = cfg.epoch_width
    ring = min(cfg.pred_cap, ew)
    pbuf, pwidth = cfg.prefetch_buf, cfg.prefetch_width
    pidx = T.POLICY_TO_IDX[policy]
    ws = pidx < 0
    fixed = -1 if ws else min(pidx, 2)
    need = [ws or fixed == e for e in range(3)]
    pw = [F32(x) for x in _ol.pow_table(cfg.beta, ew)[0].tolist()]
    tags = np.full(N, -1, np.int64)
    ts = np.zeros(N, np.int64)
    freq = np.zeros(N, np.int64)
    dirty = np.zeros(N, bool)
    pred = [[-1] * ring for _ in range(3)]
    predn, mispred = [0, 0, 0], [0, 0, 0]
    em = nvalid = 0
    w = [THIRD] * 3
    chosen_ws = _choose(w)
    last_miss, stride, conf, issued = -1, 0, 0, 0
    ptags = [-1] * pbuf
    pvalid = [False] * pbuf
    tot = dict(hits=0, misses=0, prefetch_hits=0, tier2_reads=0,
               tier2_writes=0, evictions=0)
    eu = [0, 0, 0]
    winc = np.zeros((7, W), np.int64)
    weu = np.zeros((W, 3), np.int64)
    ww = np.zeros((W, 3), np.float32)
    run_wi, run, run_eu = -1, [0] * 7, [0, 0, 0]
    hit_lines = []
    victims = _random_victims(N, L, clusters) if need[2] else None

    def flush():
        if run_wi >= 0:
            winc[:, run_wi] += run
            weu[run_wi] += run_eu
            ww[run_wi] = w

    for t0 in range(0, L, K):
        kw = min(K, L - t0)
        # The pass: each filled line's tag against the window's pages.
        eq = np.c_[tags[None, :nvalid] == pages[t0:t0 + kw, None],
                   np.ones((kw, 1), bool)]  # a last column: no line
        looked = np.where(eq.argmax(1) < nvalid, eq.argmax(1), -1).tolist()
        for k in range(kw):
            t = t0 + k
            page, is_w, wi = int(pages[t]), bool(writes[t]), int(win[t])
            h = looked[k]
            miss = not (h >= 0 and tags[h] == page)
            evict = miss and nvalid == N
            hit_lines.append(-1 if miss else h)
            promoted = wb = False
            pf_fetches = 0
            chosen = chosen_ws if ws else fixed
            if wi != run_wi:
                flush()
                run_wi, run, run_eu = -1, [0] * 7, [0, 0, 0]
            if miss:
                for e in range(3):
                    mispred[e] += int(page in pred[e])
                em += 1
                if cfg.prefetch:
                    for b in range(pbuf):
                        if pvalid[b] and ptags[b] == page:
                            promoted = True
                            pvalid[b] = False
                if not evict:
                    slot = nvalid
                    nvalid += 1
                else:
                    prop = [int(np.argmin(ts)) if need[0] else None,
                            int(np.argmin(freq)) if need[1] else None,
                            None]
                    if need[2]:
                        prop[2] = int(victims[t])
                    slot = prop[chosen]
                    wb = bool(dirty[slot])
                    for e in range(3):
                        pred[e][predn[e] % ring] = (
                            int(tags[prop[e]]) if prop[e] is not None else -1)
                        predn[e] += 1
                tags[slot], dirty[slot] = page, is_w
                freq[slot], ts[slot] = 1, t
                for j in range(k + 1, kw):  # later requests of this page
                    if pages[t0 + j] == page:
                        looked[j] = slot
            else:
                dirty[h] |= is_w
                freq[h] += 1
                ts[h] = t
            if cfg.prefetch and miss:
                delta = _wrap32(page - last_miss)
                same = delta == stride and last_miss >= 0 and delta != 0
                conf_o = conf + 1 if same else (1 if delta != 0 else conf)
                stride_o = stride if same else (delta if delta != 0
                                                else stride)
                last_miss, stride, conf = page, stride_o, conf_o
                if conf >= 2:
                    n_before = issued
                    for c in range(pwidth):
                        cand = _wrap32(page + (c + 1) * stride)
                        in_buf = any(pvalid[b] and ptags[b] == cand
                                     for b in range(pbuf))
                        free = [b for b in range(pbuf) if not pvalid[b]]
                        if free and not in_buf and cand >= 0 \
                                and not (tags[:nvalid] == cand).any():
                            ptags[free[0]], pvalid[free[0]] = cand, True
                            issued += 1
                    pf_fetches = issued - n_before
            if ws and (t + 1) % ew == 0:
                w = _weight_adjust(w, mispred, em, pw, cfg.alpha,
                                   cfg.threshold, ew)
                predn, mispred, em = [0, 0, 0], [0, 0, 0], 0
                pred = [[-1] * ring for _ in range(3)]
                chosen_ws = _choose(w)
            outs = [1, int(not miss), int(miss), int(promoted),
                    int(miss and not promoted) + pf_fetches, int(wb),
                    int(evict)]
            for name, v in zip(tot, outs[1:]):
                tot[name] += v
            if evict:
                eu[chosen] += 1
            if 0 <= wi < W:
                run_wi = wi
                run = [a + b for a, b in zip(run, outs)]
                if evict:
                    run_eu[chosen] += 1
    flush()
    names = ("requests", "hits", "misses", "prefetch_hits", "tier2_reads",
             "tier2_writes", "evictions")
    out = dict(tot, expert_use=np.array(eu),
               win_expert_use=weu, win_weights=ww,
               final_weights=np.array(w, np.float32))
    for i, name in enumerate(names):
        out["win_" + name] = winc[i]
    return np.array(hit_lines), out


def _reference(cfg, pages, writes, win, monkeypatch):
    """``cache_scan_plain`` on the rows, and the line each step hit (-1 on
    a miss), taken from the state each step of ``cache_scan_ref`` sees."""
    seen = []
    step = kref.fused_cache_step

    def recording(state, page, *a, **kw):
        match = state.cache.tags == page.to(torch.int32)[:, None]
        seen.append(torch.where(match.any(-1),
                                match.to(torch.int32).argmax(-1), -1))
        return step(state, page, *a, **kw)
    monkeypatch.setattr(kref, "fused_cache_step", recording)
    B = pages.shape[0]
    out = tcs.cache_scan_plain(
        cfg, tcs.per_row(cfg.hyper(), B, "cpu"), tcs.cold_keys(SEED, B),
        torch.as_tensor(pages), torch.as_tensor(writes),
        torch.as_tensor(win), n_windows=W)
    monkeypatch.setattr(kref, "fused_cache_step", step)
    return torch.stack(seen, 1).numpy(), out


# (K, cluster size) pairs the model runs: every K with a cluster size
# whose shares are uneven at both N.
WALKS = [(1, 1), (7, 3), (64, 8)]
LENGTHS = {64: 1200, 2500: 4000}


@pytest.mark.parametrize("n_lines", [64, 2500])
@pytest.mark.parametrize("policy", ["ws", "lru", "lfu", "random"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_lookahead_walk_equals_reference(n_lines, policy, prefetch,
                                         monkeypatch):
    L = LENGTHS[n_lines]
    pages, writes, win = _rows(L)
    cfg = T.StoreConfig(n_lines=n_lines, policy=policy, prefetch=prefetch)
    want_hits, want = _reference(cfg, pages, writes, win, monkeypatch)
    evicted = 0
    for K, clusters in WALKS:
        for b in range(pages.shape[0]):
            hits, got = _walk(pages[b], writes[b], win[b], cfg, policy, K,
                              clusters)
            ctx = f"K={K} C={clusters} row {b}"
            np.testing.assert_array_equal(hits, want_hits[b], err_msg=ctx)
            assert set(got) == set(want), ctx
            for f, ref in want.items():
                x, y = np.asarray(got[f]), ref[b].numpy()
                if y.dtype == np.float32:
                    x, y = x.astype(np.float32).view(np.int32), \
                        y.view(np.int32)
                np.testing.assert_array_equal(x, y, err_msg=f"{ctx} {f}")
            evicted += int(got["evictions"] > 0)
    assert evicted >= 2 * len(WALKS)  # rows that evict, at every K
    if prefetch:
        assert int(want["prefetch_hits"][4]) > 0  # the strided row


@pytest.mark.parametrize("n_lines", [64, 2500, 16384])
def test_random_split_over_line_ranges_is_first_index_argmax(n_lines):
    """Any number of shares gives the first-index argmax of the plain
    version's uniforms, ties included."""
    vk = torch.tensor(threefry.key_chain(threefry.prng_key(3), 6),
                      dtype=torch.int64)
    want = threefry.uniform_f32(vk[:, 0], vk[:, 1], n_lines).argmax(-1)
    packed = _packed_draws(vk[:, 0], vk[:, 1], n_lines)
    for clusters in (1, 2, 3, 5, 8):
        np.testing.assert_array_equal(_split_min(packed, clusters),
                                      want.numpy(), err_msg=str(clusters))


def test_block_threads():
    """The block has the walker's and the key chain's warps beside at
    least one worker warp, at most 512 threads (128 registers a thread)."""
    assert tcs.cache_scan_threads(1) == 96
    assert tcs.cache_scan_threads(64) == 128
    assert tcs.cache_scan_threads(448) == 512
    assert tcs.cache_scan_threads(2500) == 512
    assert tcs.cache_scan_threads(16384) == 512
