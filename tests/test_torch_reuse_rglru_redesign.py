"""The redesigned reuse-distance and RG-LRU kernels' algorithms, emulated
on the CPU step by step.

**Reuse distance** (``csrc/reuse_distance.cu``). Per row, with ``P =
prev`` and ``V = valid``, the kernel counts

    F_j  = #{ k < j : V[k], P[k] <= P[j] }
    G(x) = #{ k : V[k], max(k, P[k]) <= x }
    d_j  = F_j - G(P[j])   (0 <= P[j] < j; 0 where P[j] >= j)

``G`` from a histogram of ``max(k, P[k])``, scanned inside tiles of 2,048
positions and across them; ``F`` from a merge sort of the row by the
64-bit key ``(P[k] with its sign bit flipped, or 2^32 at a pad) << 31 |
k``: the first 11 levels inside each tile (a tile's unused slots hold
fill keys above every pad), the rest as merges whose 2,048-element output
tiles find their inputs by a merge-path search. Each element of a right
run adds the number of left-run elements below it. ``_emulate_reuse``
runs those stages with the kernel's own searches and tile sizes, cut at
each row's extent (one past its last valid position). It is held equal,
integer for integer, to ``reuse_distance_ref`` and to the JAX package's
``reuse_distance_kernel(..., interpret=True)``, on rows of lengths 1,
2,047, 2,048, 2,049 and 70,001: ``prev_occurrence`` streams with pad
tails, and general ``prev`` / ``valid`` that no ``prev_occurrence`` call
could give (``P`` in ``[-1, L + 3)`` or anywhere in int32, pads inside the
row), rows of only first accesses and of only pads.

**RG-LRU** (``csrc/rglru_scan.cu``). A block takes a chunk of ``T`` steps
of 64 channels, ``T / 16`` warps of 16 steps each. Each warp composes its
steps into ``(prod a, h from 0)``; the chunk's aggregate composes its
warps; the carry into chunk ``c`` comes from a look-back that finds the
nearest chunk ``k`` whose inclusive ``h`` is published and applies the
aggregates of chunks ``k + 1 .. c - 1`` to it in order, which gives the
chained inclusive ``h`` whatever ``k`` is; each warp runs its steps from
the chunk's carry taken through the warps before it. ``_emulate_rglru``
does that in f32 (each multiply and add rounded apart, as the kernel's
``--fmad=false`` build), with a random look-back depth per chunk, for
several ``T`` (beyond ``S``, and not dividing ``S``). Bars: f32 within
1e-5 of ``rglru_ref`` of both packages; rounded to bf16, element by
element within one bf16 step (``|diff| <= 2^-7 |want| + 1e-6``, the bar of
``tests/test_torch_scan_kernels_cuda.py``).

No card: the kernels themselves are held against their plain versions on
the card (``tests/test_torch_reuse_distance_cuda.py``,
``tests/test_torch_scan_kernels_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.reuse_distance import reuse_distance_kernel
from repro_torch.kernels import reuse_distance as trd
from repro_torch.kernels import rglru_scan as trs
from repro_torch.kernels.ref import DIST_INF, reuse_distance_ref, rglru_ref

# The reuse kernel's constants (csrc/reuse_distance.cu).
TILE = 2048
POS_BITS = 31
PAD_KEY = 1 << 32
FILL_KEY = PAD_KEY + 1
POS_MASK = (1 << POS_BITS) - 1
# The RG-LRU kernel's steps a warp.
KSUB = 16


def _keys(P, V, k):
    """The sort key of each position (``make_key``)."""
    hi = np.where(V, (P.astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000,
                  PAD_KEY).astype(np.uint64)
    return (hi << np.uint64(POS_BITS)) | k.astype(np.uint64)


def _tile_sort(keys, counts):
    """``tile_sort_kernel``'s 11 levels on every tile at once: ``keys``
    uint64 ``[n_tiles, TILE]``. Each element finds its place by the
    kernel's branchless search over the other run (runs are full, of
    length ``r``); a right-run element adds that place to its count."""
    n_t = keys.shape[0]
    i = np.arange(TILE)
    rows = np.arange(n_t)[:, None]
    r = 1
    while r < TILE:
        start = i & ~(2 * r - 1)
        right = (i & r) != 0
        other = start + np.where(right, 0, r)
        lb = np.zeros((n_t, TILE), np.int64)
        half = r >> 1
        while half > 0:
            probe = np.take_along_axis(keys, other + lb + half - 1, axis=1)
            lb += np.where(probe < keys, half, 0)
            half >>= 1
        lb += np.take_along_axis(keys, other + lb, axis=1) < keys
        dst = start + (i & (r - 1)) + lb
        assert (np.sort(dst, axis=1) == i).all()   # a permutation
        nk, nc = np.empty_like(keys), np.empty_like(counts)
        nk[rows, dst] = keys
        nc[rows, dst] = counts + np.where(right, lb, 0)
        keys, counts = nk, nc
        r <<= 1
    return keys, counts


def _merge_split(A, B, d):
    """``merge_split``: how many of A's elements are among the first
    ``d`` of the merge."""
    lo, hi = max(0, d - len(B)), min(d, len(A))
    while lo < hi:
        mid = (lo + hi) >> 1
        if A[mid] < B[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_level(keys, counts, n, r):
    """``merge_level_kernel`` over one row cut at its extent ``n``: each
    output tile of TILE elements merges the two input segments that its
    merge-path splits give."""
    out_k, out_c = keys.copy(), counts.copy()
    for g0 in range(0, n, TILE):
        start = g0 & ~(2 * r - 1)
        a = min(r, n - start)
        b = max(0, min(r, n - start - r))
        A, cA = keys[start:start + a], counts[start:start + a]
        B, cB = keys[start + r:start + r + b], counts[start + r:start + r + b]
        d0 = g0 - start
        d1 = min(d0 + TILE, a + b)
        i0, i1 = _merge_split(A, B, d0), _merge_split(A, B, d1)
        sa, ca = A[i0:i1], cA[i0:i1]
        sb, cb = B[d0 - i0:d1 - i1], cB[d0 - i0:d1 - i1]
        m = len(sa) + len(sb)
        assert m == d1 - d0
        ra = np.arange(len(sa)) + np.searchsorted(sb, sa, side="left")
        lb = np.searchsorted(sa, sb, side="left")
        rb = np.arange(len(sb)) + lb
        seg_k = np.empty(m, np.uint64)
        seg_c = np.empty(m, np.int64)
        seg_k[ra], seg_c[ra] = sa, ca
        seg_k[rb], seg_c[rb] = sb, cb + i0 + lb
        out_k[g0:g0 + m], out_c[g0:g0 + m] = seg_k, seg_c
    return out_k, out_c


def _emulate_reuse(prev, valid):
    """The kernel's five stages on ``[S, L]`` numpy rows."""
    S, L = prev.shape
    n_tiles = -(-L // TILE)
    out = np.empty((S, L), np.int64)
    for s in range(S):
        P, V = prev[s].astype(np.int64), valid[s].astype(bool)
        k = np.arange(L)
        # extent_hist: the extent and the histogram of max(k, P[k]).
        n = int(np.flatnonzero(V)[-1]) + 1 if V.any() else 0
        m = np.maximum(k, P)[V]
        hist = np.bincount(m[m < L], minlength=L)[:L].astype(np.int64)
        # tile_sort: the histogram scanned inside each tile below n ...
        tile_sum = np.zeros(n_tiles, np.int64)
        for t in range(n_tiles):
            base = t * TILE
            if base < n:
                seg = np.cumsum(hist[base:base + TILE])
                hist[base:base + len(seg)] = seg
                tile_sum[t] = seg[-1]
        # ... and each tile's keys sorted, with fill keys past n.
        nt = -(-n // TILE)
        fill = (np.uint64(FILL_KEY) << np.uint64(POS_BITS)) | np.arange(
            TILE, dtype=np.uint64)
        tk = np.tile(fill, (nt, 1))
        for t in range(nt):
            base = t * TILE
            cnt = min(TILE, n - base)
            tk[t, :cnt] = _keys(P[base:base + cnt], V[base:base + cnt],
                                k[base:base + cnt])
        tk, tc = _tile_sort(tk, np.zeros((nt, TILE), np.int64))
        keys = np.zeros(L, np.uint64)
        counts = np.zeros(L, np.int64)
        for t in range(nt):
            base = t * TILE
            cnt = min(TILE, n - base)
            assert (tk[t, cnt:] >> np.uint64(POS_BITS) == FILL_KEY).all()
            keys[base:base + cnt], counts[base:base + cnt] = (tk[t, :cnt],
                                                              tc[t, :cnt])
        # tile_prefix: the exclusive prefix of the tiles' totals.
        tile_pre = np.concatenate([[0], np.cumsum(tile_sum)[:-1]])
        # merge_level, while a run is shorter than the row.
        r = TILE
        while r < L:
            keys, counts = _merge_level(keys, counts, n, r)
            r *= 2
        assert (keys[:n][1:] > keys[:n][:-1]).all()
        # finish: d from the sorted keys, scattered back to j.
        key = keys[:n]
        j = (key & np.uint64(POS_MASK)).astype(np.int64)
        hi = key >> np.uint64(POS_BITS)
        pad = hi >= PAD_KEY
        p = ((hi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
             ^ np.uint32(0x80000000)).view(np.int32).astype(np.int64)
        pc = np.clip(p, 0, L - 1)
        g = hist[pc] + tile_pre[pc // TILE]
        d = np.where(pad, -1, np.where(
            p < 0, DIST_INF, np.where(p >= j, 0, counts[:n] - g)))
        row = np.full(L, -1, np.int64)
        row[j] = d
        out[s] = row
    return out.astype(np.int32)


def _direct(prev, valid):
    """The definition, counted directly in numpy (small rows only)."""
    S, L = prev.shape
    out = np.full((S, L), -1, np.int64)
    for s in range(S):
        P, V = prev[s].astype(np.int64), valid[s]
        for j in range(L):
            if V[j]:
                if P[j] < 0:
                    out[s, j] = DIST_INF
                else:
                    k = np.arange(max(P[j] + 1, 0), j)
                    out[s, j] = int(((P[k] <= P[j]) & V[k]).sum())
    return out.astype(np.int32)


def _rows(kind, S, L, seed):
    """``(prev, valid)`` int32 / bool ``[S, L]`` of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "stream":      # prev_occurrence of ragged shard rows
        counts = rng.integers(0, L + 1, S)
        counts[0] = L
        pages = rng.integers(0, max(2, L // 8), (S, L)).astype(np.int32)
        return trd.prev_occurrence(pages, counts)
    if kind == "general":     # any prev in [-1, L + 3), pads anywhere
        prev = rng.integers(-1, L + 3, (S, L)).astype(np.int32)
        valid = rng.random((S, L)) < 0.8
        valid[0, -1] = True   # a row whose extent is the whole row
        return prev, valid
    if kind == "extremes":    # prev anywhere in int32
        prev = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                            (S, L), dtype=np.int64)
        near = rng.random((S, L)) < 0.7
        prev[near] = rng.integers(-3, L, int(near.sum()))
        prev[:, :3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, 0]
        return prev.astype(np.int32), rng.random((S, L)) < 0.9
    if kind == "firsts":      # only first accesses
        return np.full((S, L), -1, np.int32), np.ones((S, L), bool)
    if kind == "pads":        # only pads
        return rng.integers(-1, L, (S, L)).astype(np.int32), np.zeros(
            (S, L), bool)
    raise ValueError(kind)


def _references(prev, valid):
    L = prev.shape[1]
    want = reuse_distance_ref(torch.as_tensor(prev), torch.as_tensor(valid),
                              block=1024 if L > 4096 else 128).numpy()
    pallas = np.asarray(reuse_distance_kernel(
        prev, valid, block=1024 if L > 4096 else 128, interpret=True))
    return want, pallas


@pytest.mark.parametrize("L", [1, 2047, 2048, 2049, 70001])
@pytest.mark.parametrize("kind", ["stream", "general"])
def test_reuse_emulation_matches_references(kind, L):
    S = 1 if L > 4096 else 3
    prev, valid = _rows(kind, S, L, seed=L + len(kind))
    got = _emulate_reuse(prev, valid)
    want, pallas = _references(prev, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("kind", ["extremes", "firsts", "pads"])
@pytest.mark.parametrize("L", [2049, 5000])
def test_reuse_emulation_special_rows(kind, L):
    """Keys across the whole int32 range (the sign-bit flip), rows of only
    first accesses (all DIST_INF) and of only pads (all -1, no tile
    sorted)."""
    prev, valid = _rows(kind, 2, L, seed=L)
    got = _emulate_reuse(prev, valid)
    want, pallas = _references(prev, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    if kind == "firsts":
        assert (got == DIST_INF).all()
    if kind == "pads":
        assert (got == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_reuse_count_identity(seed):
    """``F - G`` against the definition counted directly, on short
    general rows (tile and merge levels aside)."""
    rng = np.random.default_rng(seed)
    L = 40
    prev = rng.integers(-2, L + 3, (3, L)).astype(np.int32)
    valid = rng.random((3, L)) < 0.75
    want = _direct(prev, valid)
    k = np.arange(L)
    for s in range(3):
        P, V = prev[s].astype(np.int64), valid[s]
        F = np.array([((P[:j] <= P[j]) & V[:j]).sum() for j in range(L)])
        G = np.array([(V & (np.maximum(k, P) <= x)).sum() for x in range(L)])
        ok = V & (P >= 0)
        d = np.where(P >= k, 0, F - G[np.clip(P, 0, L - 1)])
        np.testing.assert_array_equal(d[ok], want[s][ok])
    np.testing.assert_array_equal(_emulate_reuse(prev, valid), want)


def _emulate_rglru(u, ps, chunk, rng):
    """The kernel's chunked scan in f32: ``h [B, S, W]``."""
    a, b = trs.rglru_gates(u, *ps)          # the kernel's gate arithmetic
    B, S, W = a.shape
    warps = chunk // KSUB
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S              # identity steps past S
    a = torch.cat([a, torch.ones(B, pad, W)], 1)
    b = torch.cat([b, torch.zeros(B, pad, W)], 1)
    a = a.reshape(B, n_chunks, warps, KSUB, W)
    b = b.reshape(B, n_chunks, warps, KSUB, W)
    # Each warp's steps composed: (prod a, h from 0).
    A = torch.ones(B, n_chunks, warps, W)
    H = torch.zeros(B, n_chunks, warps, W)
    for s in range(KSUB):
        H = a[..., s, :] * H + b[..., s, :]
        A = a[..., s, :] * A
    # The chunk's aggregate: its warps composed in order.
    BA = torch.ones(B, n_chunks, W)
    BH = torch.zeros(B, n_chunks, W)
    for w in range(warps):
        BH = A[:, :, w] * BH + H[:, :, w]
        BA = A[:, :, w] * BA
    # The look-back: from the inclusive h of a chunk k found at a random
    # depth, the aggregates of k + 1 .. c - 1 applied in order.
    incl = torch.zeros(B, n_chunks, W)
    carry = torch.zeros(B, n_chunks, W)
    for c in range(n_chunks):
        if c > 0:
            k = int(rng.integers(0, c))
            h = incl[:, k]
            for i in range(k + 1, c):
                h = BA[:, i] * h + BH[:, i]
            chained = incl[:, c - 1]
            assert torch.equal(h, chained)   # the depth does not matter
            carry[:, c] = h
        incl[:, c] = BA[:, c] * carry[:, c] + BH[:, c]
    # Each warp from the chunk's carry through the warps before it.
    out = torch.empty(B, n_chunks, warps, KSUB, W)
    h = carry
    for w in range(warps):
        hw = h
        for s in range(KSUB):
            hw = a[:, :, w, s] * hw + b[:, :, w, s]
            out[:, :, w, s] = hw
        h = A[:, :, w] * h + H[:, :, w]
    return out.reshape(B, n_chunks * chunk, W)[:, :S]


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("B,S,W", [(2, 1, 8), (2, 50, 24), (3, 200, 40),
                                   (1, 700, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_emulation_matches_references(B, S, W, chunk, dtype):
    rng = np.random.default_rng(B * 1000 + S + W)
    u = torch.as_tensor(rng.normal(size=(B, S, W)), dtype=torch.float32
                        ).to(dtype)
    ps = [torch.as_tensor(rng.normal(size=W) * 0.5, dtype=torch.float32
                          ).to(dtype) for _ in range(5)]
    got = _emulate_rglru(u, ps, chunk, rng)
    want = rglru_ref(u, *ps)
    jwant = torch.as_tensor(np.asarray(jref.rglru_ref(
        *(np.asarray(x.float()) for x in (u, *ps)))))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        torch.testing.assert_close(got, jwant, atol=1e-5, rtol=0)
    else:
        g = got.to(dtype).float()
        for w in (want, jwant):
            w = w.to(dtype).float()
            assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-6).all())
