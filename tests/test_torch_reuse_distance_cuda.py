"""The port's sweep kernels on the card (``cuda`` marker; each test skips
where ``torch.cuda.is_available()`` is false): the CUDA reuse-distance
kernel against its plain PyTorch version, the cache-scan kernel with its
own policy and beta on every row of one launch, and ``sweep`` on the card
against ``sweep`` on the CPU. This file imports no JAX, so it runs on a
machine with a card and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_reuse_distance_cuda.py
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.traffic import TrafficSpec
from repro_torch.kernels import cache_scan as tcs
from repro_torch.kernels import reuse_distance as trd
from repro_torch.kernels.ref import DIST_INF, reuse_distance_ref
from repro_torch.sim import SimSpec, sweep
from repro_torch.storage import tiered_store as T


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,L,n_pages", [(2, 256, 40), (1, 1, 1),
                                         (3, 1000, 97), (4, 4097, 600),
                                         (16, 3001, 300), (2, 70001, 9000)])
def test_reuse_kernel_matches_plain_on_card(cuda_device, S, L, n_pages):
    """Every integer equal, at lengths that are not a multiple of the
    256-query tile, with a row of first accesses only, a row of pads only
    and ragged pads; one launch."""
    rng = np.random.default_rng(S * 7919 + L)
    pages = rng.integers(0, n_pages, (S, L)).astype(np.int32)
    counts = rng.integers(0, L + 1, S)
    counts[0] = L
    pages[0] = np.arange(L)
    if S > 2:
        counts[1] = 0
    prev, valid = trd.prev_occurrence(pages, counts)
    p = torch.as_tensor(prev, device=cuda_device)
    v = torch.as_tensor(valid, device=cuda_device)
    before = trd.reuse_compile_count()
    got = trd.reuse_distances(p, v)
    torch.cuda.synchronize()
    assert trd.reuse_compile_count() == before + 1
    want = reuse_distance_ref(p, v)
    assert torch.equal(got, want)
    assert bool((got[0] == DIST_INF).all())
    if S > 2:
        assert bool((got[1] == -1).all())


def _general_rows(rng, S, L):
    """``prev`` that no ``prev_occurrence`` call could give (any value in
    ``[-1, L + 3)``, a few across the whole int32 range) and ``valid``
    that is no prefix (pads inside the row)."""
    prev = rng.integers(-1, L + 3, (S, L)).astype(np.int64)
    far = rng.random((S, L)) < 0.05
    prev[far] = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                             int(far.sum()))
    valid = rng.random((S, L)) < 0.8
    return prev.astype(np.int32), valid


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(3, 1), (2, 2047), (3, 2048), (3, 2049),
                                 (2, 4096), (2, 4097), (5, 10000),
                                 (2, 70001)])
def test_reuse_kernel_general_inputs_on_card(cuda_device, S, L):
    """General ``prev`` / ``valid`` at lengths around the kernel's
    2,048-position tile and its merge levels; one row of only first
    accesses and one of only pads: every integer equal, one launch."""
    rng = np.random.default_rng(S * 131 + L)
    prev, valid = _general_rows(rng, S, L)
    prev[1] = -1
    valid[1] = True
    if S > 2:
        valid[2] = False
    p = torch.as_tensor(prev, device=cuda_device)
    v = torch.as_tensor(valid, device=cuda_device)
    before = trd.reuse_compile_count()
    got = trd.reuse_distances(p, v)
    torch.cuda.synchronize()
    assert trd.reuse_compile_count() == before + 1
    assert torch.equal(got, reuse_distance_ref(p, v))
    assert bool((got[1] == DIST_INF).all())
    if S > 2:
        assert bool((got[2] == -1).all())


@pytest.mark.cuda
def test_reuse_kernel_mrc_shape_on_card(cuda_device):
    """The MRC route's shape: 16 rows of 2^19, each about half pads (its
    real requests padded to the power-of-two bucket)."""
    S, L = 16, 2**19
    rng = np.random.default_rng(19)
    counts = rng.integers(L // 2 - 2000, L // 2 + 2000, S)
    pages = rng.integers(0, 2**20, (S, L)).astype(np.int32)
    prev, valid = trd.prev_occurrence(pages, counts)
    p = torch.as_tensor(prev, device=cuda_device)
    v = torch.as_tensor(valid, device=cuda_device)
    got = trd.reuse_distances(p, v)
    torch.cuda.synchronize()
    assert torch.equal(got, reuse_distance_ref(p, v, block=512))


@pytest.mark.cuda
def test_cache_scan_mixed_knobs_one_launch(cuda_device):
    """Each of 8 rows with its own policy and beta in one launch: every
    counter equal to the plain version's, the f32 weights bit for bit."""
    B, L, N, W = 8, 1500, 64, 5
    rng = np.random.default_rng(31)
    pages = rng.integers(0, 300, (B, L)).astype(np.int32)
    writes = rng.random((B, L)) < 0.3
    win = np.minimum(np.arange(L) * W // L, W - 1)
    win = np.tile(win, (B, 1)).astype(np.int32)
    win[:, -40:] = W
    policies = ["ws", "lru", "lfu", "random"] * 2
    hyper = T.StoreHyper(
        alpha=torch.full((B,), 0.4, device=cuda_device),
        beta=torch.tensor([0.5, 0.7, 0.9, 0.7, 0.9, 0.5, 0.7, 0.9],
                          device=cuda_device),
        threshold=torch.full((B,), 0.1, device=cuda_device),
        policy_idx=torch.tensor([T.POLICY_TO_IDX[p] for p in policies],
                                dtype=torch.int32, device=cuda_device))
    cfg = T.StoreConfig(n_lines=N).static_config()
    args = (cfg, hyper, tcs.cold_keys(0, B, cuda_device),
            *(torch.as_tensor(x, device=cuda_device)
              for x in (pages, writes, win)))
    before = tcs.cache_scan_launch_count()
    got = tcs.cache_scan_cuda(*args, n_windows=W)
    torch.cuda.synchronize()
    assert tcs.cache_scan_launch_count() == before + 1
    want = tcs.cache_scan_plain(*args, n_windows=W)
    for f, ref in want.items():
        out = got[f]
        if ref.dtype == torch.float32:
            out, ref = out.view(torch.int32), ref.view(torch.int32)
        assert torch.equal(out, ref), f
    assert bool((got["evictions"] > 0).all())


_BASE = SimSpec(
    traffic=TrafficSpec(kind="irm", n_requests=2000, n_pages=500,
                        write_fraction=0.0, seed=4),
    store=T.StoreConfig(n_lines=32, policy="lru"),
    n_shards=3, n_windows=4, mapping="random", lam=50.0)


def _counters(res):
    return [(r.requests, r.hits, r.misses, r.tier2_reads, r.tier2_writes,
             r.evictions, [s.hits for s in r.shards],
             r.windows.misses.tolist(), r.windows.weights.tolist())
            for r in res.reports]


@pytest.mark.cuda
@pytest.mark.parametrize("axes,launches", [
    ({"store.policy": ["ws", "lfu"], "store.beta": [0.5, 0.9],
      "lam": [40.0, 60.0]}, (1, 0)),
    ({"store.n_lines": [8, 16, 64]}, (0, 1)),
])
def test_sweep_on_card_matches_cpu(cuda_device, axes, launches):
    """A megabatch grid (one cache-scan launch) and a size grid (one
    reuse-distance launch) on the card report what the plain path reports
    on the CPU: counters exactly, the batched reports within 1e-10."""
    tcs.reset_cache_scan_launch_count()
    trd.reset_reuse_compile_count()
    on_card = sweep(_BASE, axes, device=cuda_device)
    assert (tcs.cache_scan_launch_count(),
            trd.reuse_compile_count()) == launches
    on_cpu = sweep(_BASE, axes, device="cpu")
    assert _counters(on_card) == _counters(on_cpu)
    for a, b in zip(on_card.reports, on_cpu.reports):
        np.testing.assert_allclose(a.response_s, b.response_s, rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(a.transient.w1, b.transient.w1, rtol=0,
                                   atol=1e-10)
    scalar = sweep(_BASE, axes, report="scalar", device=cuda_device)
    assert (json.loads(scalar.to_json())
            == json.loads(sweep(_BASE, axes, report="scalar",
                                device="cpu").to_json()))
