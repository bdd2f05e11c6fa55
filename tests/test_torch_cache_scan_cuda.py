"""The CUDA cache-scan kernel against its plain PyTorch version on the
card (``cuda`` marker; each test skips where ``torch.cuda.is_available()``
is false). This file imports no JAX, so it runs on a machine with a card
and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_cache_scan_cuda.py

Both layouts of the per-line state are held against the plain version:
shared memory at 16,384 lines (every policy x prefetch, rows that fill
and evict, pages repeated across the look-ahead's windows) and device
scratch past shared memory's capacity; a row's cluster of 8 blocks gives
what one block gives, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_scan as tcs
from repro_torch.storage import tiered_store as T

POLICIES = ["ws", "lru", "lfu", "random"]


def _rows(B, L, n_pages, seed):
    """Random pages with a strided stretch per row (the prefetcher
    issues), 30% writes."""
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, n_pages, (B, L)).astype(np.int32)
    m = min(120, L - L // 3)
    pages[:, L // 3: L // 3 + m] = 500 + 3 * np.arange(m)
    return pages, rng.random((B, L)) < 0.3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cache-scan kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _check_kernel_against_plain(device, policy, prefetch, *, B, L, N, W,
                                n_pages, seed):
    pages, writes = _rows(B, L, n_pages, seed)
    pages = torch.tensor(pages, device=device)
    writes = torch.tensor(writes, device=device)
    win = torch.tensor(np.random.default_rng(seed + 1)
                       .integers(0, W + 1, (B, L)),
                       dtype=torch.int32, device=device)
    cfg = T.StoreConfig(n_lines=N, policy=policy, prefetch=prefetch)
    hyper = tcs.per_row(cfg.hyper(), B, device)
    keys = tcs.cold_keys(3, B, device)
    want = tcs.cache_scan_plain(cfg, hyper, keys, pages, writes, win,
                                n_windows=W)
    before = tcs.cache_scan_launch_count()
    got = tcs.cache_scan_cuda(cfg, hyper, keys, pages, writes, win,
                              n_windows=W)
    torch.cuda.synchronize()
    assert tcs.cache_scan_launch_count() == before + 1
    assert set(got) == set(want)
    for f, ref in want.items():
        out = got[f]
        if ref.dtype == torch.float32:
            out, ref = out.view(torch.int32), ref.view(torch.int32)
        assert torch.equal(out, ref), f"{policy}/pf={prefetch} field={f}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["ws", "lru", "lfu", "random"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, policy, prefetch):
    """The CUDA kernel against the plain version on the same CUDA tensors:
    every counter equal, the f32 weights bit for bit."""
    _check_kernel_against_plain(cuda_device, policy, prefetch, B=3, L=700,
                                N=64, W=5, n_pages=200, seed=11)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,prefetch", [("ws", True), ("random", False)])
def test_kernel_matches_plain_past_1024_lines(cuda_device, policy, prefetch):
    """2,500 lines on a block of 512 threads: each thread loops over
    several lines in the lookup, the argmins, the draws and the prefetch
    scan; 33 windows. Every row evicts."""
    got = _check_kernel_against_plain(cuda_device, policy, prefetch, B=2,
                                      L=6000, N=2500, W=33, n_pages=6000,
                                      seed=21)
    assert tcs.cache_scan_threads(2500) == 512
    assert bool((got["evictions"] > 0).all())


@pytest.mark.cuda
def test_simulate_on_card_matches_cpu(cuda_device):
    """The whole main path on the card reports exactly what the plain
    path reports on the CPU, through one kernel launch."""
    import json

    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.sim import SimSpec, simulate
    spec = SimSpec(traffic=TrafficSpec(kind="irm", n_requests=3000,
                                       n_pages=800, write_fraction=0.3,
                                       seed=5),
                   store=T.StoreConfig(n_lines=48, prefetch=True),
                   n_shards=3, n_windows=4, mapping="random")
    tcs.reset_cache_scan_launch_count()
    on_card = simulate(spec, device=cuda_device).to_dict()
    assert tcs.cache_scan_launch_count() == 1
    on_cpu = simulate(spec, device="cpu").to_dict()
    assert (json.dumps(on_card, sort_keys=True)
            == json.dumps(on_cpu, sort_keys=True))


def _fill_then_mix(B, N, extra, seed):
    """Rows of ``N`` distinct pages (the cache fills), then ``extra``
    requests: new pages, a strided stretch, and four in ten repeating the
    page 1-300 requests back (across the look-ahead's windows of 256)."""
    rng = np.random.default_rng(seed)
    L = N + extra
    pages = np.empty((B, L), np.int64)
    for b in range(B):
        pages[b, :N] = rng.permutation(4 * N)[:N]
        pages[b, N:] = rng.integers(0, 6 * N, extra)
        pages[b, N + 100:N + 300] = 7 * N + 5 * np.arange(200)
        for i in range(N, L):
            if rng.random() < 0.4:
                pages[b, i] = pages[b, i - int(rng.integers(1, 301))]
    return pages.astype(np.int32), rng.random((B, L)) < 0.3


def _mixed_rows_against_plain(device, N, extra, prefetch, seed):
    """Two rows of each policy (betas 0.5 and 0.9) in one launch against
    the plain version: every field equal, f32 bit for bit; every row
    evicts."""
    B, W = 8, 5
    pages, writes = _fill_then_mix(B, N, extra, seed)
    dev = device
    hyper = T.StoreHyper(
        alpha=torch.full((B,), 0.5, device=dev),
        beta=torch.tensor([0.5, 0.9] * 4, device=dev),
        threshold=torch.full((B,), 0.25, device=dev),
        policy_idx=torch.tensor([T.POLICY_TO_IDX[p] for p in POLICIES
                                 for _ in range(2)], dtype=torch.int32,
                                device=dev))
    cfg = T.StoreConfig(n_lines=N, prefetch=prefetch).static_config()
    win = np.random.default_rng(seed + 1).integers(0, W + 1, pages.shape)
    args = (cfg, hyper, tcs.cold_keys(4, B, dev),
            *(torch.as_tensor(x, device=dev) for x in (pages, writes, win)))
    want = tcs.cache_scan_plain(*args, n_windows=W)
    got = tcs.cache_scan_cuda(*args, n_windows=W)
    torch.cuda.synchronize()
    for f, ref in want.items():
        out = got[f]
        if ref.dtype == torch.float32:
            out, ref = out.view(torch.int32), ref.view(torch.int32)
        assert torch.equal(out, ref), f"N={N} pf={prefetch} field={f}"
    assert bool((got["evictions"] > 0).all())
    if prefetch:
        assert bool((got["prefetch_hits"] + got["tier2_reads"]
                     > got["misses"]).any())  # the prefetcher issued
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
def test_shared_memory_layout_every_policy(cuda_device, prefetch):
    """16,384 lines, the main path's cache: the state in shared memory,
    a cluster of blocks a row; every policy (two betas each) in one launch
    of rows that fill and evict."""
    cfg = T.StoreConfig(n_lines=16384, prefetch=prefetch)
    plan = tcs.cache_scan_plan(cfg, 5, 8)
    assert plan.smem_state and plan.K == 256
    _mixed_rows_against_plain(cuda_device, 16384, 1500, prefetch, seed=31)


@pytest.mark.cuda
def test_device_scratch_layout_past_shared_memory(cuda_device):
    """20,000 lines do not fit a block's shared memory: the state lives in
    device scratch (the other instantiation), every policy, prefetching."""
    cfg = T.StoreConfig(n_lines=20000, prefetch=True)
    assert not tcs.cache_scan_plan(cfg, 5, 8).smem_state
    _mixed_rows_against_plain(cuda_device, 20000, 1200, True, seed=41)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [512, 16384])
def test_cluster_sizes_agree_bit_for_bit(cuda_device, N):
    """One block a row and a cluster of 8 (the other blocks draw the Random
    expert's uniforms for their share of the lines) give the same result,
    bit for bit, and the same as the plain version at 512 lines."""
    B, W = 2, 4
    pages, writes = _fill_then_mix(B, N, max(1000, N // 8), seed=N)
    win = np.random.default_rng(3).integers(0, W + 1, pages.shape)
    for policy in ("ws", "random"):
        cfg = T.StoreConfig(n_lines=N, policy=policy)
        args = (cfg, tcs.per_row(cfg.hyper(), B, cuda_device),
                tcs.cold_keys(7, B, cuda_device),
                *(torch.as_tensor(x, device=cuda_device)
                  for x in (pages, writes, win)))
        one = tcs._launch(*args, n_windows=W, cluster=1)
        eight = tcs._launch(*args, n_windows=W, cluster=8)
        torch.cuda.synchronize()
        assert bool((one["evictions"] > 0).all())
        for f in one:
            assert torch.equal(one[f], eight[f]), f"{policy} field={f}"
        if N == 512:
            want = tcs.cache_scan_plain(*args, n_windows=W)
            for f, ref in want.items():
                assert torch.equal(one[f], ref), f"{policy} field={f}"


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True])
def test_pages_repeated_across_lookahead_windows(cuda_device, prefetch):
    """512 lines (look-ahead windows of 256 requests), every policy: four
    requests in ten repeat a page 1-300 requests back, often from the
    window before, after the walk filled or evicted its line."""
    _mixed_rows_against_plain(cuda_device, 512, 4000, prefetch, seed=51)
