"""The CUDA cache-scan kernel against its plain PyTorch version on the
card (``cuda`` marker; each test skips where ``torch.cuda.is_available()``
is false). This file imports no JAX, so it runs on a machine with a card
and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_cache_scan_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_scan as tcs
from repro_torch.storage import tiered_store as T


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
    """2,500 lines on a block of 1,024 threads: each thread loops over
    several lines in the lookup, the argmins, the draws and the prefetch
    scan; 33 windows. Every row evicts."""
    got = _check_kernel_against_plain(cuda_device, policy, prefetch, B=2,
                                      L=6000, N=2500, W=33, n_pages=6000,
                                      seed=21)
    assert tcs.cache_scan_threads(2500) == 1024
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
