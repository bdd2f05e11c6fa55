"""The cache-scan kernel's masked mode (the chunked replay's engine) and
the chunked replay on the card (``cuda`` marker; each test skips where
``torch.cuda.is_available()`` is false). This file imports no JAX, so it
runs on a machine with a card and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_stream_cuda.py

The kernel resumes each row from a carried ``(StoreState, Accum)`` and
updates it in place; the plain version (``cache_scan_ref(masked=True)``)
runs the same chunks from the same carry. Chunks of unequal length carry
pads mid-row and at the tails; counters, carry and key must be equal and
the f32 weights equal bit for bit, in the shared-memory and the
device-scratch plan and at cluster sizes 1 and 8.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.traffic import TrafficSpec
from repro_torch.kernels import cache_scan as tcs
from repro_torch.sim import SimSpec, simulate_stream, stream_tier1_counters
from repro_torch.sim import tier1_counters
from repro_torch.storage import tiered_store as T

POLICIES = ["ws", "lru", "lfu", "random"]
# Leaves of carry_leaves() a fixed policy does not keep equal: the kernel
# computes only that policy's victim proposal, so the other experts' ring
# entries (and the mispredictions they would reveal) differ; under a fixed
# policy the learner never reads them.
RING_LEAVES = (6, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cache-scan kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _chunks(B, lengths, W, n_pages, seed):
    """Rows of pages (a strided stretch so the prefetcher issues), 30%
    writes and ascending window ids, cut into chunks of ``lengths``, with
    pads planted mid-row and at the tails (window id W or more)."""
    rng = np.random.default_rng(seed)
    L = sum(lengths)
    pages = rng.integers(0, n_pages, (B, L)).astype(np.int32)
    m = min(150, L // 3)
    pages[:, L // 3: L // 3 + m] = n_pages + 7 * np.arange(m)
    writes = rng.random((B, L)) < 0.3
    win = np.sort(rng.integers(0, W, (B, L)), axis=1).astype(np.int32)
    pad = rng.random((B, L)) < 0.15
    win[pad] = W + rng.integers(0, 3, pad.sum())
    out, at = [], 0
    for i, n in enumerate(lengths):
        sl = slice(at, at + n)
        w = win[:, sl].copy()
        w[i % B, -(n // 5):] = W  # one row's tail is pads
        out.append((pages[:, sl], writes[:, sl], w))
        at += n
    return out


def _equal(got, want, ctx, skip=()):
    for i, (x, y) in enumerate(zip(got, want)):
        if i in skip:
            continue
        if y.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{ctx}: leaf {i}"


def _run(device, cfg, chunks, W, **launch):
    """The chunks through the kernel and the plain version from one cold
    carry; every leaf compared after each chunk."""
    B = chunks[0][0].shape[0]
    hyper = tcs.per_row(cfg.hyper(), B, device)
    got = T.init_stream_carry(cfg, B, seed=4, n_windows=W, device=device)
    want = T.init_stream_carry(cfg, B, seed=4, n_windows=W, device=device)
    skip = () if cfg.policy == "ws" else RING_LEAVES
    for k, (p, w, wi) in enumerate(chunks):
        args = [torch.tensor(x, device=device) for x in (p, w, wi)]
        before = tcs.cache_scan_launch_count()
        got = tcs.masked_cache_scan_cuda(cfg, hyper, *got, *args,
                                         n_windows=W, **launch)
        assert tcs.cache_scan_launch_count() == before + 1
        want = tcs.masked_cache_scan_plain(cfg, hyper, *want, *args,
                                           n_windows=W)
        torch.cuda.synchronize()
        _equal(tcs.carry_leaves(*got), tcs.carry_leaves(*want),
               f"{cfg.policy}/pf={cfg.prefetch} chunk {k} {launch}", skip)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("prefetch", [False, True])
def test_masked_kernel_matches_plain(cuda_device, policy, prefetch):
    """Three chunks of unequal length, pads mid-row and at the tails, the
    carry non-cold from the second chunk on: every carried leaf equal
    after each chunk, the key advanced once per real request."""
    cfg = T.StoreConfig(n_lines=64, policy=policy, prefetch=prefetch)
    chunks = _chunks(3, (300, 517, 183), 5, 200, seed=21)
    final = _run(cuda_device, cfg, chunks, 5)
    real = sum(int((c[2] < 5).sum()) for c in chunks)
    assert int(final[1].win_requests.sum()) == real
    assert int(final[0].t.sum()) == real
    assert int(final[1].evictions.min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [dict(cluster=1), dict(cluster=8),
                                    dict(smem_state=False),
                                    dict(smem_state=False, cluster=8)])
def test_masked_kernel_plans_and_clusters(cuda_device, launch):
    """The shared-memory and device-scratch plans, one block and a cluster
    of 8 a row, at 4,096 lines and 64 composite windows."""
    cfg = T.StoreConfig(n_lines=4096, policy="ws", prefetch=True)
    chunks = _chunks(2, (3000, 6100, 2900), 64, 9000, seed=5)
    final = _run(cuda_device, cfg, chunks, 64, **launch)
    assert int(final[1].evictions.min()) > 0


@pytest.mark.cuda
def test_masked_launch_repeats_its_bits(cuda_device):
    """Two launches from copies of one carry give the same carry."""
    cfg = T.StoreConfig(n_lines=256, policy="ws")
    (p, w, wi), = _chunks(4, (2500,), 8, 900, seed=2)
    args = [torch.tensor(x, device=cuda_device) for x in (p, w, wi)]
    hyper = tcs.per_row(cfg.hyper(), 4, cuda_device)
    outs = []
    for _ in range(2):
        carry = T.init_stream_carry(cfg, 4, n_windows=8, device=cuda_device)
        outs.append(tcs.carry_leaves(*tcs.masked_cache_scan_cuda(
            cfg, hyper, *carry, *args, n_windows=8)))
    torch.cuda.synchronize()
    _equal(outs[0], outs[1], "repeat")


@pytest.mark.cuda
def test_masked_kernel_rejects_aliased_carry(cuda_device):
    cfg = T.StoreConfig(n_lines=16)
    state, acc = T.init_stream_carry(cfg, 2, device=cuda_device)
    acc = acc._replace(misses=acc.hits)
    z = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="share memory"):
        tcs.masked_cache_scan_cuda(cfg, cfg.hyper(), state, acc, z, z, z,
                                   n_windows=1)


def _spec(**kw):
    base = dict(traffic=TrafficSpec(kind="irm", n_requests=1200,
                                    n_pages=512, zipf_s=1.1,
                                    write_fraction=0.3, seed=3),
                store=T.StoreConfig(n_lines=64, policy="ws"),
                n_shards=4, n_windows=7)
    base.update(kw)
    return SimSpec(**base)


def _counters_equal(a, b, ctx):
    for f in a._fields:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f"{ctx}: {f}"


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [11, 173, 2048])
def test_chunked_replay_on_card_matches_cpu_and_one_shot(cuda_device,
                                                         chunk):
    spec = _spec()
    one = tier1_counters(spec, device="cuda")
    cpu, _, _ = stream_tier1_counters(spec, chunk=chunk, device="cpu")
    T.reset_stream_compile_count()
    got, _, ck = stream_tier1_counters(spec, chunk=chunk, device="cuda")
    assert T.stream_compile_count() <= 2 and ck.done
    _counters_equal(got, one, f"chunk {chunk} vs one-shot")
    _counters_equal(got, cpu, f"chunk {chunk} vs cpu")


@pytest.mark.cuda
def test_resume_and_baseline_on_card(cuda_device):
    spec = _spec(window_dt=0.25, n_windows=1,
                 traffic=TrafficSpec(kind="irm", n_requests=1500,
                                     n_pages=256, zipf_s=1.2, rate=500.0,
                                     seed=5))
    full = simulate_stream(spec, chunk=250, device="cuda")
    _, ck = simulate_stream(spec, chunk=250, max_requests=700,
                            device="cuda")
    rest = simulate_stream(spec, chunk=321, checkpoint=ck, device="cuda")
    assert rest.to_dict() == full.to_dict()
    base = simulate_stream(spec, chunk=300, donate=False, device="cuda")
    assert base.to_dict() == full.to_dict()
    assert simulate_stream(spec, chunk=300, device="cpu").to_dict() \
        == full.to_dict()


@pytest.mark.cuda
def test_scan_engine_on_card_matches_fused(cuda_device):
    spec = _spec(store=T.StoreConfig(n_lines=64, policy="ws",
                                     prefetch=True))
    fused = tier1_counters(spec, device="cuda")
    _counters_equal(tier1_counters(spec, engine="scan", device="cuda"),
                    fused, "scan one-shot")
    got, _, _ = stream_tier1_counters(spec, chunk=400, engine="scan",
                                      device="cuda")
    _counters_equal(got, fused, "scan chunked")
