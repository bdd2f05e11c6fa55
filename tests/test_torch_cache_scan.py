"""The port's fused tier-1 engine against the reference.

- The plain PyTorch version (the CPU path of ``fused_cache_scan``) against
  ``repro.storage.tiered_store.run_stream(engine="fused")`` over policy x
  prefetch x windows x wall-clock binning: every ``StreamStats`` field
  equal, integers exactly and f32 weights bit for bit
  (``test_torch_run_distributed.py`` holds the sharded cases).
- One stream long enough that JAX draws the Random expert's uniforms
  in-loop instead of from a table.
- The plain version against the Pallas kernel in interpret mode.

The CUDA kernel against the plain version on the card is
``test_torch_cache_scan_cuda.py`` (no JAX there: the card's machine has
none).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.cache_scan import NOISE_TABLE_MAX, cache_scan_kernel
from repro.kernels.ref import cache_scan_noise as jax_noise
from repro.storage import tiered_store as J
from repro_torch.kernels import cache_scan as tcs
from repro_torch.storage import tiered_store as T


def _assert_stats_equal(want, got, ctx=""):
    for f in J.StreamStats._fields:
        x = np.asarray(getattr(want, f))
        y = getattr(got, f).cpu().numpy()
        assert x.shape == y.shape, f"{ctx} field={f}"
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(y, x, err_msg=f"{ctx} field={f}")


def _stream(seed, n=600, n_pages=160, wf=0.3):
    """Random pages with a strided stretch in the middle (so the stream
    identifier confirms strides and the prefetcher issues)."""
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, n_pages, n).astype(np.int32)
    m = min(120, n - n // 3)
    pages[n // 3: n // 3 + m] = 500 + 3 * np.arange(m)
    return pages, rng.random(n) < wf


def _cfgs(**kw):
    return J.StoreConfig(**kw), T.StoreConfig(**kw)


@pytest.mark.parametrize("policy", ["ws", "lru", "lfu", "random"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_run_stream_plain_matches_reference(policy, prefetch):
    pages, writes = _stream(0, n=400)
    win = np.minimum(np.arange(400) // 50, 7).astype(np.int32)
    win[-30:] = 8                                   # trailing pads
    jc, tc = _cfgs(n_lines=32, policy=policy, prefetch=prefetch)
    want = J.run_stream(jc, pages, writes, window_ids=win, n_windows=8,
                        seed=5)
    got = T.run_stream(tc, pages, writes, window_ids=win, n_windows=8,
                       seed=5, device="cpu")
    _assert_stats_equal(want, got, f"{policy}/pf={prefetch}")


def test_run_stream_traced_knobs_match():
    """Non-default knobs through ``hyper``: threshold 0 makes every
    misprediction a loss, so WeightAdjust moves the weights often."""
    pages, writes = _stream(1)
    jc, tc = _cfgs(n_lines=24)
    jh = J.StoreHyper(alpha=jnp.float32(0.3), beta=jnp.float32(0.7),
                      threshold=jnp.float32(0.0), policy_idx=jnp.int32(-1))
    th = T.StoreHyper(*(torch.tensor(np.asarray(x)) for x in jh))
    want = J.run_stream(jc, pages, writes, n_windows=4, hyper=jh, seed=2)
    got = T.run_stream(tc, pages, writes, n_windows=4, hyper=th, seed=2,
                       device="cpu")
    _assert_stats_equal(want, got, "knobs")
    assert not np.allclose(np.asarray(want.final_weights), 1 / 3)


def test_run_stream_timestamp_windows_match():
    """In-graph wall-clock binning (f32 ratio) with padded timestamps."""
    pages, writes = _stream(2)
    times = np.cumsum(np.random.default_rng(2).exponential(0.01, 600))
    times[-25:] = -1.0
    jc, tc = _cfgs(n_lines=32, prefetch=True)
    want = J.run_stream(jc, pages, writes, n_windows=5, timestamps=times,
                        window_dt=1.0, seed=1)
    got = T.run_stream(tc, pages, writes, n_windows=5, timestamps=times,
                       window_dt=1.0, seed=1, device="cpu")
    _assert_stats_equal(want, got, "timestamps")


@pytest.fixture
def one_torch_thread():
    """Keep the chunked draws on one intra-op thread: the test runs beside
    other workers, where a thread pool only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_in_loop_prng_path_matches(one_torch_thread):
    """``L * n_lines > 2**22``: the reference splits its key inside the
    loop instead of hoisting a table."""
    L, N = 2800, 1500
    assert L * N > NOISE_TABLE_MAX
    rng = np.random.default_rng(7)
    pages = rng.integers(0, 4000, L).astype(np.int32)
    writes = rng.random(L) < 0.2
    jc, tc = _cfgs(n_lines=N, policy="random")
    want = J.run_stream(jc, pages, writes, n_windows=2, seed=6)
    got = T.run_stream(tc, pages, writes, n_windows=2, seed=6, device="cpu")
    _assert_stats_equal(want, got, "in-loop")
    assert int(got.evictions) > 0


def test_plain_matches_pallas_interpret():
    """The plain version against the TPU kernel run in interpret mode."""
    L, N, W = 160, 16, 4
    rng = np.random.default_rng(2)
    pages = np.stack([rng.integers(0, 40, L), 7 + 2 * np.arange(L) % 90])
    pages = pages.astype(np.int32)
    writes = rng.random((2, L)) < 0.3
    win = np.tile(np.minimum(np.arange(L) // (L // W), W - 1), (2, 1))
    win = win.astype(np.int32)
    jc, tc = _cfgs(n_lines=N, prefetch=True)
    jh = jc.hyper()
    key = J.init_store(jc, 9).key
    want = cache_scan_kernel(
        jnp.asarray(pages), jnp.asarray(writes), jnp.asarray(win),
        jax_noise(key, L, N), jh.alpha, jh.beta, jh.threshold,
        jh.policy_idx, n_lines=N, epoch_width=jc.epoch_width,
        pred_cap=jc.pred_cap, prefetch=True,
        prefetch_width=jc.prefetch_width, prefetch_buf=jc.prefetch_buf,
        n_windows=W, interpret=True)
    got = tcs.fused_cache_scan(
        tc, tcs.per_row(tc.hyper(), 2, "cpu"), tcs.cold_keys(9, 2),
        torch.from_numpy(pages), torch.from_numpy(writes),
        torch.from_numpy(win), n_windows=W)
    assert set(got) == set(want)
    for f, x in got.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(want[f]),
                                      err_msg=f)


def test_cpu_path_launches_no_kernel_and_rejects_bad_input():
    tcs.reset_cache_scan_launch_count()
    cfg = T.StoreConfig(n_lines=8)
    pages, writes = _stream(4, n=50, n_pages=20)
    T.run_stream(cfg, pages, writes, device="cpu")
    assert tcs.cache_scan_launch_count() == 0
    with pytest.raises(NotImplementedError, match="chunked-replay"):
        T.run_stream(cfg, pages, writes, device="cpu", engine="scan")
    with pytest.raises(ValueError, match="unknown engine"):
        T.run_stream(cfg, pages, writes, device="cpu", engine="pallas")
    with pytest.raises(ValueError, match="non-negative"):
        T.run_stream(cfg, -1 - pages, writes, device="cpu")
    with pytest.raises(ValueError, match="no cache-scan path"):
        T.run_stream(cfg, pages, writes, device="meta")
