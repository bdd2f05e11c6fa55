"""The SSD and RG-LRU scan kernels on the card, and the serving kernels at
recurrentgemma's shapes (``cuda`` marker; each test skips where
``torch.cuda.is_available()`` is false). This file imports no JAX, so it
runs on a machine with a card and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_scan_kernels_cuda.py

Tolerances: the SSD scan's y and final state within 1e-5 of the largest
magnitude in f32 (the bar of ``tests/test_kernels.py``; f32 products
summed in another order), y within 1e-2 of it in bf16 (the same f32
values rounded to bf16 may land one bf16 step apart: 2^-8 of a value) and
the state within 1e-5; at mamba2-370m's P, N and chunk with heads
sharing B and C, in bf16 y within one bf16 step element by element and
the state within 1e-4 (phase 11's bars); the RG-LRU scan within 1e-5 in f32 (the reference
test's bar) and element by element within one bf16 step in bf16; flash
attention at hd 256 and the windowed paged kernel at the bars of
``tests/test_torch_serving_cuda.py``; the served models, kernels against
plain versions on the same tokens, as there.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plain_versions
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import (attention_ref, paged_attention_ref,
                                     rglru_ref, ssd_ref)
from repro_torch.launch import serve
from repro_torch.models.params import init_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return (torch.as_tensor(rng.normal(size=shape) * scale,
                            dtype=torch.float32)
            .to(device=dev, dtype=dtype))


def _rel(got, want) -> float:
    w = want.double()
    return float((got.double() - w).abs().max() / w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,Q", [
    (2, 64, 3, 8, 16, 16),
    (1, 128, 2, 16, 8, 32),
    (2, 45, 3, 8, 16, 16),          # ragged: S % Q != 0
    (1, 512, 4, 64, 128, 256),      # mamba2-370m's P, N and chunk
    (2, 300, 32, 64, 128, 256),     # its 32 heads, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda_device, B, S, H, P, N, Q, dtype):
    rng = np.random.default_rng(S + 7 * N)
    dev = cuda_device
    x = _randn(rng, (B, S, H, P), dtype, dev)
    dt = torch.as_tensor(np.abs(rng.normal(size=(B, S, H))) * 0.5 + 0.01,
                         dtype=torch.float32, device=dev)
    A = torch.as_tensor(-np.abs(rng.normal(size=(H,))), dtype=torch.float32,
                        device=dev)
    Bm = _randn(rng, (B, S, N), dtype, dev, 0.3)
    Cm = _randn(rng, (B, S, N), dtype, dev, 0.3)
    before = ss.ssd_scan_launch_count()
    y, h = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    assert ss.ssd_scan_launch_count() == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    with plain_versions():
        yp, hp = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    assert ss.ssd_scan_launch_count() == before + 1
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    assert _rel(y, yp) < (1e-5 if dtype == torch.float32 else 1e-2)
    assert _rel(h, hp) < 1e-5
    if S <= 128:  # the step-by-step recurrence, in f32
        assert _rel(y, ssd_ref(x, dt, A, Bm, Cm)) < (
            1e-5 if dtype == torch.float32 else 1e-2)


def _bf16_step_excess(got, want) -> float:
    """Largest ``|got - want| / (2^-7 |want| + 1e-5)``: at most 1 passes
    (one bf16 step, phase 11's bar in ``chip_smoke.py``)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (2.0 ** -7 * w.abs() + 1e-5)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("H,S", [(1, 512), (32, 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_heads_share_bc(cuda_device, H, S, dtype):
    """mamba2-370m's P, N and chunk with one head and with 32 heads that
    share one B and C (C B^T computed once for them), and a ragged S (700
    steps, padded to three chunks): one launch; in bf16 y within one bf16
    step of the plain version and the final state within 1e-4 of its
    largest magnitude (phase 11's bars), in f32 both within 1e-5."""
    rng = np.random.default_rng(H + S)
    dev = cuda_device
    x = _randn(rng, (2, S, H, 64), dtype, dev)
    dt = torch.as_tensor(np.abs(rng.normal(size=(2, S, H))) * 0.5 + 0.01,
                         dtype=torch.float32, device=dev)
    A = torch.as_tensor(-np.abs(rng.normal(size=(H,))), dtype=torch.float32,
                        device=dev)
    Bm = _randn(rng, (2, S, 128), dtype, dev, 0.3)
    Cm = _randn(rng, (2, S, 128), dtype, dev, 0.3)
    before = ss.ssd_scan_launch_count()
    y, h = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert ss.ssd_scan_launch_count() == before + 1
    with plain_versions():
        yp, hp = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    if dtype == torch.bfloat16:
        assert _bf16_step_excess(y, yp) <= 1
        assert _rel(h, hp) <= 1e-4
    else:
        assert _rel(y, yp) <= 1e-5 and _rel(h, hp) <= 1e-5


@pytest.mark.cuda
def test_ssd_kernel_decay_never_overflows(cuda_device):
    """cum falls by 200 a step: above the diagonal exp(cum_t - cum_s) is
    inf; the kernel must select, not multiply by a mask."""
    rng = np.random.default_rng(5)
    dev = cuda_device
    x = _randn(rng, (1, 256, 2, 64), torch.float32, dev)
    dt = torch.full((1, 256, 2), 20.0, device=dev)
    A = torch.full((2,), -10.0, device=dev)
    Bm = _randn(rng, (1, 256, 128), torch.float32, dev)
    Cm = _randn(rng, (1, 256, 128), torch.float32, dev)
    y, h = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert _rel(y, ssd_ref(x, dt, A, Bm, Cm)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(2, 64, 32), (1, 128, 64), (3, 77, 200),
                                   (2, 333, 4096),  # recurrentgemma's width
                                   (3, 1, 64),      # one step
                                   (2, 50, 96),     # below one chunk
                                   (2, 200, 77),    # odd W: one channel a load
                                   (1, 3072, 4096)])  # many chunks
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain(cuda_device, B, S, W, dtype):
    rng = np.random.default_rng(S + W)
    dev = cuda_device
    u = _randn(rng, (B, S, W), dtype, dev)
    ps = [_randn(rng, (W,), dtype, dev, 0.5) for _ in range(5)]
    before = rs.rglru_scan_launch_count()
    h = rs.rglru_scan(u, *ps)
    torch.cuda.synchronize()
    assert rs.rglru_scan_launch_count() == before + 1 and h.dtype == dtype
    with plain_versions():
        hp = rs.rglru_scan(u, *ps)
    if dtype == torch.float32:
        torch.testing.assert_close(h, hp, atol=1e-5, rtol=0)
        torch.testing.assert_close(h, rglru_ref(u, *ps), atol=1e-5, rtol=0)
    else:
        d = (h.float() - hp.float()).abs()
        assert bool((d <= 2.0 ** -7 * hp.float().abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(2, 100, 64), (1, 1000, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_repeats_its_bits(cuda_device, B, S, W, dtype):
    """Two launches give the same bits (the look-back's carry does not
    depend on which chunks it found published), at the bars above."""
    rng = np.random.default_rng(S * 3 + W)
    dev = cuda_device
    u = _randn(rng, (B, S, W), dtype, dev)
    ps = [_randn(rng, (W,), dtype, dev, 0.5) for _ in range(5)]
    h = rs.rglru_scan_cuda(u, *ps)
    again = rs.rglru_scan_cuda(u, *ps)
    torch.cuda.synchronize()
    assert torch.equal(h.view(torch.int8), again.view(torch.int8))
    hp = rs.rglru_scan_plain(u, *ps)
    if dtype == torch.float32:
        torch.testing.assert_close(h, hp, atol=1e-5, rtol=0)
    else:
        d = (h.float() - hp.float()).abs()
        assert bool((d <= 2.0 ** -7 * hp.float().abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,window", [(2, 128, None), (1, 200, 64),
                                        (2, 300, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_head_dim_256(cuda_device, B, S, window, dtype):
    """recurrentgemma's attention: 16 query heads over 1 KV head, hd 256,
    sliding windows."""
    rng = np.random.default_rng(S)
    dev = cuda_device
    q = _randn(rng, (B, 16, S, 256), dtype, dev)
    k = _randn(rng, (B, 1, S, 256), dtype, dev)
    v = _randn(rng, (B, 1, S, 256), dtype, dev)
    before = fa.flash_attention_launch_count()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_launch_count() == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,page,n_pages,slots,window", [
    (3, 4, 1, 16, 8, 5, 16, 13),
    (2, 4, 2, 16, 8, 6, 8, 8),
    (3, 16, 1, 256, 128, 5, 9, 300),   # recurrentgemma's heads and page
    (2, 16, 1, 256, 128, 4, 9, 64),    # a window inside one page
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_with_window(cuda_device, B, H, KV, hd, page, n_pages,
                                  slots, window, dtype):
    rng = np.random.default_rng(B * 13 + hd + window)
    dev = cuda_device
    pool = _randn(rng, (slots, 2, page, 2, KV, hd), dtype, dev)[:, 1]
    q = _randn(rng, (B, H, hd), dtype, dev)
    ps = torch.as_tensor(rng.integers(-1, slots, size=(B, n_pages)),
                         dtype=torch.int32)
    lengths = torch.as_tensor(rng.integers(page, page * n_pages, size=(B,)),
                              dtype=torch.int32)
    lengths[0] = min(window, page * n_pages)  # the window reaches token 0
    lengths[-1] = page * n_pages - 1           # the window cuts
    tol = 3e-5 if dtype == torch.float32 else 1e-4
    before = pa.paged_attention_launch_count()
    got = pa.paged_attention(q, pool, ps, lengths, window)
    torch.cuda.synchronize()
    assert pa.paged_attention_launch_count() == before + 1
    want = paged_attention_ref(q, pool, ps, lengths, window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    full = paged_attention_ref(q, pool, ps, lengths)
    assert not torch.allclose(want[2][-1], full[2][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_serving_on_card_matches_plain_versions(cuda_device, name):
    """The reduced model in bf16 on the card, 3 sequences, 40 decode steps
    (recurrentgemma: evictions, and a read window that leaves the oldest
    pages), against the plain versions on the same tokens: tier state
    equal, recurrent states and logprobs within 2e-2 (bf16 activations)."""
    cfg = ARCHS[name].reduced()
    params = init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    serve.reset_launch_counts()
    run = serve.serve(cfg, params, prompts, new=41, hbm_fraction=0.4)
    counts = serve.launch_counts()
    kinds = cfg.layer_kinds()
    assert counts["ssd_scan"] == kinds.count("ssd")
    assert counts["rglru_scan"] == kinds.count("rglru")
    n_attn = sum(k.startswith("attn") for k in kinds)
    assert counts["flash_attention"] == n_attn
    assert counts["paged_attention"] == 2 * n_attn * 40
    forced = torch.as_tensor(run.tokens[:, :-1], device=cuda_device)
    with plain_versions():
        plain = serve.serve(cfg, params, prompts, new=41, hbm_fraction=0.4,
                            forced=forced)
    assert serve.launch_counts() == counts
    for a, b in ((run.state.rec, plain.state.rec),
                 (run.state.rec_tail, plain.state.rec_tail)):
        for da, db in zip(a, b):
            for k in da:
                assert _rel(da[k].float(), db[k].float()) < 2e-2, k
    if n_attn:
        a, b = run.state.kv, plain.state.kv
        for f in ("page_slot", "lengths", "t1_reads", "t2_reads",
                  "evictions"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert int(a.evictions[0]) > 0
    else:
        assert run.state.kv is None
    assert np.abs(run.logprobs - plain.logprobs).max() < 2e-2
