"""The serving kernels on the card (``cuda`` marker; each test skips where
``torch.cuda.is_available()`` is false): flash attention, paged attention
and page copy against their plain PyTorch versions at small shapes, and
the serving engine on the card with its kernels against the same engine
with the plain versions selected. This file imports no JAX, so it runs on
a machine with a card and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_serving_cuda.py

Tolerances: flash attention 2e-5 (f32) and 2e-2 (bf16 output, the bar of
``tests/test_kernels.py``), and in bf16 element by element within one
bf16 step (``|diff| <= 2^-7 |plain| + 1e-5``, the bar of
``chip_smoke.py``); paged attention 3e-5 on f32 pools and 1e-4 on bf16
pools (both sides compute in f32 from the same bf16 values, in another
order), and equal bit for bit from call to call; page copy byte for
byte.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import page_gather as pg
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import plain_versions
from repro_torch.kernels.ref import (attention_ref, page_copy_ref,
                                     paged_attention_ref)
from repro_torch.launch import serve
from repro_torch.models.params import init_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).to(
        device=dev, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, 4, 2, 128, 32, True, None),
    (1, 4, 1, 256, 16, True, 64),
    (2, 2, 2, 128, 32, False, None),
    (1, 8, 8, 128, 64, True, None),
    (2, 8, 2, 200, 128, True, None),   # ragged last tile
    (1, 6, 3, 77, 80, True, 33),       # ragged, window, hd 80
    (1, 4, 4, 65, 128, False, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, B, H, KV, S, hd, causal,
                                    window, dtype):
    rng = np.random.default_rng(S * 31 + hd)
    q = _randn(rng, (B, H, S, hd), dtype, cuda_device)
    k = _randn(rng, (B, KV, S, hd), dtype, cuda_device)
    v = _randn(rng, (B, KV, S, hd), dtype, cuda_device)
    before = fa.flash_attention_launch_count()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_launch_count() == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # The model's [B, S, H, hd] layout as transposed views: no copy, and
    # the output keeps q's strides.
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    om = fa.flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                            vm.transpose(1, 2), causal=causal, window=window)
    assert om.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(om.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,window", [
    (1, 2, 1, 130, 16, None),     # ragged last tile
    (2, 4, 2, 200, 32, 48),
    (1, 8, 4, 256, 64, None),
    (1, 6, 3, 333, 80, 100),      # ragged, window
    (2, 8, 2, 384, 128, None),
    (1, 4, 4, 65, 128, None),     # the second warpgroup's rows past S
    (1, 16, 1, 320, 256, 200),    # recurrentgemma's G = 16, window
])
def test_flash_bf16_kernel_within_one_bf16_step(cuda_device, B, H, KV, S, hd,
                                                window):
    """The tensor-core path, element by element against the plain
    version, at every compiled head dim."""
    rng = np.random.default_rng(S * 7 + hd)
    q = _randn(rng, (B, H, S, hd), torch.bfloat16, cuda_device)
    k = _randn(rng, (B, KV, S, hd), torch.bfloat16, cuda_device)
    v = _randn(rng, (B, KV, S, hd), torch.bfloat16, cuda_device)
    before = fa.flash_attention_launch_count()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_launch_count() == before + 1
    want = attention_ref(q, k, v, causal=True, window=window).float()
    excess = ((got.float() - want).abs() / (2.0 ** -7 * want.abs() + 1e-5))
    assert float(excess.max()) <= 1


def _paged_case(rng, dev, dtype, B, H, KV, hd, page, n_pages, slots, layers):
    pool6 = _randn(rng, (slots, layers, page, 2, KV, hd), dtype, dev)
    q = _randn(rng, (B, H, hd), dtype, dev)
    ps = rng.integers(-1, slots, size=(B, n_pages)).astype(np.int32)
    lengths = rng.integers(1, page * n_pages, size=(B,)).astype(np.int32)
    ps[0, :] = -1                    # every token masked
    lengths[-1] = page * 2           # a length at a page edge
    if B > 2:
        lengths[1] = page * 3 + 1    # one token past an edge
    return q, pool6, torch.as_tensor(ps), torch.as_tensor(lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,page,n_pages,slots", [
    (2, 4, 2, 16, 8, 6, 8),
    (1, 8, 8, 32, 16, 4, 4),
    (3, 4, 1, 16, 8, 5, 16),
    (4, 32, 8, 128, 128, 5, 9),      # mistral-nemo's heads and page
    (3, 32, 32, 80, 16, 7, 12),      # stablelm's heads (G = 1)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain(cuda_device, B, H, KV, hd, page, n_pages,
                                    slots, dtype):
    rng = np.random.default_rng(B * 97 + hd + page)
    q, pool6, ps, lengths = _paged_case(rng, cuda_device, dtype, B, H, KV, hd,
                                        page, n_pages, slots, layers=3)
    tol = 3e-5 if dtype == torch.float32 else 1e-4
    for li in range(3):
        view = pool6[:, li]  # one layer, read through the slot stride
        before = pa.paged_attention_launch_count()
        got = pa.paged_attention(q, view, ps, lengths)
        torch.cuda.synchronize()
        assert pa.paged_attention_launch_count() == before + 1
        want = paged_attention_ref(q, view, ps, lengths)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=tol, rtol=tol)
        assert float(got[0][0].abs().max()) == 0.0
        assert float(got[2][0].abs().max()) == 0.0
        assert bool((got[1][0] == np.float32(-1e30)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,n_pages,window", [
    (4, 32, 8, 128, 27, 0),       # mistral-nemo's heads
    (3, 16, 1, 256, 27, 300),     # recurrentgemma's: windows across splits
    (2, 16, 1, 256, 40, 2048),
    (8, 32, 8, 128, 40, 0),
])
def test_paged_kernel_split_over_pages(cuda_device, B, H, KV, hd, n_pages,
                                       window):
    """Pages of 128 tokens split across blocks (several splits a
    sequence): against the plain version, an empty sequence, one launch a
    call, and two calls equal bit for bit."""
    rng = np.random.default_rng(n_pages * 13 + hd + window)
    page = 128
    slots = B * n_pages // 2 + 3
    q, pool6, ps, lengths = _paged_case(rng, cuda_device, torch.bfloat16, B,
                                        H, KV, hd, page, n_pages, slots,
                                        layers=2)
    assert pa.split_plan(B, KV, n_pages, page)[0] > 1
    view = pool6[:, 1]
    before = pa.paged_attention_launch_count()
    got = pa.paged_attention(q, view, ps, lengths, window)
    again = pa.paged_attention(q, view, ps, lengths, window)
    torch.cuda.synchronize()
    assert pa.paged_attention_launch_count() == before + 2
    want = paged_attention_ref(q, view, ps, lengths, window)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
    assert float(got[0][0].abs().max()) == 0.0
    assert float(got[2][0].abs().max()) == 0.0
    assert bool((got[1][0] == np.float32(-1e30)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_page_copy_kernel_matches_plain(cuda_device, dtype):
    """Byte for byte: one layer's pages into a strided pool view (prefill),
    whole slots of 2 MiB and more (write-back, promotion; several chunks a
    pair), -1 pairs, and rows whose size is not a multiple of 16 bytes."""
    rng = np.random.default_rng(7)
    dev = cuda_device
    slots, layers, page, KV, hd = 9, 5, 64, 4, 128
    pool = _randn(rng, (slots, layers, page, 2, KV, hd), dtype, dev)
    data = _randn(rng, (6, page, 2, KV, hd), dtype, dev)
    di = torch.tensor([4, -1, 0, 8, 2, 6], dtype=torch.int32)
    si = torch.tensor([0, 1, 2, -1, 4, 5], dtype=torch.int32)
    for li in (0, 3):
        got, want = pool.clone(), pool.clone()
        pg.page_copy(got[:, li], data, di, si)
        page_copy_ref(want[:, li], data, di, si)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    other = _randn(rng, (4, layers, page, 2, KV, hd), dtype, dev)
    d2 = torch.tensor([3, 0, -1], dtype=torch.int32, device=dev)
    s2 = torch.tensor([8, 1, 2], dtype=torch.int32, device=dev)
    got, want = other.clone(), other.clone()
    before = pg.page_copy_launch_count()
    pg.page_copy(got, pool, d2, s2)
    page_copy_ref(want, pool, d2, s2)
    torch.cuda.synchronize()
    assert pg.page_copy_launch_count() == before + 1
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    odd = _randn(rng, (5, 3), dtype, dev)
    src = _randn(rng, (4, 3), dtype, dev)
    got, want = odd.clone(), odd.clone()
    pg.page_copy(got, src, torch.tensor([1, 4], dtype=torch.int32),
                 torch.tensor([3, 0], dtype=torch.int32))
    page_copy_ref(want, src, torch.tensor([1, 4]), torch.tensor([3, 0]))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_full_width_f32_kernel_run_matches_plain_run(cuda_device):
    """mistral-nemo-12b at full width, cut to 4 layers, in f32: 8 x
    3,072-token prompts and 24 decode steps with the kernels, then with
    the plain versions fed the same tokens. With bf16 rounding out of the
    way the kernels' other summation order moves the logprobs by no more
    than 1e-4 nats (in bf16 at 40 layers the same comparison differs by
    tenths: ``chip_smoke.py`` phase 10 and its noise floor)."""
    cfg = dataclasses.replace(ARCHS["mistral-nemo-12b"], n_layers=4,
                              param_dtype="float32")
    params = init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (8, 3072)).astype(np.int32)
    run = serve.serve(cfg, params, prompts, new=25)
    forced = torch.as_tensor(run.tokens[:, :-1], device=cuda_device)
    with plain_versions():
        plain = serve.serve(cfg, params, prompts, new=25, forced=forced)
    assert np.abs(run.logprobs - plain.logprobs).max() < 1e-4
    assert torch.equal(run.state.kv.page_slot, plain.state.kv.page_slot)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mistral-nemo-12b", "stablelm-3b"])
def test_serving_on_card_matches_plain_versions(cuda_device, name):
    """The reduced model in bf16 on the card, 3 sequences, 20 decode steps
    with evictions: the kernels' run against the plain versions' run on
    the same tokens (teacher-forced). The tier state is equal integer for
    integer and the f32 learner weights bit for bit; the logprobs agree
    within 2e-2 (bf16 activations)."""
    cfg = ARCHS[name].reduced()
    cfg = dataclasses.replace(cfg, n_layers=3)
    params = init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab, (3, 32)).astype(np.int32)
    serve.reset_launch_counts()
    run = serve.serve(cfg, params, prompts, new=21, hbm_fraction=0.4)
    counts = serve.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["paged_attention"] == 2 * cfg.n_layers * 20
    assert counts["page_copy"] >= 2 * cfg.n_layers
    forced = torch.as_tensor(run.tokens[:, :-1], device=cuda_device)
    with plain_versions():
        plain = serve.serve(cfg, params, prompts, new=21, hbm_fraction=0.4,
                            forced=forced)
    assert serve.launch_counts() == counts
    a, b = run.state.kv, plain.state.kv
    for f in ("page_slot", "t2_slot", "lengths", "t", "t1_reads", "t2_reads",
              "evictions", "writebacks"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a.meta, b.meta):
        assert torch.equal(x, y)
    for x, y in zip(a.ols, b.ols):
        assert torch.equal(x, y)
    assert a.key == b.key and int(a.evictions[0]) > 0
    assert np.abs(run.logprobs - plain.logprobs).max() < 2e-2
