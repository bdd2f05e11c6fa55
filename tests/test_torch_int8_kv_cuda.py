"""The paged-attention kernel's int8 variant on the card (``cuda`` marker;
each test skips where ``torch.cuda.is_available()`` is false), against its
plain PyTorch version: int8 pools with one f32 scale a (slot, token, k/v),
read as ``bf16(f32(q) * sc)``. This file imports no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_int8_kv_cuda.py

Cases: GQA 4 and 16, head dims 128 and 256, ``-1`` slots and slots past
the pool (their pages and scales unread), odd lengths, a sliding window,
and ``scale[:, li]`` of a multi-layer pool read through its slot stride.
Tolerance 1e-4, the bf16 pools' bar of ``test_torch_serving_cuda.py``:
both sides compute in f32 from the same bf16 values, in another order.
Besides, the int8 kernel equals the bf16 kernel on the dequantized pool
bit for bit (its arithmetic after the read is the bf16 path's), and two
calls are equal bit for bit. ``page_copy`` moves scale rows byte for
byte.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import page_gather as pg
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import page_copy_ref, paged_attention_ref
from repro_torch.serving.kvpool import quantize


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _int8_case(rng, dev, B, H, KV, hd, page, n_pages, slots, layers):
    """An int8 pool ``[slots, layers, page, 2, KV, hd]`` quantized from
    normal values of varied magnitude, its scales, q, a page table with
    -1 and past-the-pool slots, and lengths (odd, at a page edge, one past
    an edge)."""
    x = rng.normal(size=(slots, layers, page, 2, KV, hd)) * \
        10.0 ** rng.uniform(-2, 1, size=(slots, layers, page, 2, 1, 1))
    codes, scale = quantize(torch.as_tensor(x, dtype=torch.float32))
    q = torch.as_tensor(rng.normal(size=(B, H, hd)), dtype=torch.float32)
    ps = rng.integers(-1, slots + 3, size=(B, n_pages)).astype(np.int32)
    lengths = (2 * rng.integers(0, page * n_pages // 2, size=(B,)) + 1
               ).astype(np.int32)
    ps[0, :] = -1                    # every token masked
    lengths[-1] = page * 2           # a length at a page edge
    if B > 2:
        lengths[1] = page * 3 + 1    # one token past an edge
    return (q.to(dev), codes.to(dev), scale.to(dev), torch.as_tensor(ps),
            torch.as_tensor(lengths))


def _dequant(pool, scale):
    return (pool.float() * scale[..., None, None]).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,hd,page,n_pages,slots,window", [
    (2, 4, 1, 128, 16, 6, 8, 0),      # GQA 4
    (3, 16, 1, 256, 16, 7, 12, 0),    # GQA 16 (recurrentgemma's heads)
    (3, 16, 1, 256, 16, 7, 12, 37),   # ... with a window
    (4, 32, 8, 128, 128, 5, 9, 0),    # mistral-nemo's heads and page
    (3, 16, 4, 128, 32, 9, 14, 100),  # GQA 4, window across pages
    (8, 32, 8, 128, 128, 40, 170, 0),  # several splits a sequence
])
def test_int8_paged_kernel_matches_plain(cuda_device, B, H, KV, hd, page,
                                         n_pages, slots, window):
    rng = np.random.default_rng(B * 97 + hd + page + window)
    q, pool6, sc4, ps, lengths = _int8_case(rng, cuda_device, B, H, KV, hd,
                                            page, n_pages, slots, layers=3)
    for li in range(3):
        view, sview = pool6[:, li], sc4[:, li]  # through the slot strides
        before = pa.paged_attention_launch_count()
        got = pa.paged_attention(q, view, ps, lengths, window, scale=sview)
        again = pa.paged_attention(q, view, ps, lengths, window, scale=sview)
        torch.cuda.synchronize()
        assert pa.paged_attention_launch_count() == before + 2
        want = paged_attention_ref(q, view, ps, lengths, window, sview)
        deq = _dequant(view, sview).contiguous()
        bf16 = pa.paged_attention(q, deq, ps, lengths, window)
        for g, a, w, b in zip(got, again, want, bf16):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
            assert torch.equal(g.view(torch.int32), a.view(torch.int32))
            assert torch.equal(g.view(torch.int32), b.view(torch.int32))
        assert float(got[0][0].abs().max()) == 0.0
        assert float(got[2][0].abs().max()) == 0.0
        assert bool((got[1][0] == np.float32(-1e30)).all())


@pytest.mark.cuda
def test_int8_plain_rounds_to_bf16(cuda_device):
    """The plain version dequantizes to bf16 before its f32 products: a
    version without that rounding differs from it by more than the bar."""
    rng = np.random.default_rng(3)
    q, pool6, sc4, ps, lengths = _int8_case(rng, cuda_device, 4, 32, 8, 128,
                                            128, 5, 9, layers=1)
    ps = ps.abs() % 9
    view, sview = pool6[:, 0], sc4[:, 0]
    got = pa.paged_attention(q, view, ps, lengths, scale=sview)
    unrounded = (view.float() * sview[..., None, None]).contiguous()
    bad = paged_attention_ref(q, unrounded, ps, lengths)
    err = max(float((g - b).abs().max()) for g, b in zip(got, bad))
    assert err > 1e-4, err


@pytest.mark.cuda
def test_int8_wrapper_checks(cuda_device):
    pool = torch.zeros((4, 16, 2, 1, 128), dtype=torch.int8,
                       device=cuda_device)
    q = torch.zeros((1, 4, 128), device=cuda_device)
    ps = torch.zeros((1, 2), dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale pool"):
        pa.paged_attention(q, pool, ps, ln)
    with pytest.raises(ValueError, match="scale must be"):
        pa.paged_attention(q, pool, ps, ln,
                           scale=torch.ones((4, 16), device=cuda_device))


@pytest.mark.cuda
def test_page_copy_moves_int8_pages_and_scale_rows(cuda_device):
    """Byte for byte: int8 whole slots and one layer's pages, and scale
    rows (whole slots of [layers, page, 2] f32, and one layer's [page, 2]
    through the slot stride), with -1 pairs."""
    rng = np.random.default_rng(5)
    dev = cuda_device
    slots, layers, page, KV, hd = 9, 5, 64, 4, 128
    x = torch.as_tensor(rng.normal(size=(slots, layers, page, 2, KV, hd)),
                        dtype=torch.float32)
    codes, scale = quantize(x)
    codes, scale = codes.to(dev), scale.to(dev)
    di = torch.tensor([4, -1, 0, 8, 2], dtype=torch.int32)
    si = torch.tensor([0, 1, 7, -1, 3], dtype=torch.int32)
    for whole in (codes, scale):
        src = whole.flip(0).contiguous()
        for sel in (slice(None), 3):   # whole slots, then one layer
            got, want = whole.clone(), whole.clone()
            d = got if sel == slice(None) else got[:, sel]
            w = want if sel == slice(None) else want[:, sel]
            s = src if sel == slice(None) else src[:, sel]
            pg.page_copy(d, s, di, si)
            page_copy_ref(w, s, di, si)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
