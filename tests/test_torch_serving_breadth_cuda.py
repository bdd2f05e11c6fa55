"""The flash kernel's new masks on the card (``cuda`` marker; each test
skips where ``torch.cuda.is_available()`` is false): prefix-LM (a VLM's
bidirectional prefix), and non-causal attention with fewer queries than
keys and a key count that is not a multiple of the kernel's tile
(whisper's encoder and cross-attention), at head dims 64, 128 and 256,
against the plain PyTorch version; then the serving engine of each new
family (reduced whisper-tiny, paligemma-3b, mixtral-8x22b in f32) with
its kernels against the same engine with the plain versions selected.
This file imports no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_serving_breadth_cuda.py

Tolerances: f32 2e-5; bf16 2e-2 (the bar of ``tests/test_kernels.py``)
and element by element within one bf16 step (``|diff| <= 2^-7 |plain| +
1e-5``, the bar of ``chip_smoke.py``); the engines' logprobs 1e-4 (f32,
other summation orders), their tier state equal integer for integer.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import plain_versions
from repro_torch.kernels.ref import attention_ref
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
@pytest.mark.parametrize("B,H,KV,Sq,Skv,hd,causal,window,prefix", [
    (2, 8, 1, 512, 512, 256, True, None, 256),   # paligemma's prefix-LM
    (1, 4, 2, 300, 300, 128, True, None, 100),   # prefix off the tile edge
    (1, 4, 1, 300, 300, 64, True, 64, 96),       # prefix inside a window
    (2, 6, 6, 300, 300, 64, False, None, 0),     # encoder, ragged tiles
    (2, 6, 6, 128, 300, 64, False, None, 0),     # cross-attention
    (1, 6, 6, 1500, 1500, 64, False, None, 0),   # whisper's encoder length
    (1, 8, 2, 70, 333, 128, False, None, 0),
    (1, 8, 1, 100, 260, 256, False, None, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefix_and_full_masks(cuda_device, B, H, KV, Sq, Skv, hd,
                                     causal, window, prefix, dtype):
    rng = np.random.default_rng(Sq * 7 + Skv + hd)
    q = _randn(rng, (B, H, Sq, hd), dtype, cuda_device)
    k = _randn(rng, (B, KV, Skv, hd), dtype, cuda_device)
    v = _randn(rng, (B, KV, Skv, hd), dtype, cuda_device)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = fa.flash_attention_launch_count()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_launch_count() == before + 1
    want = attention_ref(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        exc = ((g - w).abs() / (2.0 ** -7 * w.abs() + 1e-5)).max()
        assert float(exc) <= 1, float(exc)
    if prefix:  # the mask matters: plain causal attention differs
        causal_only = attention_ref(q, k, v, causal=True, window=window)
        assert float((causal_only.float() - want.float()).abs().max()) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whisper-tiny", "paligemma-3b",
                                  "mixtral-8x22b"])
def test_engine_kernels_match_plain_on_card(cuda_device, name):
    """Reduced f32 serve of 2 requests (20-token prompts, 8 new tokens,
    tier 1 at 0.4 of the pages) with the kernels, then with the plain
    versions teacher-forced on its tokens."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), param_dtype="float32")
    params = init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    extras = serve.make_extras(cfg, 2, rng, cuda_device)
    kw = dict(new=8, hbm_fraction=0.4, extras=extras)
    serve.reset_launch_counts()
    run = serve.serve(cfg, params, prompts, **kw)
    launches = serve.launch_counts()
    n_attn = cfg.n_layers + cfg.n_enc_layers + cfg.n_layers * cfg.enc_dec
    assert launches["flash_attention"] == n_attn
    assert launches["paged_attention"] == 2 * cfg.n_layers * 7
    forced = torch.as_tensor(run.tokens[:, :-1], device=cuda_device)
    with plain_versions():
        plain = serve.serve(cfg, params, prompts, forced=forced, **kw)
    np.testing.assert_allclose(run.logprobs, plain.logprobs, atol=1e-4)
    for f in ("page_slot", "t2_slot", "lengths", "t1_reads", "t2_reads",
              "evictions"):
        assert torch.equal(getattr(run.state.kv, f),
                           getattr(plain.state.kv, f)), f
