"""The arithmetic of the redesigned attention kernels, emulated on the CPU.

- Flash attention in bf16 on the tensor cores: a plain emulation of the
  kernel's arithmetic (its key tiles, a running max, exp2 with the scale
  folded in, P split into bf16 ``P_hi + P_lo`` before P V, f32
  accumulation, l summed from the unrounded P) against the plain version
  ``attention_ref``, element by element within one bf16 step
  (``|diff| <= 2^-7 |plain| + 1e-5``, the bar of ``chip_smoke.py``); the
  same emulation with P rounded once to bf16 must exceed that bar, so the
  bar is shown to catch it.
- Paged attention split over pages across blocks: ``split_plan`` covers
  every page exactly once, in runs of whole pages, and at the served
  models' shapes gives mistral-nemo-12b at least two blocks an SM and
  recurrentgemma-9b one page a split; the plain version over each split's
  pages, merged in split order by the kernel's formula, equals the plain
  version over all pages within 1e-6 of each field's largest magnitude.

No card and no JAX: the kernels themselves are held against these plain
versions on the card (``tests/test_torch_serving_cuda.py``,
``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import attention_ref, paged_attention_ref

ULP, ABS = 2.0 ** -7, 1e-5  # chip_smoke.FLASH_ULP, FLASH_ABS
NEG = -1e30


def _bf16(rng, shape):
    return torch.as_tensor(rng.normal(size=shape),
                           dtype=torch.float32).to(torch.bfloat16)


def _emulate(q, k, v, *, causal, window, split_p):
    """The bf16 kernel's arithmetic in f32: q ``[B, H, S, hd]``, k/v
    ``[B, KV, Skv, hd]`` bf16 -> ``[B, H, S, hd]`` bf16."""
    B, H, S, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(H // KV, 1)
    vf = v.float().repeat_interleave(H // KV, 1)
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((B, H, S), NEG)
    l = torch.zeros((B, H, S))
    o = torch.zeros((B, H, S, hd))
    qp = torch.arange(S)[:, None]
    tile = 128 if hd <= 128 else 64  # the kernel's keys a tile
    for k0 in range(0, Skv, tile):
        kp = torch.arange(k0, min(k0 + tile, Skv))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + tile])
        s = s * scale_log2
        if causal:
            vis = kp <= qp
            if window is not None:
                vis &= kp > qp - window
            s = torch.where(vis, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == NEG, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + tile]
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        o = o * corr[..., None] + pv
        m = m_new
    return (o / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def _excess(got, want) -> float:
    """Largest ``|got - want| / (2^-7 |want| + 1e-5)``: at most 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (ULP * w.abs() + ABS)).max())


FLASH_CASES = {
    "hd128-gqa4/2-causal": (1, 4, 2, 512, 128, None),
    "hd256-g16-window200": (1, 16, 1, 384, 256, 200),
    "hd80-ragged": (2, 4, 4, 333, 80, None),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_split_p_within_one_bf16_step(case):
    B, H, KV, S, hd, window = FLASH_CASES[case]
    rng = np.random.default_rng(S + hd)
    q, k, v = (_bf16(rng, (B, n, S, hd)) for n in (H, KV, KV))
    want = attention_ref(q, k, v, causal=True, window=window)
    got = _emulate(q, k, v, causal=True, window=window, split_p=True)
    assert _excess(got, want) <= 1


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_single_rounded_p_fails_the_bar(case):
    B, H, KV, S, hd, window = FLASH_CASES[case]
    rng = np.random.default_rng(S + hd)
    q, k, v = (_bf16(rng, (B, n, S, hd)) for n in (H, KV, KV))
    want = attention_ref(q, k, v, causal=True, window=window)
    got = _emulate(q, k, v, causal=True, window=window, split_p=False)
    assert _excess(got, want) > 1


# (B, KV, n_pages, page): mistral-nemo-12b and recurrentgemma-9b as
# served in chip_smoke.py (8 sequences of 27 pages of 128 tokens), and
# the small shapes of the kernel tests.
PLAN_SHAPES = [(8, 8, 27, 128), (8, 1, 27, 128), (2, 2, 6, 8), (1, 8, 4, 16),
               (3, 1, 5, 8), (4, 8, 40, 128), (1, 1, 30, 128), (3, 32, 7, 16),
               (8, 1, 0, 128), (600, 1, 3, 16)]


@pytest.mark.parametrize("B,KV,n_pages,page", PLAN_SHAPES)
def test_split_plan_covers_every_page_once(B, KV, n_pages, page):
    n_split, span = pa.split_plan(B, KV, n_pages, page)
    assert n_split >= 1 and span >= page and span % page == 0
    cover = np.zeros(max(n_pages, 1) * page, np.int64)
    for s in range(n_split):
        cover[s * span:(s + 1) * span] += 1
    assert (cover[:n_pages * page] == 1).all()
    assert n_split == 1 or (n_split - 1) * span < n_pages * page


@pytest.mark.parametrize("B,KV,min_blocks", [
    (8, 8, 2 * 132),   # mistral-nemo-12b: at least two blocks an SM
    # recurrentgemma-9b: one page a split, 216 blocks, the most whole
    # pages give (short of two an SM; sub-page splits ran slower)
    (8, 1, 8 * 27),
])
def test_split_plan_at_full_shapes(B, KV, min_blocks):
    n_split, span = pa.split_plan(B, KV, 27, 128)
    assert B * KV * n_split >= min_blocks
    assert n_split <= 27 and span >= 128


def _split_partials(q, pool, ps, lengths, window, n_split, span):
    """The plain version over each split's pages: the page table with the
    other pages -1."""
    per = span // pool.shape[1]
    parts = []
    for s in range(n_split):
        own = torch.full_like(ps, -1)
        own[:, s * per:(s + 1) * per] = ps[:, s * per:(s + 1) * per]
        parts.append(paged_attention_ref(q, pool, own, lengths, window))
    return parts


def _merge(parts):
    """The kernel's merge, in split order: M = max_s m_s, w_s = exp(m_s -
    M) for a split that saw a token (l_s > 0) and 0 otherwise, acc = sum_s
    w_s acc_s, l = sum_s w_s l_s, m = M."""
    M = torch.stack([p[1] for p in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for a, m_s, l_s in parts:
        w = torch.where(l_s > 0, torch.exp(m_s - M), torch.zeros_like(m_s))
        acc = acc + w[..., None] * a
        l = l + w * l_s
    return acc, M, l


PAGED_CASES = {
    # name: (B, H, KV, hd, page, n_pages, slots, window)
    "mistral-heads": (3, 32, 8, 128, 128, 27, 60, 0),
    "recurrentgemma-window": (3, 16, 1, 256, 128, 27, 60, 300),
    "window-across-splits": (4, 8, 2, 32, 16, 30, 90, 70),
    "small-pages": (3, 4, 1, 16, 8, 5, 16, 0),
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_split_merge_equals_unsplit(case):
    B, H, KV, hd, page, n_pages, slots, window = PAGED_CASES[case]
    rng = np.random.default_rng(len(case))
    pool = torch.as_tensor(rng.normal(size=(slots, page, 2, KV, hd)),
                           dtype=torch.float32)
    q = torch.as_tensor(rng.normal(size=(B, H, hd)), dtype=torch.float32)
    ps = torch.as_tensor(rng.integers(-1, slots, size=(B, n_pages)),
                         dtype=torch.int32)
    lengths = rng.integers(1, page * n_pages, size=(B,))
    ps[0, :] = -1                              # an empty sequence
    lengths[1] = page * (n_pages // 2)         # a length at a page edge
    if B > 3:
        lengths[3] = page * n_pages - 1
    lengths = torch.as_tensor(lengths, dtype=torch.int32)
    n_split, span = pa.split_plan(B, KV, n_pages, page)
    assert n_split > 1
    if window:  # the window starts inside a split, not at its edge
        lo = (lengths[1:] - window).clamp(min=0)
        assert bool((lo % span != 0).any())
        assert bool((lo // span < (lengths[1:] - 1) // span).any())
    want = paged_attention_ref(q, pool, ps, lengths, window)
    got = _merge(_split_partials(q, pool, ps, lengths, window, n_split,
                                 span))
    for g, w in zip(got, want):
        den = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-6 * den
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == np.float32(NEG)).all())
    assert float(got[2][0].abs().max()) == 0.0
