"""The serving kernels' plain versions on the CPU against the reference.

- ``attention_ref``, ``paged_attention_ref`` and ``page_copy_ref`` against
  ``repro.kernels.ref`` and against the Pallas kernels in interpret mode
  (``repro.kernels.ops.*(interpret=True)``), at the parameter grids and
  tolerances of ``tests/test_kernels.py``: 2e-5 (f32) and 2e-2 (bf16) for
  flash attention, 3e-5 for paged attention, exact for the copy;
- the wrappers' CPU dispatch (the plain version), and the layouts the
  serving engine passes: the model's ``[B, S, H, hd]`` as transposed views,
  one layer of a ``[slots, layers, page, 2, KV, hd]`` pool as a strided
  view;
- the engine's two-tier decode read (tier 1 over the resident pages, tier
  2 over the rest, merged with ``combine_partials``) against the
  reference's single pass (``read_pages`` + ``attention_partial``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.axes import SINGLE
from repro.kernels import ops, ref
from repro.models import attention as jattn
from repro.serving import kvpool as jkvp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import page_gather as tpg
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype="float32"):
    """numpy f32 -> torch tensor of ``dtype`` (bf16 rounded as JAX does:
    to nearest even)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(_DT[dtype])


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, 4, 2, 128, 32, True, None),
    (1, 4, 1, 256, 16, True, 64),
    (2, 2, 2, 128, 32, False, None),
    (1, 8, 8, 128, 64, True, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain(B, H, KV, S, hd, causal, window, dtype, rng):
    q = rng.normal(size=(B, H, S, hd))
    k = rng.normal(size=(B, KV, S, hd))
    v = rng.normal(size=(B, KV, S, hd))
    jd = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = np.asarray(ref.attention_ref(jq, jk, jv, causal=causal,
                                        window=window), np.float32)
    pallas = np.asarray(ops.flash_attention(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_kv=64,
        interpret=True), np.float32)
    tq, tk, tv = (_t(x, dtype) for x in (q, k, v))
    got = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == _DT[dtype]
    tol = 2e-5 if dtype == "float32" else 2e-2
    for other in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(), other, atol=tol,
                                   rtol=tol)
    # The wrapper on CPU tensors is the plain version; the model's layout
    # goes in as transposed views and comes back with q's strides.
    disp = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(disp, got)
    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (tq, tk, tv))
    om = tfa.flash_attention(qm.transpose(1, 2), km.transpose(1, 2),
                             vm.transpose(1, 2), causal=causal, window=window)
    assert torch.equal(om, got)
    assert tfa.flash_attention_launch_count() == 0


def test_blockwise_attention_matches_reference(rng):
    """The port's blockwise attention (the full forward's) against the
    reference's, ragged blocks and a window included."""
    q = rng.normal(size=(2, 100, 4, 16))
    k = rng.normal(size=(2, 100, 2, 16))
    v = rng.normal(size=(2, 100, 2, 16))
    for window in (None, 24):
        want = jattn.blockwise_attention(
            *(jnp.asarray(x, jnp.float32) for x in (q, k, v)), causal=True,
            window=window, block_q=32, block_kv=32)
        got = tattn.blockwise_attention(*(_t(x) for x in (q, k, v)),
                                        causal=True, window=window,
                                        block_q=32, block_kv=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def _paged_inputs(rng, B, H, KV, hd, page, n_pages, slots):
    q = rng.normal(size=(B, H, hd))
    pool = rng.normal(size=(slots, page, 2, KV, hd))
    ps = rng.integers(-1, slots, size=(B, n_pages)).astype(np.int32)
    lengths = rng.integers(1, page * n_pages, size=(B,)).astype(np.int32)
    return q, pool, ps, lengths


@pytest.mark.parametrize("B,H,KV,hd,page,n_pages,slots", [
    (2, 4, 2, 16, 8, 6, 8),
    (1, 8, 8, 32, 16, 4, 4),
    (3, 4, 1, 16, 8, 5, 16),
])
def test_paged_attention_plain(B, H, KV, hd, page, n_pages, slots, rng):
    q, pool, ps, lengths = _paged_inputs(rng, B, H, KV, hd, page, n_pages,
                                         slots)
    ps[0, :] = -1  # a row with every token masked
    jargs = (jnp.asarray(q, jnp.float32), jnp.asarray(pool, jnp.float32),
             jnp.asarray(ps), jnp.asarray(lengths))
    racc, rm, rl = (np.asarray(x) for x in ref.paged_attention_ref(*jargs))
    pacc, pm_, pl_ = (np.asarray(x)
                      for x in ops.paged_attention(*jargs, interpret=True))
    targs = (_t(q), _t(pool), torch.as_tensor(ps), torch.as_tensor(lengths))
    acc, m, l = tref.paged_attention_ref(*targs)
    for want_acc, want_m, want_l in ((racc, rm, rl), (pacc, pm_, pl_)):
        np.testing.assert_allclose(acc.numpy(), want_acc.reshape(B, H, hd),
                                   atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(l.numpy(), want_l.reshape(B, H),
                                   atol=3e-5, rtol=3e-5)
        np.testing.assert_allclose(m.numpy(), want_m.reshape(B, H),
                                   atol=3e-5, rtol=3e-5)
    assert float(l[0].abs().max()) == 0.0
    assert bool((m[0] == np.float32(-1e30)).all())
    disp = tpa.paged_attention(*targs)
    assert all(torch.equal(a, b) for a, b in zip(disp, (acc, m, l)))
    assert tpa.paged_attention_launch_count() == 0


def test_paged_attention_reads_one_layer_of_a_pool(rng):
    """One layer of a ``[slots, layers, page, 2, KV, hd]`` pool, passed as
    the strided view ``pool[:, li]``, gives what the layer's contiguous
    copy gives, bit for bit."""
    B, H, KV, hd, page, n_pages, slots, layers = 2, 4, 2, 16, 8, 5, 7, 3
    q, _, ps, lengths = _paged_inputs(rng, B, H, KV, hd, page, n_pages, slots)
    pool6 = _t(rng.normal(size=(slots, layers, page, 2, KV, hd)))
    for li in range(layers):
        view = pool6[:, li]
        assert not view.is_contiguous() and view[0].is_contiguous()
        a = tpa.paged_attention(_t(q), view, torch.as_tensor(ps),
                                torch.as_tensor(lengths))
        b = tpa.paged_attention(_t(q), view.contiguous(), torch.as_tensor(ps),
                                torch.as_tensor(lengths))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("Sd,Ss,R,C,N", [(6, 9, 4, 32, 5), (3, 3, 8, 16, 2)])
def test_page_copy_plain(Sd, Ss, R, C, N, rng):
    dst = rng.normal(size=(Sd, R, C)).astype(np.float32)
    src = rng.normal(size=(Ss, R, C)).astype(np.float32)
    di = rng.integers(-1, Sd, size=(N,)).astype(np.int32)
    si = rng.integers(-1, Ss, size=(N,)).astype(np.int32)
    seen = set()
    for i in range(N):  # unique dst rows (copy order is unspecified)
        if di[i] in seen:
            di[i] = -1
        seen.add(di[i])
    jargs = (jnp.asarray(dst), jnp.asarray(src), jnp.asarray(di),
             jnp.asarray(si))
    want = np.asarray(ref.page_copy_ref(*jargs))
    pallas = np.asarray(ops.page_copy(*jargs, interpret=True))
    got = tref.page_copy_ref(torch.as_tensor(dst.copy()), torch.as_tensor(src),
                             torch.as_tensor(di), torch.as_tensor(si))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    disp = tpg.page_copy(torch.as_tensor(dst.copy()), torch.as_tensor(src),
                         torch.as_tensor(di), torch.as_tensor(si))
    assert torch.equal(disp, got)
    assert tpg.page_copy_launch_count() == 0


def test_page_copy_into_one_layer_of_a_pool(rng):
    """Prefill population: rows of one layer's page into ``pool[:, li]``
    (the other layers untouched); write-back: whole slots."""
    slots, layers, R, C = 5, 3, 4, 8
    pool = torch.as_tensor(rng.normal(size=(slots, layers, R, C)),
                           dtype=torch.float32)
    before = pool.clone()
    data = torch.as_tensor(rng.normal(size=(4, R, C)), dtype=torch.float32)
    di = torch.tensor([3, -1, 0, 4], dtype=torch.int32)
    si = torch.arange(4, dtype=torch.int32)
    tpg.page_copy(pool[:, 1], data, di, si)
    want = before.clone()
    for d, s in ((3, 0), (0, 2), (4, 3)):
        want[d, 1] = data[s]
    assert torch.equal(pool, want)
    other = torch.zeros_like(pool)
    tpg.page_copy(other, pool, torch.tensor([2, 0], dtype=torch.int32),
                  torch.tensor([4, 3], dtype=torch.int32))
    assert torch.equal(other[2], pool[4]) and torch.equal(other[0], pool[3])
    assert not other[1].any()
    with pytest.raises(IndexError):
        tpg.page_copy(other, pool, torch.tensor([5], dtype=torch.int32),
                      torch.tensor([0], dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_tier_split_matches_single_pass(seed):
    """The engine's decode read: the plain paged attention over tier 1
    (``page_slot``) and over tier 2 (the pages not resident, at their
    tier-2 slots), both counting ``lengths + 1`` tokens,
    merged by ``combine_partials``, against the reference's ``read_pages``
    + ``attention_partial`` + ``combine_partials`` on the same pools."""
    rng = np.random.default_rng(seed)
    B, H, KV, hd, page, NP, layers, hbm = 3, 8, 2, 16, 8, 6, 2, 7
    spec = jkvp.KVSpec(b_local=B, n_pages=NP, page_size=page, n_kv=KV,
                       head_dim=hd, layers_per_slot=layers, hbm_slots=hbm,
                       t2_slots=B * NP + 2, n_shards=1, dtype="float32")
    pool1 = rng.normal(size=(hbm + 1, layers, page, 2, KV, hd))
    pool2 = rng.normal(size=(B * NP + 2, layers, page, 2, KV, hd))
    lengths = rng.integers(0, NP * page - 1, size=(B,)).astype(np.int32)
    lengths[0] = 0  # a sequence whose only live token is the new one
    page_slot = np.full((B, NP), -1, np.int32)
    flat = rng.permutation(B * NP)[:hbm]
    page_slot.reshape(-1)[flat] = np.arange(hbm, dtype=np.int32)
    t2_slot = np.arange(B * NP, dtype=np.int32).reshape(B, NP)
    q = rng.normal(size=(B, H, hd))
    jkv = jkvp.init_paged_kv(spec, jnp.zeros((), jnp.int32))._replace(
        page_slot=jnp.asarray(page_slot), t2_slot=jnp.asarray(t2_slot),
        lengths=jnp.asarray(lengths))
    jpools = (jnp.asarray(pool1, jnp.float32), jnp.asarray(pool2, jnp.float32))
    slot1 = torch.as_tensor(page_slot)
    slot2 = torch.as_tensor(np.where(page_slot < 0, t2_slot, -1))
    live = torch.as_tensor(lengths + 1)
    p1, p2 = _t(pool1), _t(pool2)
    for li in range(layers):
        k, v, valid = jkvp.read_pages(jpools, jkv, spec, jnp.asarray(li))
        part = jattn.attention_partial(jnp.asarray(q, jnp.float32), k, v,
                                       valid)
        want = np.asarray(jattn.combine_partials(part, SINGLE, ()))
        parts = [tattn.Partial(*tpa.paged_attention(_t(q), pool[:, li], s,
                                                    live))
                 for pool, s in ((p1, slot1), (p2, slot2))]
        got = tattn.combine_partials(parts)
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)
        # The port's plain single pass agrees too.
        tk, tv, tvalid = (torch.as_tensor(np.asarray(x)) for x in (k, v, valid))
        one = tattn.combine_partials([tattn.attention_partial(
            _t(q), tk, tv, tvalid)]).reshape(B, H, hd)
        np.testing.assert_allclose(one.numpy(), want, atol=3e-5, rtol=3e-5)
