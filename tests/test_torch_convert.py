"""Reference engine state carried into the port (``repro_torch.convert``):
a cold state equals the port's own ``init_store``, and a warm state gives
the same next step as the reference's ``fused_cache_step``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.storage import tiered_store as J
from repro_torch import convert
from repro_torch.kernels import ref as tref
from repro_torch.kernels import threefry
from repro_torch.storage import tiered_store as T


def _leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _assert_tree_equal(got, want, ctx=""):
    if isinstance(got, torch.Tensor):
        w = np.asarray(want)
        g = got.cpu().numpy()
        assert g.shape == w.shape, ctx
        np.testing.assert_array_equal(g, w, err_msg=ctx)
        return
    for f, g, w in zip(got._fields, got, want):
        _assert_tree_equal(g, w, f"{ctx}.{f}")


@pytest.mark.parametrize("seed", [0, 17])
def test_cold_state_equals_port_init_store(seed):
    cfg = dict(n_lines=24, prefetch_buf=8, pred_cap=16)
    got = convert.store_state_from_numpy(
        _leaves(J.init_store(J.StoreConfig(**cfg), seed)), device="cpu")
    want = T.init_store(T.StoreConfig(**cfg), seed)
    _assert_tree_equal(got, want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype


def _warm_reference_state(jc, n=300):
    """A reference state after ``n`` requests (full cache, live rings,
    moved weights, advanced key)."""
    rng = np.random.default_rng(5)
    pages = jnp.asarray(rng.integers(0, 90, n), jnp.int32)
    writes = jnp.asarray(rng.random(n) < 0.4)
    win = jnp.zeros(n, jnp.int32)
    st0 = J.init_store(jc, 3)
    final, _ = jref.cache_scan_ref(
        st0, J._init_accum(1), pages, writes, win, jc.hyper(), None,
        epoch_width=jc.epoch_width, pred_cap=jc.pred_cap,
        prefetch=jc.prefetch, prefetch_width=jc.prefetch_width, n_windows=1)
    return final


@pytest.mark.parametrize("page,is_write", [(7, False), (5000, True)])
def test_warm_state_next_step_matches(page, is_write):
    kw = dict(n_lines=32, prefetch=True, pred_cap=4)
    jc, tc = J.StoreConfig(**kw), T.StoreConfig(**kw)
    jstate = _warm_reference_state(jc)
    assert bool(jnp.all(jstate.cache.valid))
    key, vkey = jax.random.split(jstate.key)
    noise = jax.random.uniform(vkey, (jc.n_lines,))
    jin = jstate._replace(key=key, cache=jref._ScanCache(
        tags=jstate.cache.tags, dirty=jstate.cache.dirty,
        freq=jstate.cache.freq, ts=jstate.cache.ts,
        n_valid=jnp.sum(jstate.cache.valid).astype(jnp.int32)))
    step_kw = dict(epoch_width=jc.epoch_width, pred_cap=jc.pred_cap,
                   prefetch=True, prefetch_width=jc.prefetch_width)
    jnext, jout = jax.jit(
        lambda s, p, w, n: jref.fused_cache_step(s, p, w, n, jc.hyper(),
                                                 **step_kw))(
        jin, jnp.int32(page), jnp.bool_(is_write), noise)

    tstate = T.stack_rows(convert.store_state_from_numpy(
        _leaves(jstate), device="cpu"), 1)
    hyper = convert.store_hyper_from_numpy(
        *(np.asarray(x) for x in jc.hyper()))
    new_key, draw = threefry.split(tuple(tstate.key[0].tolist()))
    tnoise = threefry.uniform_f32(*draw, tc.n_lines)
    c = tstate.cache
    tin = tstate._replace(
        key=torch.tensor([new_key], dtype=torch.int64),
        cache=tref._ScanCache(tags=c.tags, dirty=c.dirty, freq=c.freq,
                              ts=c.ts,
                              n_valid=c.valid.sum(-1, dtype=torch.int32)))
    tnext, tout = tref.fused_cache_step(
        tin, torch.tensor([page]), torch.tensor([is_write]), tnoise[None],
        hyper, **step_kw)
    for k, v in jout.items():
        np.testing.assert_array_equal(tout[k].numpy()[0], np.asarray(v),
                                      err_msg=k)
    _assert_tree_equal(
        type(tnext)(*(jax.tree_util.tree_map(lambda x: x[0], part)
                      for part in tnext)),
        jnext)


def test_rejects_wrong_leaf_count_and_key():
    leaves = _leaves(J.init_store(J.StoreConfig(n_lines=4), 0))
    with pytest.raises(ValueError, match="leaves"):
        convert.store_state_from_numpy(leaves[:-1])
    bad = leaves[:-1] + [np.zeros(2, np.int64)]
    with pytest.raises(ValueError, match="uint32"):
        convert.store_state_from_numpy(bad)
