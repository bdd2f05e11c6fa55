"""The paged KV pool of one page shard against the reference's, on the CPU,
for each mapping policy and each of 4 page shards.

The reference's ``_t2_slot_table(spec, me)``, ``init_paged_kv(spec, me)``,
``prefill_residency`` + ``prefill_write`` and then 14 steps of
``alloc_step(..., me)`` (jitted, as its engine runs it) +
``write_token_kv`` (each layer's token ``100 b + t + li`` as K, its
negation as V), against the port's ``t2_slot_table``, ``init_paged_kv(me=)``,
``alloc_step(..., me)``, ``write_back_evicted``, ``token_index`` and
``write_token_kv``: 3 sequences of 6 pages of 4 tokens, tier 1 at 2
slots, so the shards that own pages evict, write back and read from tier
2. After every step: every integer of the state equal (page table, §III
metadata, learner, PRNG key, read counters), the learner's weights bit
for bit, the pools' owned rows equal, and ``read_pages`` of each layer
equal where the reference's mask is live (the masks equal). A shard that
owns none of a sequence's pages reads none of its tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online_learning as jol
from repro.core.mapping import page_to_shard
from repro.serving import engine as jeng
from repro.serving import kvpool as jkvp
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.core import online_learning as tol
from repro_torch.serving import engine as teng
from repro_torch.serving import kvpool as tkvp

MAPPINGS = ["block", "block_cyclic", "random", "round_robin"]
N_SHARDS = 4
GEOM = dict(b_local=3, n_pages=6, page_size=4, n_kv=1, head_dim=8,
            layers_per_slot=2, hbm_slots=2, n_shards=N_SHARDS,
            dtype="float32")


def _ints(kv, key):
    m, o = kv.meta, kv.ols
    out = dict(tags=m.tags, valid=m.valid, dirty=m.dirty, freq=m.freq,
               ts=m.ts, page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               pred=o.pred, pred_n=o.pred_n, mispred=o.mispred,
               epoch_misses=o.epoch_misses, chosen=o.chosen,
               lengths=kv.lengths, t=kv.t, key=key,
               t2_reads=kv.t2_reads, t1_reads=kv.t1_reads)
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


def _assert_same(jkv, tkv, spec, ctx):
    want = _ints(jkv, jkv.key)
    got = _ints(tkv, torch.tensor(tkv.key))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx}: {k}")
    jw, tw = np.asarray(jkv.ols.weights), tkv.ols.weights.numpy()
    assert np.array_equal(jw.view(np.int32), tw.view(np.int32)), ctx
    owned = int((tkv.t2_slot >= 0).sum())
    np.testing.assert_array_equal(tkv.pool1[:spec.hbm_slots].numpy(),
                                  np.asarray(jkv.pool1)[:spec.hbm_slots],
                                  err_msg=f"{ctx}: pool1")
    np.testing.assert_array_equal(tkv.pool2[:owned].numpy(),
                                  np.asarray(jkv.pool2)[:owned],
                                  err_msg=f"{ctx}: pool2")
    for li in range(spec.layers_per_slot):
        jk, jv, jvalid = jkvp.read_pages((jkv.pool1, jkv.pool2), jkv, spec,
                                         jnp.asarray(li))
        tk, tv, tvalid = tkvp.read_pages((tkv.pool1, tkv.pool2), tkv, spec,
                                         li)
        jvalid = np.asarray(jvalid)
        np.testing.assert_array_equal(tvalid.numpy(), jvalid,
                                      err_msg=f"{ctx}: valid {li}")
        for t_, j_ in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(t_.numpy()[jvalid],
                                          np.asarray(j_)[jvalid],
                                          err_msg=f"{ctx}: read {li}")
        own_seq = (tkv.t2_slot >= 0).any(1).numpy()
        assert not tvalid.numpy()[~own_seq].any(), ctx


def _t2_slots(mapping):
    """Room for the most pages a shard owns (the reference's ``ceil(total /
    n) + 1`` falls short of block-cyclic's 8 of 18 here: fault (m))."""
    total = GEOM["b_local"] * GEOM["n_pages"]
    load = np.bincount(np.asarray(page_to_shard(
        np.arange(total), N_SHARDS, total, mapping)), minlength=N_SHARDS)
    return max(-(-total // N_SHARDS) + 1, int(load.max())) + 1


@pytest.mark.parametrize("me", range(N_SHARDS))
@pytest.mark.parametrize("mapping", MAPPINGS)
def test_page_shard_matches_reference(mapping, me):
    jspec = jkvp.KVSpec(**GEOM, t2_slots=_t2_slots(mapping), mapping=mapping)
    tspec = tkvp.KVSpec(**GEOM, t2_slots=_t2_slots(mapping), mapping=mapping)
    jme = jnp.asarray(me, jnp.int32)
    np.testing.assert_array_equal(
        tkvp.t2_slot_table(tspec, me).numpy(),
        np.asarray(jkvp._t2_slot_table(jspec, jme)))
    jkv = jkvp.init_paged_kv(jspec, jme, seed=me)
    tkv = tkvp.init_paged_kv(tspec, seed=me, device="cpu", me=me)

    # Prefill: 2 pages a sequence, the newest owned pages resident.
    S, B, L = 8, GEOM["b_local"], GEOM["layers_per_slot"]
    lens = np.full((B,), S, np.int32)
    jkv = jkvp.prefill_residency(jkv, jspec, jnp.asarray(lens))
    tkv = tkvp.prefill_residency(tkv, tspec, torch.as_tensor(lens))
    rng = np.random.default_rng(10 * me + MAPPINGS.index(mapping))
    jpools = (jkv.pool1, jkv.pool2)
    tpools = (tkv.pool1, tkv.pool2)
    for li in range(L):
        k = rng.normal(size=(B, S, 1, 8)).astype(np.float32)
        jpools = jkvp.prefill_write(jpools, jkv, jspec, jnp.asarray(li),
                                    jnp.asarray(k), jnp.asarray(-k))
        tkvp.prefill_write(tpools, tkv, tspec, li, torch.as_tensor(k),
                           torch.as_tensor(-k))
    jkv = jkv._replace(pool1=jpools[0], pool2=jpools[1])
    _assert_same(jkv, tkv, jspec, f"{mapping} me={me} prefill")

    pw = tol.pow_table(0.7, 4 * tspec.total_pages)
    j_alloc = jax.jit(lambda kv: jkvp.alloc_step(kv, jspec, jme,
                                                 jol.OLConfig()))
    for t in range(14):
        jkv, jplan = j_alloc(jkv)
        tkv, tplan = tkvp.alloc_step(tkv, tspec, tol.OLConfig(), pw, me)
        np.testing.assert_array_equal(tplan.write_here.numpy(),
                                      np.asarray(jplan.write_here))
        tkvp.write_back_evicted((tkv.pool1, tkv.pool2), tplan)
        index = tkvp.token_index(tplan, tkv.lengths, tspec, "cpu")
        jpools = (jkv.pool1, jkv.pool2)
        for li in range(L):
            val = (100 * np.arange(B)[:, None, None] + t + li) * np.ones(
                (B, 1, 8), np.float32)
            jpools = jkvp.write_token_kv(
                jpools, jplan, (jnp.asarray(val), jnp.asarray(-val)),
                jkv.lengths, jspec, jnp.asarray(li))
            tkvp.write_token_kv(tkv.pool1, (torch.as_tensor(val),
                                            torch.as_tensor(-val)), index, li)
        jkv = jkv._replace(pool1=jpools[0], pool2=jpools[1],
                           lengths=jkv.lengths + 1, t=jkv.t + 1)
        tkv = tkv._replace(lengths=tkv.lengths + 1, t=tkv.t + 1)
        _assert_same(jkv, tkv, jspec, f"{mapping} me={me} step {t}")
    if int((tkv.t2_slot >= 0).sum()) > GEOM["hbm_slots"]:
        assert int(tkv.evictions[0]) > 0 and int(tkv.t2_reads[0]) > 0


def test_fault_m_reference_owned_slots_fall_short():
    """Fault (m): the reference sizes a page shard's tier 2 at ``ceil(total
    / n_shards) + 2`` slots, but block-cyclic mapping (blocks of 8) gives
    shards 0 and 1 eight of 18 pages each, so their slot tables number
    pages past the pool, whose scatters JAX drops. The port's
    ``make_kv_spec`` keeps the reference's tier 1 and sizes tier 2 to the
    most pages a shard owns."""
    spec = jkvp.KVSpec(**GEOM, t2_slots=-(-18 // N_SHARDS) + 2,
                       mapping="block_cyclic")
    tbl = np.asarray(jkvp._t2_slot_table(spec, jnp.asarray(0, jnp.int32)))
    assert tbl.max() >= spec.t2_slots
    cfg = dataclasses.replace(T_ARCHS["stablelm-3b"].reduced(),
                              page_size=4)
    sc = teng.ServeConfig(max_seq=24, batch_local=3, page_axes=("model",),
                          hbm_fraction=0.4)
    tspec = teng.make_kv_spec(cfg, sc, N_SHARDS)
    jsc = jeng.ServeConfig(max_seq=24, batch_local=3, page_axes=("model",),
                           hbm_fraction=0.4)
    jspec = jeng.make_kv_spec(cfg, jsc, N_SHARDS)
    assert tspec.hbm_slots == jspec.hbm_slots
    assert jspec.t2_slots == 7 and tspec.t2_slots == 9
    for me in range(N_SHARDS):
        assert int(tkvp.t2_slot_table(tspec, me).max()) < tspec.t2_slots
