"""The port's paged two-tier serving on the CPU against ``repro.serving``.

Reduced mistral-nemo-12b, stablelm-3b, mamba2-370m (SSD blocks, no KV
pools) and recurrentgemma-9b (RG-LRU blocks and sliding-window attention
with windowed reads) in f32, with the reference's parameters carried over
by ``params_from_numpy``:

- prefill + teacher-forced decode against the reference engine: every
  integer of ``PagedKV`` equal after every step (the page table, the
  §III metadata, the OL learner, the PRNG key, the read counters), the f32
  OL weights bit for bit, the tokens equal, the logprobs within 1e-5, the
  pools within 1e-5 (f32 products summed in another order) with the
  scratch rows left out: the reference scatters masked prefill writes to
  them, the port skips those writes; the recurrent layers' decode states
  within 1e-5 (f32, the scans summed in another order: the reference's
  associative scans against the port's sequential and chunked ones);
- a longer run with evictions, write-backs, tier-2 reads and epochs of the
  learner, from the default weights and from weights that pick the Random
  expert;
- the port's decode against its own ``fwd_hidden`` within 2e-4 (the
  reference's own bar, ``tests/test_serving.py``);
- ``promote_pages`` on a hand-made state with a free slot;
- the one-launch whole-slot write-back against the reference's per-layer
  write-back, pools equal bit for bit over 48 steps with evictions;
- the inclusion invariant of ``tests/test_serving.py``;
- page sharding accepted by the steps, and ``build_train_step`` without
  a mesh refused; and int8 KV pools served (their parity with the reference is
  ``tests/test_torch_int8_kv.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.core import online_learning as jol
from repro.distributed.axes import SINGLE
from repro.models import params as jpm
from repro.serving import engine as jeng
from repro.serving import kvpool as jkvp
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.core import online_learning as tol
from repro_torch.launch import serve as tserve
from repro_torch.launch import spmd as tspmd
from repro_torch.models.layers import unembed_greedy
from repro_torch.models.transformer import fwd_hidden
from repro_torch.serving import engine as teng
from repro_torch.serving import kvpool as tkvp

ARCHS = ["mistral-nemo-12b", "stablelm-3b", "mamba2-370m",
         "recurrentgemma-9b"]
# The evicting runs need KV pools: mamba2 has none.
KV_ARCHS = ["mistral-nemo-12b", "stablelm-3b", "recurrentgemma-9b"]


def _cfgs(name):
    return tuple(dataclasses.replace(A[name].reduced(), param_dtype="float32")
                 for A in (J_ARCHS, T_ARCHS))


def _params(jcfg):
    jp = jpm.init_params(jcfg, jax.random.PRNGKey(1))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _ints_ref(kv):
    m, o = kv.meta, kv.ols
    out = dict(tags=m.tags, valid=m.valid, dirty=m.dirty, freq=m.freq,
               ts=m.ts, page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               pred=o.pred, pred_n=o.pred_n, mispred=o.mispred,
               epoch_misses=o.epoch_misses, chosen=o.chosen,
               lengths=kv.lengths, t=kv.t, key=kv.key,
               t2_reads=kv.t2_reads, t1_reads=kv.t1_reads)
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


def _ints_port(kv):
    m, o = kv.meta, kv.ols
    out = dict(tags=m.tags, valid=m.valid, dirty=m.dirty, freq=m.freq,
               ts=m.ts, page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               pred=o.pred, pred_n=o.pred_n, mispred=o.mispred,
               epoch_misses=o.epoch_misses, chosen=o.chosen,
               lengths=kv.lengths, t=kv.t, key=torch.tensor(kv.key),
               t2_reads=kv.t2_reads, t1_reads=kv.t1_reads)
    return {k: v.numpy().astype(np.int64) for k, v in out.items()}


def _assert_state(jkv, tkv, spec, ctx):
    want, got = _ints_ref(jkv), _ints_port(tkv)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx}: {k}")
    jw = np.asarray(jkv.ols.weights)
    tw = tkv.ols.weights.numpy()
    assert np.array_equal(jw.view(np.int32), tw.view(np.int32)), (
        ctx, jw, tw)
    for name, rows in (("pool1", spec.hbm_slots), ("pool2", spec.t2_slots - 1)):
        np.testing.assert_allclose(
            getattr(tkv, name)[:rows].numpy(),
            np.asarray(getattr(jkv, name))[:rows], atol=1e-5, rtol=1e-5,
            err_msg=f"{ctx}: {name}")


def _assert_rec(jstate, tstate, ctx):
    """The recurrent layers' states, leaf by leaf, within 1e-5."""
    for jr, tr in ((jstate.rec, tstate.rec), (jstate.rec_tail,
                                              tstate.rec_tail)):
        assert len(jr) == len(tr), ctx
        for jd, td in zip(jr, tr):
            assert sorted(jd) == sorted(td), ctx
            for k in jd:
                np.testing.assert_allclose(
                    td[k].float().numpy(), np.asarray(jd[k], np.float32),
                    atol=1e-5, rtol=1e-5, err_msg=f"{ctx}: rec {k}")


def _run_both(name, rng, *, B, S0, n_dec, max_seq, hbm_fraction,
              weights=None, promote_every=0):
    """Prefill + ``n_dec`` teacher-forced decode steps in both engines,
    holding the state after every step; returns the port's logprobs and
    the fed tokens."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    toks = rng.integers(0, jcfg.vocab, (B, S0 + n_dec)).astype(np.int32)
    jsc = jeng.ServeConfig(max_seq=max_seq, batch_local=B, page_axes=(),
                           hbm_fraction=hbm_fraction)
    tsc = teng.ServeConfig(max_seq=max_seq, batch_local=B,
                           hbm_fraction=hbm_fraction)
    spec, jspec = teng.make_kv_spec(tcfg, tsc), jeng.make_kv_spec(jcfg, jsc, 1)
    for f in dataclasses.fields(tkvp.KVSpec):
        assert getattr(spec, f.name) == getattr(jspec, f.name), f.name
    ms = jpm.MeshSizes()
    jpre = jax.jit(jeng.make_prefill_step(jcfg, jsc, SINGLE, ms))
    jdec = jax.jit(jeng.make_decode_step(jcfg, jsc, SINGLE, ms))
    jprom = jax.jit(lambda kv: jkvp.promote_pages(kv, jspec, jsc.n_promote))
    tpre = teng.make_prefill_step(tcfg, tsc)
    tdec = teng.make_decode_step(tcfg, tsc)

    jstate, (jt, jl) = jpre(jp, jnp.asarray(toks[:, :S0]))
    tstate, (tt, tl) = tpre(tp, torch.as_tensor(toks[:, :S0]))
    assert (tstate.kv is None) == (jstate.kv is None)
    if weights is not None:
        w = np.asarray(weights, np.float32)
        jstate = jstate._replace(kv=jstate.kv._replace(
            ols=jstate.kv.ols._replace(weights=jnp.asarray(w))))
        tstate = tstate._replace(kv=tstate.kv._replace(
            ols=tstate.kv.ols._replace(weights=torch.as_tensor(w))))
    lps = []
    for step in range(n_dec + 1):
        ctx = f"{name} step {step}"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0, err_msg=ctx)
        if tstate.kv is not None:
            _assert_state(jstate.kv, tstate.kv, spec, ctx)
        _assert_rec(jstate, tstate, ctx)
        lps.append(tl.numpy())
        if step == n_dec:
            break
        x = toks[:, S0 + step]
        jstate, (jt, jl) = jdec(jp, jstate, jnp.asarray(x))
        tstate, (tt, tl) = tdec(tp, tstate, torch.as_tensor(x))
        if promote_every and step % promote_every == promote_every - 1:
            jstate = jstate._replace(kv=jprom(jstate.kv))
            tstate = tstate._replace(kv=tkvp.promote_pages(
                tstate.kv, spec, tsc.n_promote))
    return tcfg, tp, toks, np.stack(lps, 1), tstate.kv


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name, rng):
    """The ISSUE's shape of ``tests/test_serving.py``: 2 sequences, a
    16-token prompt, 12 decode steps, tier 1 at 0.6 of the pages."""
    tcfg, tp, toks, lps, _ = _run_both(name, rng, B=2, S0=16, n_dec=12,
                                       max_seq=64, hbm_fraction=0.6)
    # The port's decode against its own full forward.
    x, _, _ = fwd_hidden(tp, torch.as_tensor(toks), tcfg)
    ue = tp["unembed"] if "unembed" in tp else tp["embed"]
    for j, t in enumerate(range(15, 28)):
        _, rlp = unembed_greedy(x[:, t], ue)
        assert np.abs(lps[:, j] - rlp.numpy()).max() < 2e-4, (name, j)


@pytest.mark.parametrize("weights", [None, [0.2, 0.2, 0.6]],
                         ids=["default", "random-expert"])
@pytest.mark.parametrize("name", KV_ARCHS)
def test_evicting_run_matches_reference(name, weights, rng):
    """3 sequences, 2-page prompts, 56 decode steps over 6 pages each with 7
    tier-1 slots: evictions at four page boundaries, dirty write-backs,
    tier-2 reads every step, 14 learner epochs, promotion every 4 steps.
    For recurrentgemma the 32-token window then leaves the oldest pages
    outside the 3-page read window."""
    *_, kv = _run_both(name, rng, B=3, S0=32, n_dec=56, max_seq=96,
                       hbm_fraction=0.4, weights=weights, promote_every=4)
    assert int(kv.evictions[0]) > 0 and int(kv.writebacks[0]) > 0
    assert int(kv.t2_reads[0]) > 0


def test_decode_from_empty_state_matches_reference(rng):
    """Decode without a prefill, from ``init_decode_state`` (the
    reference's ``test_ol_eviction_stats_accumulate``): 2 sequences, 48
    steps, tier 1 at 0.4 of the pages — allocation from free slots, then
    evictions, tier-2 reads and 12 learner epochs, the state after every
    step equal to the reference's."""
    jcfg, tcfg = _cfgs("stablelm-3b")
    jp, tp = _params(jcfg)
    jsc = jeng.ServeConfig(max_seq=64, batch_local=2, page_axes=(),
                           hbm_fraction=0.4)
    tsc = teng.ServeConfig(max_seq=64, batch_local=2, hbm_fraction=0.4)
    spec = teng.make_kv_spec(tcfg, tsc)
    ms = jpm.MeshSizes()
    jstate = jeng.init_decode_state(jcfg, jsc, SINGLE, ms)
    tstate = teng.init_decode_state(tcfg, tsc, device="cpu")
    jdec = jax.jit(jeng.make_decode_step(jcfg, jsc, SINGLE, ms))
    tdec = teng.make_decode_step(tcfg, tsc)
    toks = rng.integers(0, jcfg.vocab, (2, 48)).astype(np.int32)
    for t in range(48):
        jstate, (jt, jl) = jdec(jp, jstate, jnp.asarray(toks[:, t]))
        tstate, (tt, tl) = tdec(tp, tstate, torch.as_tensor(toks[:, t]))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0)
        _assert_state(jstate.kv, tstate.kv, spec, f"empty-state step {t}")
    kv = tstate.kv
    assert int(kv.t2_reads[0]) > 0 and int(kv.t1_reads[0]) > 0
    assert int(kv.evictions[0]) > 0


@pytest.mark.parametrize("name", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_decode_from_empty_state_matches_reference(name, rng):
    """Decode without a prefill, from ``init_decode_state``: the zero
    recurrent states (and, for recurrentgemma, empty pools with windowed
    reads) of the reference's layout, 40 steps, tokens, logprobs, states
    and tier state held after every step."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    jsc = jeng.ServeConfig(max_seq=64, batch_local=2, page_axes=(),
                           hbm_fraction=0.4)
    tsc = teng.ServeConfig(max_seq=64, batch_local=2, hbm_fraction=0.4)
    spec = teng.make_kv_spec(tcfg, tsc)
    ms = jpm.MeshSizes()
    jstate = jeng.init_decode_state(jcfg, jsc, SINGLE, ms)
    tstate = teng.init_decode_state(tcfg, tsc, device="cpu")
    _assert_rec(jstate, tstate, f"{name} empty state")
    jdec = jax.jit(jeng.make_decode_step(jcfg, jsc, SINGLE, ms))
    tdec = teng.make_decode_step(tcfg, tsc)
    toks = rng.integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    for t in range(40):
        jstate, (jt, jl) = jdec(jp, jstate, jnp.asarray(toks[:, t]))
        tstate, (tt, tl) = tdec(tp, tstate, torch.as_tensor(toks[:, t]))
        ctx = f"{name} empty-state step {t}"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=0, err_msg=ctx)
        _assert_rec(jstate, tstate, ctx)
        if tstate.kv is not None:
            _assert_state(jstate.kv, tstate.kv, spec, ctx)


def _spec_pair(hbm_fraction=0.4):
    jcfg, tcfg = _cfgs("stablelm-3b")
    jsc = jeng.ServeConfig(max_seq=64, batch_local=2, page_axes=(),
                           hbm_fraction=hbm_fraction)
    tsc = teng.ServeConfig(max_seq=64, batch_local=2,
                           hbm_fraction=hbm_fraction)
    return jeng.make_kv_spec(jcfg, jsc, 1), teng.make_kv_spec(tcfg, tsc)


def test_promote_pages_matches_reference(rng):
    """A prefilled state with page (0, 3) dropped from tier 1 and its slot
    freed: both promote the first readable non-resident page, (0, 0), into
    that slot, with the same bytes."""
    jspec, tspec = _spec_pair()
    jkv = jkvp.init_paged_kv(jspec, jnp.zeros((), jnp.int32))
    tkv = tkvp.init_paged_kv(tspec, device="cpu")
    jkv = jkvp.prefill_residency(jkv, jspec, jnp.full((2,), 64, jnp.int32))
    tkv = tkvp.prefill_residency(tkv, tspec, torch.full((2,), 64))
    pool2 = rng.normal(size=jkv.pool2.shape).astype(np.float32)
    jkv = jkv._replace(pool2=jnp.asarray(pool2, jkv.pool2.dtype))
    tkv = tkv._replace(pool2=torch.as_tensor(pool2).to(tkv.pool2.dtype))
    slot = int(np.asarray(jkv.page_slot)[0, 3])
    jkv = jkv._replace(
        meta=jkv.meta._replace(valid=jkv.meta.valid.at[slot].set(False)),
        page_slot=jkv.page_slot.at[0, 3].set(-1))
    tkv.meta.valid[slot] = False
    tkv.page_slot[0, 3] = -1
    jkv2 = jkvp.promote_pages(jkv, jspec, n_promote=2)
    tkv2 = tkvp.promote_pages(tkv, tspec, n_promote=2)
    assert int(tkv2.page_slot[0, 0]) == slot
    _assert_state(jkv2, tkv2, tspec, "promote")
    np.testing.assert_array_equal(
        tkv2.pool1[:tspec.hbm_slots].float().numpy(),
        np.asarray(jkv2.pool1, np.float32)[:tspec.hbm_slots])


def _write_path(kvmod, kv, spec, steps, one_launch):
    """``steps`` decode write paths: allocation, then every layer's token
    (value ``t + li``, its negation as V); returns the final kv."""
    pw = tol.pow_table(0.7, 4 * spec.total_pages)
    # The reference's allocation jitted, as its engine runs it (faults item
    # (f): run op by op, its weight update rounds otherwise).
    j_alloc = jax.jit(lambda kv: kvmod.alloc_step(
        kv, spec, jnp.zeros((), jnp.int32), jol.OLConfig()))
    for t in range(steps):
        if one_launch:
            kv, plan = kvmod.alloc_step(kv, spec, tol.OLConfig(), pw)
            kvmod.write_back_evicted((kv.pool1, kv.pool2), plan)
            index = kvmod.token_index(plan, kv.lengths, spec, "cpu")
        else:
            kv, plan = j_alloc(kv)
            pools = (kv.pool1, kv.pool2)
        for li in range(spec.layers_per_slot):
            val = float(t + li)
            if one_launch:
                k = torch.full((2, spec.n_kv, spec.head_dim), val)
                kvmod.write_token_kv(kv.pool1, (k, -k), index, li)
            else:
                k = jnp.full((2, spec.n_kv, spec.head_dim), val, jnp.float32)
                pools = kvmod.write_token_kv(pools, plan, (k, -k), kv.lengths,
                                             spec, jnp.asarray(li))
        if not one_launch:
            kv = kv._replace(pool1=pools[0], pool2=pools[1])
        kv = kv._replace(lengths=kv.lengths + 1, t=kv.t + 1)
    return kv


@pytest.mark.parametrize("hbm_fraction", [0.25, 0.4])
def test_one_launch_write_back_and_inclusion(hbm_fraction):
    """The port writes dirty evicted pages back whole, once a step, before
    the layer loop; the reference writes them back layer by layer inside
    it. Over 48 steps with evictions the pools agree bit for bit, and
    every token written is read back through the two-tier read path (the
    inclusion invariant of ``tests/test_serving.py``), with tier 1 at a
    quarter and at two fifths of the pages."""
    jspec, tspec = _spec_pair(hbm_fraction)
    jkv = _write_path(jkvp, jkvp.init_paged_kv(jspec, jnp.zeros((), jnp.int32)),
                      jspec, 48, one_launch=False)
    tkv = _write_path(tkvp, tkvp.init_paged_kv(tspec, device="cpu"), tspec, 48,
                      one_launch=True)
    assert int(tkv.writebacks[0]) > 0
    _assert_state(jkv, tkv, tspec, "write path")
    for name, rows in (("pool1", tspec.hbm_slots),
                       ("pool2", tspec.t2_slots - 1)):
        np.testing.assert_array_equal(getattr(tkv, name)[:rows].numpy(),
                                      np.asarray(getattr(jkv, name))[:rows])
    k, _, valid = tkvp.read_pages((tkv.pool1, tkv.pool2), tkv, tspec, 0)
    for b in range(2):
        for t in range(48):
            assert bool(valid[b, t]), (b, t)
            assert float(k[b, t, 0, 0]) == float(t), (b, t)


@pytest.mark.parametrize("name,over,match", [
    ("mamba2-370m", {"page_axes": ("model",)}, "several cards"),
    ("stablelm-3b", {"page_axes": ("model",)}, "several cards"),
])
def test_unsupported_raises(name, over, match):
    """Page sharding is served now: the steps build with ``page_axes``
    (one page shard outside a mesh, as the reference's ``SINGLE``). So is
    training sharded over several cards (``tests/test_torch_sharded_
    train.py``): ``build_train_step`` without a mesh raises, naming the
    one-card step instead."""
    cfg = T_ARCHS[name].reduced()
    sc = teng.ServeConfig(max_seq=64, batch_local=2, **over)
    teng.make_decode_step(cfg, sc)
    teng.make_prefill_step(cfg, sc)
    with pytest.raises(ValueError, match=match):
        tspmd.build_train_step(cfg, None)
    with pytest.raises(ValueError, match="make_train_step"):
        tspmd.build_train_step(cfg, None)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "stablelm-3b"])
def test_int8_kv_serves(name, rng):
    """``kv_dtype="int8"`` (refused before int8 pools were ported): the
    steps build, and a short serve keeps int8 pools with f32 scales of
    the pools' slot, layer and page shape, finite logprobs and the tier
    traffic of the same serve with f32 pools (page traffic depends on the
    lengths alone)."""
    _, cfg = _cfgs(name)
    params = tserve.build(name, seed=1, device="cpu")[1]
    params = jax.tree.map(lambda x: x.float(), params)
    prompts = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    runs = {kd: tserve.serve(cfg, params, prompts, new=10, hbm_fraction=0.4,
                             kv_dtype=kd) for kd in ("int8", "auto")}
    kv, ref = runs["int8"].state.kv, runs["auto"].state.kv
    assert kv.pool1.dtype == kv.pool2.dtype == torch.int8
    assert kv.scale1.dtype == torch.float32
    assert tuple(kv.scale1.shape) == tuple(kv.pool1.shape[:4])
    assert tuple(kv.scale2.shape) == tuple(kv.pool2.shape[:4])
    assert ref.pool1.dtype == torch.float32 and tuple(ref.scale1.shape) == (1,)
    assert np.isfinite(runs["int8"].logprobs).all()
    for f in ("page_slot", "lengths", "t1_reads", "t2_reads", "evictions"):
        assert torch.equal(getattr(kv, f), getattr(ref, f)), f


def test_launcher_runs_on_cpu(capsys):
    tserve.main(["--arch", "stablelm-3b", "--device", "cpu", "--requests",
                 "2", "--prompt", "20", "--new", "6"])
    out = capsys.readouterr().out
    assert "kernel launches: {'flash_attention': 0, 'paged_attention': 0, " \
           "'page_copy': 0, 'ssd_scan': 0, 'rglru_scan': 0}" in out
    tserve.main(["--int8-kv", "--device", "cpu", "--arch", "stablelm-3b",
                 "--requests", "2", "--prompt", "20", "--new", "6"])
    out = capsys.readouterr().out
    assert " kv=int8 " in out and "kernel launches:" in out


def test_launcher_runs_attention_free_model_on_cpu(capsys):
    """mamba2-370m (reduced) through the launcher: no KV pools, so no tier
    traffic, and on the CPU no kernel launch."""
    tserve.main(["--arch", "mamba2-370m", "--device", "cpu", "--requests",
                 "2", "--prompt", "20", "--new", "6"])
    out = capsys.readouterr().out
    assert "no attention layers: no KV pools" in out
    assert "'ssd_scan': 0, 'rglru_scan': 0}" in out
