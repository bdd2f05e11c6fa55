"""The port's int8 two-tier KV pools on the CPU against ``repro.serving``.

Reduced mistral-nemo-12b, stablelm-3b and recurrentgemma-9b in f32, with
the reference's parameters carried over by ``params_from_numpy``, and
``kv_dtype="int8"``: each token's K and V as int8 codes with one f32
scale apiece, dequantized on read to ``bf16(f32(q) * sc)``.

- quantization on identical inputs: the reference's ``write_token_kv``
  (48 steps with evictions, so whole-slot write-backs carry the scales
  down) and ``prefill_write`` against the port's on the same f32 K/V —
  codes and scales bit for bit;
- decode from the reference's prefill state, carried across by
  ``paged_kv_from_numpy``, teacher-forced for 12 steps: every integer of
  the tier state equal, the learner's f32 weights bit for bit, the
  logprobs within 1e-5 (f32 products summed in another order) while the
  codes equal the reference's and within 1e-3 once one has tipped, and
  the codes and scales written during decode by the end-to-end rule
  below;
- prefill to decode end to end: the scales within 1e-5 relative (the
  f32 pools' bar of ``test_torch_serving.py``), the codes at most 1 apart on at most 0.1% of the elements (the port's f32
  K/V differ from the reference's in the last bits, and ``round`` can
  tip), the tier state equal;
- the evicting run of ``test_torch_serving.py`` in int8: write-backs and
  promotion move the scales, and after every step ``scale2`` is within
  1e-5 relative of the reference's slot for slot;
- the launcher with ``--int8-kv --device cpu``.

The scratch rows are left out of the pool comparisons: the reference
scatters masked prefill writes to them, the port skips those writes.
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
from repro_torch.convert import paged_kv_from_numpy, params_from_numpy
from repro_torch.core import online_learning as tol
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as teng
from repro_torch.serving import kvpool as tkvp

KV_ARCHS = ["mistral-nemo-12b", "stablelm-3b", "recurrentgemma-9b"]
CODE_MAX_DIFF = 1        # a code may tip by one ...
CODE_MAX_SHARE = 1e-3    # ... on at most 0.1% of the elements
# A scale is its token's amax over 127, so it inherits the f32 pools' bar
# of test_torch_serving.py: the port's K/V differ from the reference's by
# up to ~1e-5 relative after a few layers (8.1e-6 seen on stablelm-3b).
# Scales of two tokens differ far more, so a scale moved to the wrong
# slot still fails.
SCALE_RTOL = 1e-5
# Logprobs: 1e-5 (f32 products summed in another order) while every code
# equals the reference's. A code that tips moves one K or V element by a
# whole quantization step (amax / 127); from then on the bar is
# LOGPROB_TIPPED (stablelm-3b tips 1 code of 20,480 at its first decode
# step and its logprobs then differ by up to 2.1e-4).
LOGPROB_TOL = 1e-5
LOGPROB_TIPPED = 1e-3


def _cfgs(name):
    return tuple(dataclasses.replace(A[name].reduced(), param_dtype="float32")
                 for A in (J_ARCHS, T_ARCHS))


def _params(jcfg):
    jp = jpm.init_params(jcfg, jax.random.PRNGKey(1))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _ints(kv, port):
    m, o = kv.meta, kv.ols
    out = dict(tags=m.tags, valid=m.valid, dirty=m.dirty, freq=m.freq,
               ts=m.ts, page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               pred=o.pred, pred_n=o.pred_n, mispred=o.mispred,
               epoch_misses=o.epoch_misses, chosen=o.chosen,
               lengths=kv.lengths, t=kv.t,
               key=torch.tensor(kv.key) if port else kv.key,
               t2_reads=kv.t2_reads, t1_reads=kv.t1_reads)
    return {k: np.asarray(v.numpy() if port else v).astype(np.int64)
            for k, v in out.items()}


def _assert_tier_state(jkv, tkv, ctx):
    want, got = _ints(jkv, False), _ints(tkv, True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx}: {k}")
    jw = np.asarray(jkv.ols.weights)
    assert np.array_equal(jw.view(np.int32),
                          tkv.ols.weights.numpy().view(np.int32)), ctx


def _pools(kv, spec, port):
    """The four pools without their scratch rows, as numpy."""
    rows = dict(pool1=spec.hbm_slots, pool2=spec.t2_slots - 1,
                scale1=spec.hbm_slots, scale2=spec.t2_slots - 1)
    return {k: (getattr(kv, k).numpy() if port else np.asarray(getattr(kv, k))
                )[:n] for k, n in rows.items()}


def _assert_pools_exact(jkv, tkv, spec, ctx):
    want, got = _pools(jkv, spec, False), _pools(tkv, spec, True)
    for k in want:
        assert got[k].dtype == want[k].dtype, (ctx, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx}: {k}")


def _assert_pools_close(jkv, tkv, spec, ctx) -> int:
    """Scales within SCALE_RTOL relative; codes at most CODE_MAX_DIFF
    apart on at most CODE_MAX_SHARE of the elements. Returns the number of
    codes that differ."""
    want, got = _pools(jkv, spec, False), _pools(tkv, spec, True)
    for k in ("scale1", "scale2"):
        np.testing.assert_allclose(got[k], want[k], rtol=SCALE_RTOL, atol=0,
                                   err_msg=f"{ctx}: {k}")
    tipped = 0
    for k in ("pool1", "pool2"):
        d = np.abs(got[k].astype(np.int32) - want[k].astype(np.int32))
        assert d.max() <= CODE_MAX_DIFF, (ctx, k, d.max())
        assert (d > 0).mean() <= CODE_MAX_SHARE, (ctx, k, (d > 0).mean())
        tipped += int((d > 0).sum())
    return tipped


def _assert_logprobs(got, want, tipped: bool, ctx):
    np.testing.assert_allclose(
        got, want, atol=LOGPROB_TIPPED if tipped else LOGPROB_TOL, rtol=0,
        err_msg=f"{ctx} (codes tipped: {tipped})")


def _specs(name="stablelm-3b", hbm_fraction=0.4, B=2, max_seq=64):
    jcfg, tcfg = _cfgs(name)
    jsc = jeng.ServeConfig(max_seq=max_seq, batch_local=B, page_axes=(),
                           hbm_fraction=hbm_fraction, kv_dtype="int8")
    tsc = teng.ServeConfig(max_seq=max_seq, batch_local=B,
                           hbm_fraction=hbm_fraction, kv_dtype="int8")
    jspec, tspec = jeng.make_kv_spec(jcfg, jsc, 1), teng.make_kv_spec(tcfg,
                                                                      tsc)
    assert jspec.quantized and tspec.quantized
    return jcfg, tcfg, jsc, tsc, jspec, tspec


@pytest.mark.parametrize("hbm_fraction", [0.25, 0.4])
def test_write_token_quantization_matches_reference(hbm_fraction, rng):
    """48 decode write paths on identical random f32 K/V (the reference's
    allocation jitted, as its engine runs it): the codes and scales of
    both pools bit for bit after every step, through evictions whose
    dirty slots carry their scales down to tier 2."""
    *_, jspec, tspec = _specs(hbm_fraction=hbm_fraction)
    jkv = jkvp.init_paged_kv(jspec, jnp.zeros((), jnp.int32))
    tkv = tkvp.init_paged_kv(tspec, device="cpu")
    pw = tol.pow_table(0.7, 4 * tspec.total_pages)
    j_alloc = jax.jit(lambda kv: jkvp.alloc_step(
        kv, jspec, jnp.zeros((), jnp.int32), jol.OLConfig()))
    shape = (2, 2, tspec.n_kv, tspec.head_dim)
    for t in range(48):
        jkv, jplan = j_alloc(jkv)
        tkv, tplan = tkvp.alloc_step(tkv, tspec, tol.OLConfig(), pw)
        pools = tkvp.pools_of(tkv, tspec)
        tkvp.write_back_evicted(pools, tplan)
        index = tkvp.token_index(tplan, tkv.lengths, tspec, "cpu")
        jpools = (jkv.pool1, jkv.pool2, jkv.scale1, jkv.scale2)
        for li in range(tspec.layers_per_slot):
            # Magnitudes across decades, so that the scales differ.
            kv = (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3)
                  ).astype(np.float32)
            jpools = jkvp.write_token_kv(
                jpools, jplan, (jnp.asarray(kv[0]), jnp.asarray(kv[1])),
                jkv.lengths, jspec, jnp.asarray(li))
            tkvp.write_token_kv(pools[0], (torch.as_tensor(kv[0]),
                                           torch.as_tensor(kv[1])),
                                index, li, pools[2])
        jkv = jkv._replace(pool1=jpools[0], pool2=jpools[1],
                           scale1=jpools[2], scale2=jpools[3],
                           lengths=jkv.lengths + 1, t=jkv.t + 1)
        tkv = tkv._replace(lengths=tkv.lengths + 1, t=tkv.t + 1)
        _assert_pools_exact(jkv, tkv, tspec, f"write step {t}")
    assert int(tkv.writebacks[0]) > 0
    assert tkv.pool1.dtype == torch.int8
    assert int(np.abs(tkv.pool2.numpy()).max()) == 127


def test_prefill_quantization_matches_reference(rng):
    """``prefill_write`` of every layer on identical f32 K/V (one page per
    sequence all zeros, whose scale is 1e-30 / 127): codes and scales of
    both pools bit for bit, and the read path's dequantized K/V equal."""
    *_, jspec, tspec = _specs(hbm_fraction=0.4)
    B, S = 2, 64
    jkv = jkvp.init_paged_kv(jspec, jnp.zeros((), jnp.int32))
    tkv = tkvp.init_paged_kv(tspec, device="cpu")
    jkv = jkvp.prefill_residency(jkv, jspec, jnp.full((B,), S, jnp.int32))
    tkv = tkvp.prefill_residency(tkv, tspec, torch.full((B,), S))
    jpools = (jkv.pool1, jkv.pool2, jkv.scale1, jkv.scale2)
    tpools = tkvp.pools_of(tkv, tspec)
    for li in range(tspec.layers_per_slot):
        k, v = (rng.normal(size=(2, B, S, tspec.n_kv, tspec.head_dim))
                * 3.0).astype(np.float32)
        k[1, :tspec.page_size] = 0.0
        jpools = jkvp.prefill_write(jpools, jkv, jspec, jnp.asarray(li),
                                    jnp.asarray(k), jnp.asarray(v))
        tkvp.prefill_write(tpools, tkv, tspec, li, torch.as_tensor(k),
                           torch.as_tensor(v))
    jkv = jkv._replace(pool1=jpools[0], pool2=jpools[1], scale1=jpools[2],
                       scale2=jpools[3])
    _assert_pools_exact(jkv, tkv, tspec, "prefill")
    assert float(tkv.scale2.min()) == np.float32(np.float32(1e-30) / 127)
    jkv = jkv._replace(lengths=jkv.lengths - 1)
    tkv = tkv._replace(lengths=tkv.lengths - 1)
    for li in range(tspec.layers_per_slot):
        want = jkvp.read_pages(jpools, jkv, jspec, jnp.asarray(li))
        got = tkvp.read_pages(tpools, tkv, tspec, li)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _engines(name, B, max_seq, hbm_fraction):
    jcfg, tcfg, jsc, tsc, jspec, tspec = _specs(name, hbm_fraction, B,
                                                max_seq)
    jp, tp = _params(jcfg)
    ms = jpm.MeshSizes()
    return dict(
        jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jspec=jspec, tspec=tspec,
        jpre=jax.jit(jeng.make_prefill_step(jcfg, jsc, SINGLE, ms)),
        jdec=jax.jit(jeng.make_decode_step(jcfg, jsc, SINGLE, ms)),
        jprom=jax.jit(lambda kv: jkvp.promote_pages(kv, jspec,
                                                    jsc.n_promote)),
        tpre=teng.make_prefill_step(tcfg, tsc),
        tdec=teng.make_decode_step(tcfg, tsc), n_promote=tsc.n_promote)


@pytest.mark.parametrize("name", KV_ARCHS)
def test_decode_from_reference_prefill_state(name, rng):
    """The reference's int8 prefill, its ``PagedKV`` and recurrent states
    carried into the port, then 12 teacher-forced decode steps in both:
    the tier state integer for integer and the weights bit for bit after
    every step, the codes and scales written by the end-to-end rule, the
    logprobs within LOGPROB_TOL (LOGPROB_TIPPED once a code has
    tipped)."""
    e = _engines(name, B=2, max_seq=64, hbm_fraction=0.6)
    B, S0, n_dec = 2, 16, 12
    toks = rng.integers(0, e["jcfg"].vocab, (B, S0 + n_dec)).astype(np.int32)
    jstate, _ = e["jpre"](e["jp"], jnp.asarray(toks[:, :S0]))
    jnp_state = jax.tree.map(np.asarray, jstate)
    tstate = teng.DecodeState(
        kv=paged_kv_from_numpy(jnp_state.kv, device="cpu"),
        rec=params_from_numpy(jnp_state.rec, device="cpu"),
        rec_tail=params_from_numpy(jnp_state.rec_tail, device="cpu"))
    _assert_pools_exact(jstate.kv, tstate.kv, e["tspec"], f"{name} carried")
    for step in range(n_dec):
        x = toks[:, S0 + step]
        jstate, (jt, jl) = e["jdec"](e["jp"], jstate, jnp.asarray(x))
        tstate, (tt, tl) = e["tdec"](e["tp"], tstate, torch.as_tensor(x))
        ctx = f"{name} carried step {step}"
        _assert_tier_state(jstate.kv, tstate.kv, ctx)
        tipped = _assert_pools_close(jstate.kv, tstate.kv, e["tspec"], ctx)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        _assert_logprobs(tl.numpy(), np.asarray(jl), tipped > 0, ctx)


@pytest.mark.parametrize("name", KV_ARCHS)
def test_prefill_to_decode_end_to_end(name, rng):
    """Both engines from the same prompts: after the prefill and after
    each of 12 teacher-forced decode steps the tier state is equal, the
    scales within SCALE_RTOL relative, the codes by the one-step rule, the
    tokens equal and the logprobs within LOGPROB_TOL (LOGPROB_TIPPED once
    a code has tipped)."""
    e = _engines(name, B=2, max_seq=64, hbm_fraction=0.6)
    B, S0, n_dec = 2, 16, 12
    toks = rng.integers(0, e["jcfg"].vocab, (B, S0 + n_dec)).astype(np.int32)
    jstate, (jt, jl) = e["jpre"](e["jp"], jnp.asarray(toks[:, :S0]))
    tstate, (tt, tl) = e["tpre"](e["tp"], torch.as_tensor(toks[:, :S0]))
    for step in range(n_dec + 1):
        ctx = f"{name} end-to-end step {step}"
        _assert_tier_state(jstate.kv, tstate.kv, ctx)
        tipped = _assert_pools_close(jstate.kv, tstate.kv, e["tspec"], ctx)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        _assert_logprobs(tl.numpy(), np.asarray(jl), tipped > 0, ctx)
        if step == n_dec:
            break
        x = toks[:, S0 + step]
        jstate, (jt, jl) = e["jdec"](e["jp"], jstate, jnp.asarray(x))
        tstate, (tt, tl) = e["tdec"](e["tp"], tstate, torch.as_tensor(x))


@pytest.mark.parametrize("name", KV_ARCHS)
def test_evicting_run_int8_matches_reference(name, rng):
    """The evicting run of ``test_torch_serving.py`` in int8: 3 sequences,
    2-page prompts, 56 decode steps with 7 tier-1 slots and promotion every
    4 steps. After every step the tier state is equal and ``scale2`` within
    SCALE_RTOL relative slot for slot, so a scale that a write-back or a
    promotion failed to move, or moved to the wrong slot, fails."""
    e = _engines(name, B=3, max_seq=96, hbm_fraction=0.4)
    B, S0, n_dec = 3, 32, 56
    toks = rng.integers(0, e["jcfg"].vocab, (B, S0 + n_dec)).astype(np.int32)
    jstate, _ = e["jpre"](e["jp"], jnp.asarray(toks[:, :S0]))
    tstate, _ = e["tpre"](e["tp"], torch.as_tensor(toks[:, :S0]))
    t2 = e["tspec"].t2_slots - 1
    for step in range(n_dec):
        x = toks[:, S0 + step]
        jstate, (jt, jl) = e["jdec"](e["jp"], jstate, jnp.asarray(x))
        tstate, (tt, tl) = e["tdec"](e["tp"], tstate, torch.as_tensor(x))
        if step % 4 == 3:
            jstate = jstate._replace(kv=e["jprom"](jstate.kv))
            tstate = tstate._replace(kv=tkvp.promote_pages(
                tstate.kv, e["tspec"], e["n_promote"]))
        ctx = f"{name} evicting step {step}"
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=ctx)
        _assert_tier_state(jstate.kv, tstate.kv, ctx)
        np.testing.assert_allclose(
            tstate.kv.scale2[:t2].numpy(), np.asarray(jstate.kv.scale2)[:t2],
            rtol=SCALE_RTOL, atol=0, err_msg=ctx)
    kv = tstate.kv
    assert int(kv.evictions[0]) > 0 and int(kv.writebacks[0]) > 0
    assert int(kv.t2_reads[0]) > 0


def test_launcher_int8_kv_on_cpu(capsys):
    tserve.main(["--arch", "mistral-nemo-12b", "--int8-kv", "--device", "cpu",
                 "--requests", "2", "--prompt", "20", "--new", "6"])
    out = capsys.readouterr().out
    assert "kv=int8" in out and "tier-1 page reads" in out
    assert "'paged_attention': 0" in out
