"""The chunked streaming replay on the CPU against the reference: the
masked plain cache scan, ``run_stream_chunked``, ``stream_tier1_counters``
/ ``simulate_stream`` (chunkings at window edges, trace overrides, faults
that straddle chunks, the synchronous baseline, resume, partial reports,
the buffer-set bound) and checkpoints carried across from the reference.
The same seeded inputs go through both; integers are exact, f32 weights
bit for bit, report JSON identical. The tenant mix and the per-step
engine are in ``test_torch_stream_tenant.py``.

The reference's batched report solver imports
``jax.experimental.enable_x64``, which this JAX no longer has (ROADMAP
fault (a)); :func:`_with_x64_shim` binds it to ``jax.enable_x64`` around
the one reference call that reaches it and removes it afterwards.
"""
import contextlib
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:  # hypothesis fuzz tests are optional (requirements-dev.txt)
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

import repro.sim as J
import repro_torch.sim as T
from repro.core import traffic as jtr
from repro.kernels.ref import cache_scan_ref as jax_cache_scan_ref
from repro.storage import tiered_store as jts
from repro_torch.convert import (
    store_state_from_numpy, stream_checkpoint_from_numpy)
from repro_torch.core import traffic as ttr
from repro_torch.kernels import cache_scan as tcs
from repro_torch.kernels.ref import cache_scan_ref
from repro_torch.storage import tiered_store as tts


@contextlib.contextmanager
def _with_x64_shim():
    """``jax.experimental.enable_x64`` bound to ``jax.enable_x64`` for one
    reference call (fault (a)), removed afterwards."""
    had = hasattr(jax.experimental, "enable_x64")
    old = getattr(jax.experimental, "enable_x64", None)
    jax.experimental.enable_x64 = lambda new_val=True: jax.enable_x64(new_val)
    try:
        yield
    finally:
        if had:
            jax.experimental.enable_x64 = old
        else:
            del jax.experimental.enable_x64


def _json(report):
    return json.dumps(report.to_dict(), sort_keys=True)


def _counters_equal(got, want, ctx=""):
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{ctx} Tier1Counters.{f}")


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _carry_equal(got, want):
    """A port carry against a reference carry (numpy or tensors), leaf by
    leaf in pytree order; the key's uint32 words as int64; f32 by bits."""
    g = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
         for x in _leaves(got)]
    w = _leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if b.dtype == np.uint32:
            b = b.astype(np.int64)
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"carry leaf {i}")


def _pair(traffic, store, **kw):
    """The same spec in the reference and in the port."""
    return (J.SimSpec(traffic=jtr.TrafficSpec(**traffic),
                      store=jts.StoreConfig(**store), **kw),
            T.SimSpec(traffic=ttr.TrafficSpec(**traffic),
                      store=tts.StoreConfig(**store), **kw))


INDEXED = dict(traffic=dict(kind="irm", n_requests=1200, n_pages=512,
                            zipf_s=1.1, write_fraction=0.3, seed=3),
               store=dict(n_lines=64, policy="ws"), n_shards=4, n_windows=7)


@pytest.fixture(scope="module")
def indexed():
    js, ts = _pair(**INDEXED)
    return js, ts, J.tier1_counters(js)


# ---------------------------------------------------------------------------
# the masked plain cache scan


def _masked_rows(B, L, W, seed):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 40, (B, L)).astype(np.int32)
    pages[1, : L // 2] = (np.arange(L // 2) * 3) % 97  # the prefetcher issues
    writes = rng.random((B, L)) < 0.3
    win = np.sort(rng.integers(0, W, (B, L)), axis=1).astype(np.int32)
    pad = rng.random((B, L)) < 0.2
    win[pad] = W + rng.integers(0, 3, pad.sum())          # pads mid-row
    win[2, -30:] = W                                      # a padded tail
    return pages, writes, win


@pytest.mark.parametrize("policy", ["ws", "lru", "lfu", "random"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_masked_scan_matches_reference(policy, prefetch):
    """Two chunks with pads mid-row and at a tail: the second from the
    port's carried (non-cold) state, and again from the reference's
    carried across: the whole carry, key included, exact."""
    B, W, N = 3, 5, 16
    pages, writes, win = _masked_rows(B, 150, W, seed=len(policy))
    jc = jts.StoreConfig(n_lines=N, policy=policy, prefetch=prefetch)
    tc = tts.StoreConfig(n_lines=N, policy=policy, prefetch=prefetch)
    kw = dict(epoch_width=jc.epoch_width, pred_cap=jc.pred_cap,
              prefetch=prefetch, prefetch_width=jc.prefetch_width,
              n_windows=W)
    jh = jc.hyper()

    def jrun(state, acc, p, w, wi):
        return jax.vmap(lambda s, a, pp, ww, wwi: jax_cache_scan_ref(
            s, a, pp, ww, wwi, jh, None, masked=True, **kw))(
                state, acc, jnp.asarray(p), jnp.asarray(w), jnp.asarray(wi))

    jstate = jax.tree.map(lambda x: jnp.repeat(x[None], B, 0),
                          jts.init_store(jc, 5))
    jacc = jax.tree.map(lambda x: jnp.repeat(x[None], B, 0),
                        jts._init_accum(W))
    tstate, tacc = tts.init_stream_carry(tc, B, seed=5, n_windows=W,
                                         device="cpu")
    sl = slice(0, 80)
    jstate, jacc = jrun(jstate, jacc, pages[:, sl], writes[:, sl],
                        win[:, sl])
    tstate, tacc = cache_scan_ref(
        tstate, tacc, *(torch.from_numpy(x[:, sl])
                        for x in (pages, writes, win)),
        tc.hyper(), masked=True, **kw)
    _carry_equal((tstate, tacc), (jstate, jacc))
    # The reference's state carried across, beside the port's own.
    sl = slice(80, 150)
    rows = [torch.from_numpy(x[:, sl]) for x in (pages, writes, win)]
    across = (store_state_from_numpy(_leaves(jstate)),
              tts.Accum(*(torch.tensor(x) for x in _leaves(jacc))))
    jstate, jacc = jrun(jstate, jacc, pages[:, sl], writes[:, sl],
                        win[:, sl])
    for carry in ((tstate, tacc), across):
        got = tcs.masked_cache_scan(tc, tc.hyper(), *carry, *rows,
                                    n_windows=W)
        _carry_equal(got, (jstate, jacc))
    real = int((win < W).sum())
    assert int(got[1].win_requests.sum()) == real == int(got[0].t.sum())


# ---------------------------------------------------------------------------
# run_stream_chunked


@pytest.mark.parametrize("policy", ["lru", "ws"])
def test_run_stream_chunked_matches_reference(policy):
    kw = dict(n_lines=32, policy=policy, prefetch=True)
    rng = np.random.default_rng(11)
    pages = rng.integers(0, 200, size=600).astype(np.int32)
    writes = rng.random(600) < 0.25
    one = tts.run_stream(tts.StoreConfig(**kw), pages, writes, n_windows=5,
                         device="cpu")
    want = jts.run_stream_chunked(jts.StoreConfig(**kw), pages, writes,
                                  chunk=64, n_windows=5)
    for chunk in (7, 64, 600, 1024):
        got = tts.run_stream_chunked(tts.StoreConfig(**kw), pages, writes,
                                     chunk=chunk, n_windows=5, device="cpu")
        # Every chunking equals the reference's chunked run (final
        # weights bit for bit) and the one-shot run (whose pads run epoch
        # boundaries on, so its final weights may differ).
        for f in want._fields:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=f"chunk={chunk} {f}")
            if f != "final_weights":  # one-shot pads run epoch boundaries
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), getattr(one, f).numpy())


def test_run_stream_chunked_rejects_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        tts.run_stream_chunked(tts.StoreConfig(n_lines=8),
                               np.zeros(4, np.int32), np.zeros(4, bool),
                               chunk=0, device="cpu")


# ---------------------------------------------------------------------------
# stream_tier1_counters / simulate_stream


@pytest.mark.parametrize("chunk", [11, 173, 600, 1200, 2048])
def test_window_edge_chunkings(indexed, chunk):
    # 1200 requests over 7 windows: these chunk sizes straddle window
    # edges, split windows across many chunks, and exceed the stream.
    _, ts, ref = indexed
    ctr, tenant_ctr, ck = T.stream_tier1_counters(ts, chunk=chunk,
                                                  device="cpu")
    assert tenant_ctr is None and ck.done
    _counters_equal(ctr, ref, f"chunk={chunk}")


def test_chunk_of_one(indexed):
    js, ts, _ = indexed
    js = js.replace(**{"traffic.n_requests": 40})
    ts = ts.replace(**{"traffic.n_requests": 40})
    _counters_equal(T.stream_tier1_counters(ts, chunk=1, device="cpu")[0],
                    J.tier1_counters(js))


def test_report_bit_exact(indexed):
    js, ts, ref = indexed
    assert _json(T.simulate_stream(ts, chunk=173, device="cpu")) \
        == _json(J.report_from_counters(js, ref))


def test_trace_override(indexed):
    js, ts, _ = indexed
    rng = np.random.default_rng(5)
    trace = (rng.integers(0, 300, size=500), rng.random(500) < 0.4)
    _counters_equal(
        T.stream_tier1_counters(ts, trace, chunk=99, device="cpu")[0],
        J.tier1_counters(js, trace))


FAULT = dict(traffic=dict(kind="irm", n_requests=1500, n_pages=256,
                          zipf_s=1.2, rate=500.0, seed=5),
             store=dict(n_lines=32), n_shards=4, window_dt=0.25)


@pytest.fixture(scope="module")
def fault_specs():
    js, ts = _pair(**FAULT)
    js = js.replace(faults=J.FaultSpec(events=(J.shard_down(1, 0.9, 1.7),)))
    ts = ts.replace(faults=T.FaultSpec(events=(T.shard_down(1, 0.9, 1.7),)))
    return js, ts, J.tier1_counters(js)


def test_fault_event_straddles_chunks(fault_specs):
    # chunk=250 at 500 req/s ~ 0.5 s of arrivals per chunk: the outage
    # [0.9, 1.7) opens and closes mid-chunk, and the 0.25 s window edges
    # never align with chunk edges.
    js, ts, ref = fault_specs
    want = _json(J.report_from_counters(js, ref))
    for chunk in (250, 499):
        assert _json(T.simulate_stream(ts, chunk=chunk, device="cpu")) \
            == want


def test_no_donation_path_matches(fault_specs):
    _, ts, ref = fault_specs
    _counters_equal(T.stream_tier1_counters(ts, chunk=300, donate=False,
                                            device="cpu")[0], ref)


# ---------------------------------------------------------------------------
# checkpoints


def test_resume_bit_exact(indexed):
    js, ts, ref = indexed
    ctr_p, _, ck = T.stream_tier1_counters(ts, chunk=150, max_requests=487,
                                           device="cpu")
    assert not ck.done and ck.offset == 487
    assert int(np.asarray(ctr_p.requests).sum()) == 487
    # The checkpoint pickles, and its carry is the reference's, leaf by
    # leaf.
    ck = pickle.loads(pickle.dumps(ck))
    _, _, jck = J.stream_tier1_counters(js, chunk=150, max_requests=487)
    _carry_equal(ck.carry, jck.carry)
    ctr, _, ck2 = T.stream_tier1_counters(ts, chunk=321, checkpoint=ck,
                                          device="cpu")
    assert ck2.done
    _counters_equal(ctr, ref)


def test_reference_checkpoint_resumes_in_port(indexed):
    """A replay begun in the reference, carried across with
    ``stream_checkpoint_from_numpy``, ends where the uninterrupted port
    replay ends: counters and final carry exact."""
    js, ts, ref = indexed
    _, _, jck = J.stream_tier1_counters(js, chunk=200, max_requests=555)
    ck = stream_checkpoint_from_numpy(jck)
    assert ck.signature == ts.cache_signature()
    _carry_equal(ck.carry, jck.carry)
    ctr, _, end = T.stream_tier1_counters(ts, chunk=200, checkpoint=ck,
                                          device="cpu")
    _counters_equal(ctr, ref)
    _, _, whole = T.stream_tier1_counters(ts, chunk=200, device="cpu")
    _carry_equal(end.carry, whole.carry)


def test_partial_report_and_fluid_q0():
    js, ts = _pair(traffic=dict(kind="irm", n_requests=1000, n_pages=256,
                                rate=400.0, seed=2),
                   store=dict(n_lines=32), n_shards=2, window_dt=0.5)
    rep, ck = T.simulate_stream(ts, chunk=256, max_requests=600,
                                device="cpu")
    jrep, jck = J.simulate_stream(js, chunk=256, max_requests=600)
    assert rep.requests == 600 and not ck.done
    assert _json(rep) == _json(jrep)
    assert ck.fluid_q0 is not None and len(ck.fluid_q0) == 2
    for a, b in zip(ck.fluid_q0, jck.fluid_q0):
        np.testing.assert_array_equal(a, b)
    rep_full = T.simulate_stream(ts, chunk=200, checkpoint=ck, device="cpu")
    assert _json(rep_full) == _json(J.simulate_stream(js))


def test_resume_rejects_other_spec(indexed):
    _, ts, _ = indexed
    _, _, ck = T.stream_tier1_counters(ts, chunk=200, max_requests=200,
                                       device="cpu")
    other = ts.replace(**{"store.n_lines": 16})
    with pytest.raises(ValueError, match="cache_signature"):
        T.stream_tier1_counters(other, checkpoint=ck, device="cpu")


def test_at_most_two_buffer_sets():
    _, ts = _pair(traffic=dict(kind="irm", n_requests=2000, n_pages=512,
                               zipf_s=1.1, seed=17),
                  store=dict(n_lines=48), n_shards=4, n_windows=3)
    tts.reset_stream_compile_count()
    T.stream_tier1_counters(ts, chunk=250, device="cpu")  # 8 chunks
    assert 1 <= tts.stream_compile_count() <= 2
    T.stream_tier1_counters(ts, chunk=250, max_requests=999, device="cpu")
    assert tts.stream_compile_count() <= 2


def test_entry_points_default_to_the_card(monkeypatch, indexed):
    _, ts, _ = indexed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate_stream(ts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.init_stream_carry(ts.store, 2)


if HAVE_HYPOTHESIS:

    _PROP = _pair(traffic=dict(kind="irm", n_requests=150, n_pages=64,
                               zipf_s=1.1, write_fraction=0.3, seed=23),
                  store=dict(n_lines=16, policy="ws"), n_shards=2,
                  n_windows=4)
    _PROP_REF = []

    def _prop_ref():
        if not _PROP_REF:
            _PROP_REF.append(J.tier1_counters(_PROP[0]))
        return _PROP_REF[0]

    @given(chunk=st.integers(1, 160))
    @settings(max_examples=10, deadline=None)
    def test_streamed_equals_reference_fuzz(chunk):
        ctr, _, _ = T.stream_tier1_counters(_PROP[1], chunk=chunk,
                                            device="cpu")
        _counters_equal(ctr, _prop_ref())

    @given(split=st.integers(1, 149), chunk=st.integers(1, 80))
    @settings(max_examples=8, deadline=None)
    def test_resume_equals_reference_fuzz(split, chunk):
        _, _, ck = T.stream_tier1_counters(_PROP[1], chunk=chunk,
                                           max_requests=split, device="cpu")
        ctr, _, _ = T.stream_tier1_counters(_PROP[1], chunk=chunk,
                                            checkpoint=ck, device="cpu")
        _counters_equal(ctr, _prop_ref())
