"""The chunked replay's tenant mix and the per-step engine on the CPU
against the reference: ``TenantStream`` chunk invariance and its
snapshots, per-tenant attribution (``TenantCounters``), ``simulate`` with
``TenantReport``s, ``sweep``'s routing of tenant mixes and oversized
streams to the chunked replay, the MRC fence, and ``engine="scan"``
(one-shot and chunked, the whole carry) against the reference's
``engine="scan"`` and the fused engine. Integers exact, f32 weights bit
for bit, report JSON identical; the batched report solves within 1e-10.
"""
import importlib

import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as T
from repro.core import traffic as jtr
from repro.storage import tiered_store as jts
from repro_torch.core import traffic as ttr
from repro_torch.storage import tiered_store as tts
from test_torch_stream import (
    INDEXED, _carry_equal, _counters_equal, _json, _masked_rows, _pair,
    _with_x64_shim)


@pytest.fixture(scope="module")
def indexed():
    js, ts = _pair(**INDEXED)
    return js, ts, J.tier1_counters(js)


# ---------------------------------------------------------------------------
# the tenant mix


def _mix(tr):
    return tr.tenant_mix(
        tr.TenantSpec(name="oltp", rate=300.0, n_pages=128, zipf_s=1.3,
                      write_fraction=0.4),
        tr.TenantSpec(name="scan", rate=100.0, n_pages=384, zipf_s=0.9,
                      seed=1),
        n_requests=1600, seed=7)


def _mix_pair(**kw):
    return (J.SimSpec(traffic=_mix(jtr), **{
                k: (jts.StoreConfig(**v) if k == "store" else v)
                for k, v in kw.items()}),
            T.SimSpec(traffic=_mix(ttr), **{
                k: (tts.StoreConfig(**v) if k == "store" else v)
                for k, v in kw.items()}))


def test_tenant_generator_chunk_invariant_and_restore():
    jmix, tmix = _mix(jtr), _mix(ttr)
    full = jtr.tenant_mix_stream(jmix)
    for chunks in ((1600,), (1, 1599), (7, 700, 893), (512,) * 4):
        gen = ttr.TenantStream(tmix)
        parts = [gen.take(c) for c in chunks]
        for i in range(4):
            np.testing.assert_array_equal(
                np.concatenate([p[i] for p in parts]), full[i])
    # A snapshot of the reference's generator restores the port's.
    jgen = jtr.TenantStream(jmix)
    jgen.take(700)
    gen = ttr.TenantStream(tmix)
    gen.restore(jgen.state())
    for a, b in zip(gen.take(900), jgen.take(900)):
        np.testing.assert_array_equal(a, b)
    gen2 = ttr.TenantStream(tmix)
    gen2.take(700)
    snap = gen2.state()
    tail = gen2.take(900)
    gen3 = ttr.TenantStream(tmix)
    gen3.restore(snap)
    for a, b in zip(tail, gen3.take(900)):
        np.testing.assert_array_equal(a, b)


def test_tenant_attribution_reconciles():
    js, ts = _mix_pair(store=dict(n_lines=64, policy="ws"), n_shards=4,
                       window_dt=0.5)
    ref = J.tier1_counters(js)  # one-shot drain of the same merge
    _counters_equal(T.tier1_counters(ts, device="cpu"), ref, "one-shot")
    ctr, tc, _ = T.stream_tier1_counters(ts, chunk=300, device="cpu")
    _, jtc, _ = J.stream_tier1_counters(js, chunk=300)
    _counters_equal(ctr, ref)
    assert tc.names == jtc.names == ("oltp", "scan")
    for f in ("win_requests", "win_hits", "win_misses"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jtc, f))
    np.testing.assert_array_equal(tc.win_requests.sum(axis=0),
                                  np.asarray(ctr.win_requests).sum(axis=0))
    np.testing.assert_array_equal(tc.win_misses.sum(axis=0),
                                  np.asarray(ctr.win_misses).sum(axis=0))
    assert int(tc.win_requests.sum()) == 1600


def test_simulate_delegates_with_tenant_reports():
    js, ts = _mix_pair(store=dict(n_lines=64), n_shards=2, window_dt=0.5)
    rep = T.simulate(ts, device="cpu")
    assert [t.name for t in rep.tenants] == ["oltp", "scan"]
    assert sum(t.requests for t in rep.tenants) == rep.requests
    assert sum(t.misses for t in rep.tenants) == rep.misses
    for t in rep.tenants:
        assert t.response_s.shape == (rep.n_windows,)
        assert t.mean_response_s >= 0.0
    assert _json(rep) == _json(J.simulate(js))
    # The reports' entry points take the tenant counters.
    ctr, tc, _ = T.stream_tier1_counters(ts, device="cpu")
    assert _json(T.report_from_counters(ts, ctr, tenants=tc)) == _json(rep)
    (batched,) = T.batched_reports([(ts, ctr, tc)], solver="scalar")
    assert _json(batched) == _json(rep)


def test_sweep_routes_tenant_mix():
    js, ts = _mix_pair(store=dict(n_lines=32), n_shards=2, window_dt=0.5)
    axes = {"lam": [50.0, 100.0]}
    res = T.sweep(ts, axes, device="cpu")
    assert all(len(r.tenants) == 2 for r in res.reports)
    with _with_x64_shim():
        want = J.sweep(js, axes)
    # The batched float64 solves agree to ~1e-13 (the reference's own
    # bar between its paths is 1e-10); the counts exactly.
    for r, w in zip(res.reports, want.reports):
        for a, b in zip(r.tenants, w.tenants):
            da, db = a.to_dict(), b.to_dict()
            for k in ("name", "requests", "hits", "misses", "miss_rate",
                      "win_requests", "win_misses", "lam", "p12"):
                assert da[k] == db[k], k
            np.testing.assert_allclose(da["response_s"], db["response_s"],
                                       rtol=1e-10, atol=0)
            assert abs(da["mean_response_s"] - db["mean_response_s"]) \
                <= 1e-10 * abs(db["mean_response_s"])
    off = T.sweep(ts, axes, stream="off", device="cpu")
    assert all(r.tenants == () for r in off.reports)
    for a, b in zip(res.reports, off.reports):
        assert (a.requests, a.misses) == (b.requests, b.misses)


def test_sweep_routes_oversized_streams(monkeypatch, indexed):
    """Past STREAM_THRESHOLD requests the sweep replays in chunks, with
    the counters of the megabatch."""
    tsw = importlib.import_module("repro_torch.sim.sweep")
    js, ts, _ = indexed
    monkeypatch.setattr(tsw, "STREAM_THRESHOLD", 1000)
    tts.reset_stream_compile_count()
    got = T.sweep(ts, {"lam": [10.0]}, report="scalar", device="cpu")
    assert tts.stream_compile_count() >= 1
    want = J.sweep(js, {"lam": [10.0]}, report="scalar", stream="off")
    assert got.to_json() == want.to_json()


def test_mrc_fence():
    _, ts = _mix_pair(store=dict(n_lines=32, policy="lru"), n_shards=2,
                      window_dt=0.5)
    assert "tenant_mix" in T.mrc_unsupported_reason(ts)


# ---------------------------------------------------------------------------
# the per-step engine


def test_scan_engine_matches_reference_and_fused():
    js, ts = _pair(traffic=dict(kind="irm", n_requests=600, n_pages=300,
                                zipf_s=1.1, write_fraction=0.3, seed=8),
                   store=dict(n_lines=32, policy="ws", prefetch=True),
                   n_shards=3, n_windows=5)
    want = J.tier1_counters(js, engine="scan")
    _counters_equal(T.tier1_counters(ts, engine="scan", device="cpu"), want,
                    "one-shot scan")
    _counters_equal(T.tier1_counters(ts, device="cpu"), want, "fused")
    got, _, _ = T.stream_tier1_counters(ts, chunk=200, engine="scan",
                                        device="cpu")
    _counters_equal(got, want, "chunked scan")
    # The whole stats, final weights included, one shard's stream.
    cfg = dict(n_lines=16, policy="random")
    rng = np.random.default_rng(4)
    p = rng.integers(0, 60, 300).astype(np.int32)
    w = rng.random(300) < 0.3
    a = tts.run_stream(tts.StoreConfig(**cfg), p, w, n_windows=3,
                       engine="scan", device="cpu")
    b = jts.run_stream(jts.StoreConfig(**cfg), p, w, n_windows=3,
                       engine="scan")
    for f in b._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_scan_engine_chunk_carry_matches_reference():
    """The per-step engine's masked chunks against the reference's: the
    whole carry (its full prediction rings included) exact."""
    kw = dict(n_lines=16, policy="ws", prefetch=True)
    pages, writes, win = _masked_rows(3, 120, 4, seed=9)
    jeng = jts.stream_chunk_engine(jts.StoreConfig(**kw), n_windows=4,
                                   engine="scan", donate=False)
    teng = tts.stream_chunk_engine(tts.StoreConfig(**kw), n_windows=4,
                                   engine="scan", device="cpu")
    jcarry = jts.init_stream_carry(jts.StoreConfig(**kw), 3, n_windows=4)
    tcarry = tts.init_stream_carry(tts.StoreConfig(**kw), 3, n_windows=4,
                                   device="cpu")
    jh, th = jts.StoreConfig(**kw).hyper(), tts.StoreConfig(**kw).hyper()
    for sl in (slice(0, 70), slice(70, 120)):
        jcarry = jeng(jh, jcarry, pages[:, sl], writes[:, sl], win[:, sl])
        tcarry = teng(th, tcarry, pages[:, sl], writes[:, sl], win[:, sl])
        _carry_equal(tcarry, jcarry)
