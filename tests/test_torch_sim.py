"""``repro_torch.sim.simulate`` on the CPU against ``repro.sim.simulate``:
the §V worked example, a windowed wall-clock spec and a shard_down fault
spec. ``Tier1Counters`` must be equal and the ``to_dict()`` JSON identical
(the report stage is a copy of the reference's scalar numpy path)."""
import json

import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as T
from repro.core import traffic as jtr
from repro.storage import tiered_store as jts
from repro_torch.core import traffic as ttr
from repro_torch.storage import tiered_store as tts


def _specs(traffic, store, rates=None, down=None, **kw):
    out = []
    for sim, tr, ts in ((J, jtr, jts), (T, ttr, tts)):
        extra = dict(kw)
        if rates is not None:
            extra["rates"] = sim.RateSpec(**rates)
        if down is not None:
            extra["faults"] = sim.FaultSpec(
                events=(sim.shard_down(*down),),
                retry=sim.RetryPolicy(timeout=0.05, max_retries=2))
        out.append(sim.SimSpec(traffic=tr.TrafficSpec(**traffic),
                               store=ts.StoreConfig(**store), **extra))
    return out


_CASES = {
    # benchmarks/bench_sim.py's §V worked example (lambda_eff = 86.6).
    "worked_example": dict(
        traffic=dict(kind="irm", n_requests=4000, n_pages=1024,
                     write_fraction=0.3, seed=7),
        store=dict(n_lines=128, policy="ws"), n_shards=4, lam=100.0,
        k_servers=1, rates=dict(source="paper"), p12_override=0.2),
    "wall_clock": dict(
        traffic=dict(kind="onoff", n_requests=2000, n_pages=500, seed=3,
                     rate=200.0, write_fraction=0.2),
        store=dict(n_lines=32, policy="ws", prefetch=True), n_shards=3,
        window_dt=1.0, mapping="random"),
    "shard_down": dict(
        traffic=dict(kind="irm", n_requests=1500, n_pages=400, rate=200.0,
                     seed=3),
        store=dict(n_lines=32), n_shards=3, window_dt=1.0,
        down=(1, 2.0, 4.0)),
}


def _json(report):
    return json.dumps(report.to_dict(), sort_keys=True)


@pytest.mark.parametrize("case", list(_CASES))
def test_simulate_matches_reference(case):
    """``simulate`` is ``report_from_counters(tier1_counters(...))`` on
    both sides; the two stages are compared one by one."""
    js, ts = _specs(**_CASES[case])
    jctr = J.tier1_counters(js)
    tctr = T.tier1_counters(ts, device="cpu")
    for f in J.Tier1Counters._fields:
        np.testing.assert_array_equal(getattr(tctr, f), getattr(jctr, f),
                                      err_msg=f"{case} field={f}")
    got = T.report_from_counters(ts, tctr)
    assert _json(got) == _json(J.report_from_counters(js, jctr))
    if case == "worked_example":
        assert abs(got.lam_eff - 86.6) / 86.6 < 0.01


def test_simulate_end_to_end_small():
    js, ts = _specs(traffic=dict(kind="irm", n_requests=400, n_pages=150,
                                 write_fraction=0.3, seed=1),
                    store=dict(n_lines=16), n_shards=2, n_windows=3)
    assert _json(T.simulate(ts, device="cpu")) == _json(J.simulate(js))


def test_unported_routes_raise():
    """The routes the chunked replay serves (they raised before it was
    ported): ``simulate`` on a tenant mix, with its tenant reports, equal
    to the reference's; ``batched_reports`` taking the tenant counters as
    a third item element."""
    mixes = [tr.tenant_mix(tr.TenantSpec(name="a", rate=50.0, n_pages=100),
                           tr.TenantSpec(name="b", rate=30.0, n_pages=80),
                           n_requests=200, seed=1) for tr in (jtr, ttr)]
    jspec = J.SimSpec(traffic=mixes[0], n_shards=2)
    spec = T.SimSpec(traffic=mixes[1], n_shards=2)
    rep = T.simulate(spec, device="cpu")
    assert [t.name for t in rep.tenants] == ["a", "b"]
    assert _json(rep) == _json(J.simulate(jspec))
    assert T.batched_reports([]) == []
    ctr, tc, _ = T.stream_tier1_counters(spec, device="cpu")
    assert isinstance(tc, T.TenantCounters) and tc.n_tenants == 2
    (got,) = T.batched_reports([(spec, ctr, tc)], solver="scalar")
    assert _json(got) == _json(rep)
