"""The port's ``sweep`` on the CPU against ``repro.sim.sweep``.

- Megabatch: counters and reports equal (``to_json()`` identical under
  ``report="scalar"``) over policy x mapping, ragged stream lengths,
  windowed and timed grids, a fault grid, and an alpha / beta / threshold
  / policy knob grid in one launch — the f32 expert weights bit for bit at
  betas other than 0.7.
- MRC routing: no cache-scan launch on a size-only LRU grid, ``mrc="off"``,
  a mixed policy axis, the logged fallback reason, ``"require"`` errors.
- The default batched reports within 1e-10 (k = 1) and 1e-9 (k > 1) of
  the reference's batched reports.
- ``stream="auto"`` raising on what the chunked replay serves.

The reference's batched report solver imports
``jax.experimental.enable_x64``, which this JAX no longer has; the calls
that need it run inside a shim bound through ``monkeypatch`` for that call
only.
"""
import importlib
import json
import logging
import math

import jax
import pytest

import repro.sim as J
import repro_torch.sim as T
from repro.core import traffic as jtr
from repro.core.mapping import MAPPING_POLICIES
from repro.storage import tiered_store as jts
from repro_torch.core import traffic as ttr
from repro_torch.kernels import cache_scan as tcs
from repro_torch.storage import tiered_store as tts

# The module (``repro_torch.sim.sweep`` as an attribute is the function).
tsw = importlib.import_module("repro_torch.sim.sweep")
jsw = importlib.import_module("repro.sim.sweep")

_BASE = dict(
    traffic=dict(kind="poisson", n_requests=300, n_pages=96,
                 write_fraction=0.25, seed=5),
    store=dict(n_lines=16, policy="ws"), n_shards=3, lam=20.0)


def _specs(over=None, **kw):
    """The same base spec in both packages, with dotted-path overrides."""
    fields = {**_BASE, **kw}
    out = []
    for sim, tr, ts in ((J, jtr, jts), (T, ttr, tts)):
        spec = sim.SimSpec(traffic=tr.TrafficSpec(**fields["traffic"]),
                           store=ts.StoreConfig(**fields["store"]),
                           rates=sim.RateSpec(source="paper"),
                           **{k: v for k, v in fields.items()
                              if k not in ("traffic", "store")})
        out.append(spec.replace(**(over or {})))
    return out


def _reference_sweep(monkeypatch, *args, **kw):
    """``repro.sim.sweep`` with ``jax.experimental.enable_x64`` bound to
    ``jax.enable_x64`` for this one call."""
    with monkeypatch.context() as m:
        m.setattr(jax.experimental, "enable_x64",
                  lambda new_val=True: jax.enable_x64(new_val),
                  raising=False)
        return J.sweep(*args, **kw)


def _same_scalar_json(jbase, tbase, axes, **kw):
    want = J.sweep(jbase, axes, report="scalar", **kw)
    got = T.sweep(tbase, axes, report="scalar", device="cpu", **kw)
    assert got.points == want.points
    assert got.to_json() == want.to_json()
    return got


ALL_POLICIES = sorted(tts.POLICY_TO_IDX)        # lfu, lru, random, ws


@pytest.mark.parametrize("grid", ["policy_x_mapping", "ragged",
                                  "windowed_ragged"])
def test_megabatch_matches_reference(grid):
    """Counters and scalar reports JSON-identical across ragged length
    buckets, every policy and mapping, windowed telemetry."""
    if grid == "policy_x_mapping":
        specs = _specs()
        axes = {"store.policy": ALL_POLICIES,
                "mapping": sorted(MAPPING_POLICIES)}
    else:
        specs = _specs(n_windows=6 if grid == "windowed_ragged" else 1)
        axes = {"traffic.n_requests": [60, 300, 700],
                "store.policy": ["ws", "lru"], "store.alpha": [0.3, 0.7]}
    _same_scalar_json(*specs, axes)


def test_timed_and_fault_grids_match_reference():
    """Wall-clock windows binned host-side, and a shard_down schedule that
    remaps owners host-side, through one launch each."""
    specs = _specs({"traffic.rate": 150.0}, window_dt=0.5, mapping="random")
    _same_scalar_json(*specs, {"store.policy": ["ws", "lfu"],
                               "store.n_lines": [8, 24]})
    jspec, tspec = specs
    faulted = [s.replace(faults=sim.FaultSpec(
        events=(sim.shard_down(1, 0.5, 1.2),),
        retry=sim.RetryPolicy(timeout=0.05, max_retries=2)))
        for s, sim in ((jspec, J), (tspec, T))]
    _same_scalar_json(*faulted, {"store.policy": ["ws", "random"],
                                 "lam": [30.0, 60.0]})


def test_knob_grid_one_launch_bit_exact_weights(monkeypatch):
    """alpha x beta x threshold x policy in one cache-scan launch, with
    betas away from 0.7: every counter and every window's f32 expert
    weights equal the reference's (the JSON prints each weight with
    round-trip precision)."""
    jspec, tspec = _specs({"traffic.seed": 11, "store.n_lines": 12},
                          n_windows=4)
    axes = {"store.policy": ALL_POLICIES, "store.alpha": [0.1, 0.3],
            "store.beta": [0.3, 0.5, 0.6, 0.8, 0.9, 0.95],
            "store.threshold": [0.0, 0.25]}
    launches = []
    real = tsw.fused_cache_scan
    monkeypatch.setattr(tsw, "fused_cache_scan",
                        lambda *a, **k: launches.append(a[3].shape)
                        or real(*a, **k))
    T.reset_engine_compile_count()
    got = _same_scalar_json(jspec, tspec, axes)
    (rows, length), = launches                  # one launch
    assert rows == 4 * 2 * 6 * 2 * 3            # points x shards
    assert length == tsw._bucket_cap(length)
    assert T.engine_compile_count() <= 1
    ws = [r for p, r in zip(got.points, got.reports)
          if p["store.policy"] == "ws"]
    assert len({r.windows.weights.tobytes() for r in ws}) > 1


def test_compile_count_is_per_structural_config():
    """A second sweep of the same structural config adds no count."""
    jspec, tspec = _specs({"store.n_lines": 13, "traffic.seed": 13},
                          n_windows=4)
    axes = {"store.policy": ALL_POLICIES, "store.beta": [0.6, 0.9]}
    T.reset_engine_compile_count()
    T.sweep(tspec, axes, device="cpu", report="scalar")
    assert T.engine_compile_count() == 1
    T.reset_engine_compile_count()
    res = T.sweep(tspec, axes, device="cpu", report="scalar")
    assert T.engine_compile_count() == 0
    assert all(rep.n_windows == 4 for rep in res.reports)


def test_unbatched_matches_reference():
    _same_scalar_json(*_specs(), {"store.policy": ["ws", "lru"],
                                  "lam": [10.0, 30.0]}, batch=False)


# ---------------------------------------------------------------------------
# MRC routing

_MRC = dict(traffic=dict(kind="irm", n_requests=260, n_pages=64,
                         write_fraction=0.2, seed=21),
            store=dict(n_lines=8, policy="lru"), n_shards=2, lam=60.0)


def test_size_axis_routes_through_mrc_without_launches(monkeypatch):
    """A size-only LRU grid (with a queuing-side rider) is served by one
    distance pass: no cache-scan launch, reports identical."""
    jspec, tspec = _specs(**_MRC)
    calls = []
    monkeypatch.setattr(tcs, "cache_scan_plain",
                        lambda *a, **k: calls.append(a))
    _same_scalar_json(jspec, tspec, {"store.n_lines": [4, 8, 16, 32],
                                     "lam": [40.0, 60.0]})
    assert calls == []


def test_mrc_off_uses_engine():
    jspec, tspec = _specs(**_MRC)
    T.reset_engine_compile_count()
    _same_scalar_json(jspec, tspec, {"store.n_lines": [5, 7]}, mrc="off")
    assert T.engine_compile_count() == 2


def test_mixed_policy_axis_splits_between_paths(monkeypatch):
    jspec, tspec = _specs(**_MRC)
    mrc_calls = []
    real = tsw.mrc_tier1_counters
    monkeypatch.setattr(tsw, "mrc_tier1_counters",
                        lambda spec, sizes, **k: mrc_calls.append(
                            (spec.store.policy, list(sizes)))
                        or real(spec, sizes, **k))
    _same_scalar_json(jspec, tspec, {"store.n_lines": [8, 16],
                                     "store.policy": ["lru", "ws"]})
    assert mrc_calls == [("lru", [8, 16])]


def test_ineligible_grid_falls_back_with_logged_reason(caplog):
    jspec, tspec = _specs({"store.policy": "ws"}, **_MRC)
    with caplog.at_level(logging.INFO, logger="repro_torch.sim.sweep"):
        _same_scalar_json(jspec, tspec, {"store.n_lines": [8, 16]})
    assert any("MRC fallback" in r.message and "policy" in r.message
               for r in caplog.records)


@pytest.mark.parametrize("case", ["policy", "windowed_writes", "unbatched",
                                  "bad_value"])
def test_require_and_option_errors_match(case):
    jspec, tspec = _specs(**_MRC)
    kw = dict(mrc="require")
    axes = {"store.n_lines": [8, 16]}
    if case == "policy":
        axes["store.policy"] = ["lru", "ws"]
    elif case == "windowed_writes":
        jspec, tspec = (s.replace(n_windows=4) for s in (jspec, tspec))
    elif case == "unbatched":
        kw["batch"] = False
    else:
        kw["mrc"] = "always"
    with pytest.raises(ValueError) as want:
        J.sweep(jspec, axes, **kw)
    with pytest.raises(ValueError) as got:
        T.sweep(tspec, axes, device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# batched reports


def _assert_close(got, want, tol, path=""):
    """JSON trees equal, floats within ``tol`` (non-finite equal)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        if math.isfinite(want):
            assert abs(got - want) <= tol, f"{path}: {got} vs {want}"
        else:
            assert repr(got) == repr(want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("k,tol", [(1, 1e-10), (2, 1e-9)])
def test_batched_reports_within_tolerance(monkeypatch, k, tol):
    """Default sweep (batched reports) against the reference's batched
    reports: every field within the stated tolerance, with a retry-storm
    fault grid in the k = 1 case."""
    jspec, tspec = _specs({"traffic.rate": 150.0}, window_dt=0.5,
                          k_servers=k)
    if k == 1:
        jspec, tspec = (s.replace(faults=sim.FaultSpec(
            events=(sim.shard_down(2, 0.4, 1.0),),
            retry=sim.RetryPolicy(timeout=0.05, max_retries=2)))
            for s, sim in ((jspec, J), (tspec, T)))
    axes = {"store.policy": ["ws", "lru"], "lam": [20.0, 80.0]}
    want = _reference_sweep(monkeypatch, jspec, axes)
    T.reset_fluid_compile_count()
    got = T.sweep(tspec, axes, device="cpu")
    assert T.fluid_compile_count() <= 1
    assert got.profile is None and want.profile is None
    _assert_close(json.loads(got.to_json()), json.loads(want.to_json()), tol)


def test_profile_reports_the_reference_stages():
    jspec, tspec = _specs()
    axes = {"store.policy": ["ws", "lru"]}
    want = J.sweep(jspec, axes, report="scalar", profile=True)
    got = T.sweep(tspec, axes, report="scalar", profile=True, device="cpu")
    assert sorted(got.profile) == sorted(want.profile)
    assert got.profile["n_points"] == 2
    # engine_dispatch = submit + wait + the routed paths (none here but
    # the routing checks themselves).
    assert got.profile["engine_dispatch"] >= (
        got.profile["engine_dispatch_submit"]
        + got.profile["engine_dispatch_wait"])


# ---------------------------------------------------------------------------
# the chunked replay's routes and the per-step engine


def test_stream_auto_raises_on_chunked_replay_signatures():
    """Under ``stream="auto"`` (the default) a stream past
    ``STREAM_THRESHOLD`` and a tenant mix go through the chunked replay
    (they raised before it was ported): the reports equal the reference's,
    and ``stream="off"`` still runs the tenant mix through the megabatch,
    as the reference does."""
    jspec, tspec = _specs()
    jbig = jspec.replace(**{"traffic.n_requests": 1000})
    big = tspec.replace(**{"traffic.n_requests": 1000})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tsw, "STREAM_THRESHOLD", 999)
        m.setattr(jsw, "STREAM_THRESHOLD", 999)
        _same_scalar_json(jbig, big, {"lam": [10.0]})
    mix = tspec.replace(traffic=ttr.tenant_mix(
        ttr.TenantSpec("a", rate=50.0, n_pages=40),
        ttr.TenantSpec("b", rate=20.0, n_pages=60), n_requests=200))
    jmix = _specs()[0].replace(traffic=jtr.tenant_mix(
        jtr.TenantSpec("a", rate=50.0, n_pages=40),
        jtr.TenantSpec("b", rate=20.0, n_pages=60), n_requests=200))
    got = _same_scalar_json(jmix, mix, {"lam": [10.0]})
    assert all(len(r.tenants) == 2 for r in got.reports)
    _same_scalar_json(jmix, mix, {"store.policy": ["ws", "lru"]},
                      stream="off")


def test_scan_engine_and_default_device_raise(monkeypatch):
    """``engine="scan"`` runs the megabatch through the per-step engine
    (it raised before the chunked-replay port): the reference's
    ``engine="scan"`` reports; the default device still needs a card."""
    import torch
    jspec, tspec = _specs()
    _same_scalar_json(jspec, tspec, {"store.policy": ["ws", "random"]},
                      engine="scan")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.sweep(tspec, {"lam": [10.0]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.mrc_curve(tspec.replace(**{"store.policy": "lru"}), [4, 8])
