"""The port's miss-rate-curve route on the CPU against the reference:
``repro_torch.sim.mrc_tier1_counters`` equal to ``repro.sim.
mrc_tier1_counters`` in every ``Tier1Counters`` field at many cache sizes
(the cases of ``test_reuse_distance.py``: adversarial patterns, writes
over the whole stream, windowed write-free traffic, timed windows, a trace
with timestamps), the same ``ValueError`` messages outside the exact
domain, and ``mrc_curve``. The distance pass runs through the plain
version (the CPU path of ``reuse_distances``)."""
import numpy as np
import pytest

import repro.sim as J
import repro_torch.sim as T
from repro.core import traffic as jtr
from repro.storage import tiered_store as jts
from repro_torch.core import traffic as ttr
from repro_torch.storage import tiered_store as tts

_BASE = dict(
    traffic=dict(kind="irm", n_requests=240, n_pages=48, write_fraction=0.0,
                 seed=9),
    store=dict(n_lines=8, policy="lru"), n_shards=3, lam=120.0)


def _specs(over=None, **kw):
    """The same spec in both packages, with dotted-path overrides."""
    fields = {**_BASE, **kw}
    out = []
    for sim, tr, ts in ((J, jtr, jts), (T, ttr, tts)):
        spec = sim.SimSpec(traffic=tr.TrafficSpec(**fields["traffic"]),
                           store=ts.StoreConfig(**fields["store"]),
                           **{k: v for k, v in fields.items()
                              if k not in ("traffic", "store")})
        out.append(spec.replace(**(over or {})))
    return out


def _assert_mrc_equal(jspec, tspec, sizes, trace=None, ctx=""):
    want = J.mrc_tier1_counters(jspec, sizes, trace=trace)
    got = T.mrc_tier1_counters(tspec, sizes, trace=trace, device="cpu")
    assert sorted(got) == sorted(want)
    for C in want:
        for f in want[C]._fields:
            x = np.asarray(getattr(want[C], f))
            y = np.asarray(getattr(got[C], f))
            assert x.dtype == y.dtype, f"{ctx} C={C} field={f}"
            np.testing.assert_array_equal(y, x, err_msg=f"{ctx} C={C} {f}")


def _adversarial(n_lines, n):
    rng = np.random.default_rng(13)
    hot = rng.integers(0, 12, n)
    hot[rng.random(n) < 0.5] = 0
    return {
        "all-unique": np.arange(n),
        "single-hot-key": hot,
        "cycle-7": np.arange(n) % (n_lines - 1),
        "cycle-8": np.arange(n) % n_lines,
        "cycle-9": np.arange(n) % (n_lines + 1),
    }


@pytest.mark.parametrize("pattern", ["all-unique", "single-hot-key",
                                     "cycle-7", "cycle-8", "cycle-9"])
def test_adversarial_patterns_whole_stream(pattern):
    pages = _adversarial(8, 160)[pattern]
    trace = (pages, np.zeros(len(pages), bool))
    _assert_mrc_equal(*_specs(), [1, 7, 8, 9, 64], trace=trace, ctx=pattern)


@pytest.mark.parametrize("pattern", ["all-unique", "cycle-8", "cycle-9"])
def test_adversarial_patterns_windowed(pattern):
    pages = _adversarial(8, 160)[pattern]
    trace = (pages, np.zeros(len(pages), bool))
    _assert_mrc_equal(*_specs(n_windows=5), [7, 8, 9], trace=trace,
                      ctx=pattern)


def test_writes_whole_stream():
    """Write-backs from the episode intervals, at sizes below and beyond
    the working set."""
    _assert_mrc_equal(*_specs({"traffic.write_fraction": 0.35}),
                      [1, 2, 5, 8, 11, 48, 200], ctx="writes")


def test_windowed_write_free_traffic():
    _assert_mrc_equal(*_specs({"traffic.kind": "markov"}, n_windows=4),
                      [1, 8, 16, 64], ctx="windowed")


def test_timed_windows():
    _assert_mrc_equal(*_specs(window_dt=0.4), [4, 8, 32], ctx="timed")


def test_trace_with_timestamps():
    rng = np.random.default_rng(3)
    pages = rng.integers(0, 30, 300)
    times = np.sort(rng.uniform(0.0, 2.0, 300))
    _assert_mrc_equal(*_specs(window_dt=0.5), [2, 8, 30],
                      trace=(pages, np.zeros(300, bool), times),
                      ctx="trace-timed")


def test_shard_down_and_random_mapping():
    jspec, tspec = _specs({"traffic.rate": 120.0}, window_dt=0.5,
                          mapping="random")
    jspec = jspec.replace(faults=J.FaultSpec(events=(J.shard_down(1, 0.5,
                                                                  1.2),)))
    tspec = tspec.replace(faults=T.FaultSpec(events=(T.shard_down(1, 0.5,
                                                                  1.2),)))
    _assert_mrc_equal(jspec, tspec, [3, 8, 20], ctx="shard_down")


def test_mrc_curve_matches_reference():
    jspec, tspec = _specs({"traffic.write_fraction": 0.2})
    sizes = [64, 2, 8, 8, 16]
    js, jm = J.mrc_curve(jspec, sizes)
    ts, tm = T.mrc_curve(tspec, sizes, device="cpu")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("over,match", [
    ({"store.policy": "lfu"}, "only for policy='lru'"),
    ({"store.policy": "ws"}, "only for policy='lru'"),
    ({"store.policy": "random"}, "only for policy='lru'"),
    ({"store.prefetch": True}, "prefetch"),
])
def test_same_value_errors(over, match):
    jspec, tspec = _specs(over)
    assert T.mrc_unsupported_reason(tspec) == J.mrc_unsupported_reason(jspec)
    with pytest.raises(ValueError, match=match) as want:
        J.mrc_tier1_counters(jspec, [8])
    with pytest.raises(ValueError, match=match) as got:
        T.mrc_tier1_counters(tspec, [8], device="cpu")
    assert str(got.value) == str(want.value)


def test_windowed_writes_and_bad_sizes_raise_the_same():
    jspec, tspec = _specs({"traffic.write_fraction": 0.3}, n_windows=4)
    assert T.mrc_unsupported_reason(tspec) == J.mrc_unsupported_reason(jspec)
    assert "window" in T.mrc_unsupported_reason(tspec)
    for sizes, match in (([8], "write-free"), ([], "non-empty"),
                         ([0, 4], ">= 1")):
        with pytest.raises(ValueError, match=match) as want:
            J.mrc_tier1_counters(jspec, sizes)
        with pytest.raises(ValueError, match=match) as got:
            T.mrc_tier1_counters(tspec, sizes, device="cpu")
        assert str(got.value) == str(want.value)
