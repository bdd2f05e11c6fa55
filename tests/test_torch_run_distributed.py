"""The port's distributed tier-1 engine against the reference:
``run_distributed`` over mapping x windows x wall-clock binning x policy x
prefetch, and precomputed (failover) owners with an empty shard. Every
``StreamStats`` field must be equal, integers exactly and f32 weights bit
for bit; the shard rows run as one batch through the plain version."""
import numpy as np
import pytest

from repro.core import traffic as jtr
from repro.storage import tiered_store as J
from repro_torch.storage import tiered_store as T
from test_torch_cache_scan import _assert_stats_equal, _cfgs, _stream


_DIST = [
    ("block", 1, False, "ws", False),
    ("round_robin", 4, False, "lru", True),
    ("random", 6, True, "ws", True),
    ("block_cyclic", 3, True, "random", False),
    ("random", 8, False, "lfu", False),
]


@pytest.mark.parametrize("mapping,n_windows,timed,policy,prefetch", _DIST)
def test_run_distributed_plain_matches_reference(mapping, n_windows, timed,
                                                 policy, prefetch):
    spec = dict(kind="irm", n_requests=1500, n_pages=400,
                write_fraction=0.3, seed=3, rate=300.0)
    pages, writes, times = jtr.make_timed_stream(jtr.TrafficSpec(**spec))
    kw = dict(n_shards=3, mapping=mapping, n_windows=n_windows, seed=4)
    if timed:
        kw.update(timestamps=times, window_dt=5.0 / n_windows)
    jc, tc = _cfgs(n_lines=24, policy=policy, prefetch=prefetch)
    want, want_counts = J.run_distributed(jc, pages, writes, **kw)
    got, got_counts = T.run_distributed(tc, pages, writes, device="cpu",
                                        **kw)
    np.testing.assert_array_equal(got_counts, want_counts)
    _assert_stats_equal(want, got, f"{mapping}/W={n_windows}/t={timed}")


def test_failover_owner_and_empty_shard_match():
    """Precomputed owners (one shard left empty): the phantom-miss
    correction of a pure-padding row."""
    pages, writes = _stream(3, n=400)
    owner = (pages % 2).astype(np.int32) * 2      # shard 1 gets nothing
    jc, tc = _cfgs(n_lines=16)
    want, _ = J.run_distributed(jc, pages, writes, n_shards=3, owner=owner,
                                n_windows=2)
    got, _ = T.run_distributed(tc, pages, writes, n_shards=3, owner=owner,
                               n_windows=2, device="cpu")
    _assert_stats_equal(want, got, "owner")
    assert int(got.requests[1]) == 0 and int(got.misses[1]) == 0
