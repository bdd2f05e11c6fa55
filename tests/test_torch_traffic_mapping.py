"""Host-side inputs of the port against the reference: traffic streams
byte for byte, §III mappings and failover owners integer for integer."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import mapping as jmap
from repro.core import traffic as jtr
from repro_torch.core import mapping as tmap
from repro_torch.core import traffic as ttr

_KINDS = {
    "irm": dict(kind="irm", n_requests=1500, n_pages=400,
                write_fraction=0.3, seed=3),
    "poisson": dict(kind="poisson", n_requests=1200, n_pages=300,
                    write_fraction=0.2, seed=4, rate=100.0),
    "strided": dict(kind="strided", n_requests=900, n_pages=5000,
                    stride=3, n_streams=2, seed=5),
    "markov": dict(kind="markov", n_requests=1000, n_pages=256, seed=6,
                   write_fraction=0.1),
    "onoff": dict(kind="onoff", n_requests=1600, n_pages=500, seed=7,
                  rate=200.0, write_fraction=0.25),
}


def _phased(mod):
    return mod.phase_schedule(
        mod.TrafficSpec(kind="irm", n_requests=700, n_pages=300, seed=1,
                        rate=100.0),
        mod.TrafficSpec(kind="poisson", n_requests=500, n_pages=200, seed=2,
                        rate=400.0, write_fraction=0.5),
        seed=8)


def _specs(name):
    if name == "phased":
        return _phased(jtr), _phased(ttr)
    return jtr.TrafficSpec(**_KINDS[name]), ttr.TrafficSpec(**_KINDS[name])


def _assert_bytes_equal(a, b, ctx):
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f"{ctx}[{i}]"
        assert x.tobytes() == y.tobytes(), f"{ctx}[{i}]"


@pytest.mark.parametrize("kind", [*_KINDS, "phased"])
def test_make_stream_byte_identical(kind):
    js, ts = _specs(kind)
    _assert_bytes_equal(jtr.make_stream(js), ttr.make_stream(ts), kind)


@pytest.mark.parametrize("kind", [*_KINDS, "phased"])
def test_make_timed_stream_byte_identical(kind):
    js, ts = _specs(kind)
    _assert_bytes_equal(jtr.make_timed_stream(js, default_rate=300.0),
                        ttr.make_timed_stream(ts, default_rate=300.0), kind)


@pytest.mark.parametrize("policy", ["block", "round_robin", "random",
                                    "block_cyclic"])
@pytest.mark.parametrize("n_shards", [1, 3, 16])
def test_page_to_shard_integer_identical(policy, n_shards):
    rng = np.random.default_rng(0)
    pages = np.concatenate([
        rng.integers(0, 5000, 2000),
        np.array([0, 1, 2**31 - 1, 2**30 + 12345, 65535, 65536]),
    ]).astype(np.int32)
    n_pages = 5000
    want = np.asarray(jmap.page_to_shard(jnp.asarray(pages), n_shards,
                                         n_pages, policy))
    got = tmap.page_to_shard(pages, n_shards, n_pages, policy)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_unknown_mapping_rejected():
    with pytest.raises(ValueError, match="unknown mapping policy"):
        tmap.page_to_shard(np.arange(4), 2, 4, "hash")


@pytest.mark.parametrize("down", [
    [(1, 0.5, 2.0)],
    [(0, 0.0, 1.0), (2, 0.5, 3.0)],
    [(0, 0.0, 5.0), (1, 0.0, 5.0), (2, 0.0, 5.0)],   # every shard down
])
def test_apply_failover_identical(down):
    rng = np.random.default_rng(1)
    owner = rng.integers(0, 3, 800).astype(np.int32)
    times = np.sort(rng.random(800) * 4.0)
    want = jmap.apply_failover(owner, times, down, 3)
    got = tmap.apply_failover(owner, times, down, 3)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_apply_failover_rejects_bad_shard():
    with pytest.raises(ValueError, match="out of range"):
        tmap.apply_failover(np.zeros(3, np.int32), np.zeros(3),
                            [(5, 0.0, 1.0)], 3)
