"""The port's §VII configurator on the CPU against ``repro.core.configurator``.

``miss_rate_curve`` and ``configure`` on the inputs of
``tests/test_system.py::test_configurator_prefers_equilibrium`` and of
``examples/configure_from_model.py``: the miss rates exact (one
cache-scan row a size, counters equal), ``rho1``, ``rho2``, ``w1``, ``w2``
and ``predicted_time_s`` equal (the queuing code is a copy), and the
candidates in the same order. Plus the port's counterpart of
``test_configurator_prefers_equilibrium``.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import configurator as jconf
from repro.core.traffic import TrafficSpec as JSpec
from repro_torch.core import configurator as tconf
from repro_torch.core.traffic import TrafficSpec as TSpec

CASES = {
    "test_system": (dict(kind="poisson", n_requests=600, n_pages=128),
                    dict(arrival_rate=100.0, cache_sizes=(16, 64),
                         k_threads=(1, 16))),
    "configure_from_model": (dict(kind="irm", n_requests=2000, n_pages=512,
                                  seed=0),
                             dict(arrival_rate=200.0,
                                  cache_sizes=(32, 64, 128, 256),
                                  k_threads=(1, 4, 16))),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    spec, kw = CASES[case]
    return jconf.configure(JSpec(**spec), **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_miss_rate_curve_matches_reference(case):
    """The port's curve against the miss rates of the reference's
    ``configure`` (which measures them with its own ``miss_rate_curve``)."""
    spec, kw = CASES[case]
    want = sorted({(c.n_lines, c.miss_rate) for c in _reference(case)})
    got = tconf.miss_rate_curve(TSpec(**spec), kw["cache_sizes"],
                                device="cpu")
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_configure_matches_reference(case):
    """Every field of every candidate equal, in the same order."""
    spec, kw = CASES[case]
    want = _reference(case)
    got = tconf.configure(TSpec(**spec), device="cpu", **kw)
    assert len(got) == len(want) == len(kw["cache_sizes"]) * len(
        kw["k_threads"])
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd.keys() == wd.keys()
        for k in wd:
            assert np.array_equal(np.asarray(gd[k]), np.asarray(wd[k])), (
                case, k, gd[k], wd[k])


def test_configurator_prefers_equilibrium():
    spec = TSpec(kind="poisson", n_requests=600, n_pages=128)
    cands = tconf.configure(spec, arrival_rate=100.0, cache_sizes=(16, 64),
                            k_threads=(1, 16), device="cpu")
    assert cands, "no candidates"
    best = cands[0]
    assert best.equilibrium
    # bigger cache => lower (or equal) miss rate among candidates
    by_size = {c.n_lines: c.miss_rate for c in cands}
    assert by_size[64] <= by_size[16]
    # equilibrium candidates first, each group by predicted time
    keys = [(not c.equilibrium, c.predicted_time_s) for c in cands]
    assert keys == sorted(keys)


def test_configure_defaults_to_the_card():
    """``device=None`` means the card: without one it raises, it does not
    carry on on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconf.configure(TSpec(kind="poisson", n_requests=60, n_pages=16),
                        arrival_rate=10.0, cache_sizes=(4,), k_threads=(1,))
