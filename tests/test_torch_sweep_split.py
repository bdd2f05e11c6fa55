"""The sweep's point split over several devices, on the CPU.

``repro_torch.sim.sweep(..., devices=("cpu", "cpu"))`` with 3 points (an
odd count, so the point axis is padded up to the device multiple) equals
the unbatched sweep field for field, as the reference's
``tests/sweep_multidevice_script.py`` requires of its ``shard_map``
split; and with 2 and 4 devices equals the one-device megabatch, report
for report.
"""
import pytest

from repro_torch.core.traffic import TrafficSpec
from repro_torch.sim import RateSpec, SimSpec, sweep
from repro_torch.storage.tiered_store import StoreConfig

BASE = SimSpec(
    traffic=TrafficSpec(kind="irm", n_requests=400, n_pages=128,
                        write_fraction=0.2, seed=9),
    store=StoreConfig(n_lines=16, policy="ws"),
    n_shards=2,
    lam=20.0,
    rates=RateSpec(source="paper"),
)
AXES = {"store.policy": ["ws", "lru", "lfu"]}
FIELDS = ("requests", "hits", "misses", "tier2_reads", "tier2_writes",
          "evictions")


def test_split_matches_unbatched():
    a = sweep(BASE, AXES, batch=True, device="cpu", devices=("cpu", "cpu"))
    b = sweep(BASE, AXES, batch=False, device="cpu")
    for pt, ra, rb in zip(a.points, a.reports, b.reports):
        for name in FIELDS:
            assert getattr(ra, name) == getattr(rb, name), (pt, name)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_split_matches_one_device(n_dev):
    axes = {"store.policy": ["ws", "lru", "lfu"], "store.beta": [0.5, 0.9]}
    one = sweep(BASE, axes, device="cpu", report="scalar")
    split = sweep(BASE, axes, device="cpu", devices=("cpu",) * n_dev,
                  report="scalar")
    assert [r.to_dict() for r in split.reports] == [
        r.to_dict() for r in one.reports]
