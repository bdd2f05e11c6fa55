"""The whole miss-rate-vs-cache-size curve from one pass (paper §V's
capacity-planning question, answered without a per-size sweep).

  PYTHONPATH=src python -m repro_torch.examples.mrc_curve

``store.n_lines`` is *structural* to the cache-scan engine — every cache
size costs a fresh pass over the stream. For LRU the Mattson
stack-distance result collapses that loop: one reuse-distance pass (the
reuse-distance kernel on the card) yields exact hit/miss/write-back
counters for **every** size at once (``repro_torch.sim.mrc``), and
``sweep(mrc="auto")`` routes size-only axes through it automatically.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.traffic import TrafficSpec
from repro_torch.sim import (RateSpec, SimSpec, mrc_curve,
                             mrc_tier1_counters, simulate, sweep)
from repro_torch.sim.engine import tier1_counters
from repro_torch.sim.sweep import (engine_compile_count,
                                   reset_engine_compile_count)
from repro_torch.storage.tiered_store import StoreConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    # The §V workload, under the LRU expert (the stack-distance domain).
    spec = SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=4000, n_pages=1024,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=128, policy="lru"),
        n_shards=4,
        mapping="block",
        lam=200.0,
    )

    print("=== 1. The full miss-rate curve from one distance pass ===")
    sizes = sorted(int(s) for s in
                   np.unique(np.round(np.geomspace(1, 2048, 40)).astype(int)))
    sz, mr = mrc_curve(spec, sizes, device=dev)
    print(f"  {len(sz)} cache sizes, one pass, no cache simulation:")
    step = max(1, len(sz) // 10)
    for c, r in list(zip(sz, mr))[::step]:
        bar = "#" * int(r * 40)
        print(f"  n_lines={c:>5}  miss_rate={r:.3f}  {bar}")

    print("\n=== 2. Exactness: the paper's cache size, engine vs MRC ===")
    C = spec.store.n_lines
    eng = tier1_counters(spec, device=dev)
    one = mrc_tier1_counters(spec, [C], device=dev)[C]
    same = all(
        np.array_equal(np.asarray(getattr(one, f)),
                       np.asarray(getattr(eng, f)))
        for f in eng._fields)
    print(f"  n_lines={C}: all Tier1Counters fields bit-identical "
          f"to the scan engine: {same}")
    print(f"  hits={int(one.hits.sum())} misses={int(one.misses.sum())} "
          f"tier2_writes={int(one.tier2_writes.sum())} "
          f"evictions={int(one.evictions.sum())}")
    assert same

    print("\n=== 3. §V worked example at its cache size, via the MRC path "
          "===")
    worked_spec = spec.replace(
        lam=100.0, rates=RateSpec(source="paper"), p12_override=0.2)
    reset_engine_compile_count()
    res = sweep(worked_spec,
                {"store.n_lines": [32, 64, 128, 256, 512, 1024]}, device=dev)
    print(f"  6-size capacity sweep: {engine_compile_count()} engine "
          f"compiles (the curve rode the distance pass)")
    print(f"  {'n_lines':>8} {'miss_rate':>10} {'lam_eff':>8} "
          f"{'response_ms':>12}")
    for row in res.rows():
        print(f"  {row['store.n_lines']:>8} {row['miss_rate']:>10.3f} "
              f"{row['lam_eff']:>8.1f} {row['response_s']*1e3:>12.3f}")
    worked = simulate(worked_spec, device=dev)
    at_128 = next(r for r in res.rows() if r["store.n_lines"] == 128)
    print(f"  at the paper's n_lines=128: lam_eff={at_128['lam_eff']:.1f} "
          f"(direct simulate(): {worked.lam_eff:.1f}, published: 86.6)")
    print("mrc_curve OK")


if __name__ == "__main__":
    main()
