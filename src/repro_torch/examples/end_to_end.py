"""End-to-end tiered-storage simulation in one call (paper §V, composed).

  PYTHONPATH=src python -m repro_torch.examples.end_to_end

Walks the full pipeline the paper assembles by hand: a declarative
workload flows through the distributed tier-1 cache shards (the
cache-scan kernel on the card), the measured miss/write-back counters
become queuing-network inputs, and device behavioral models supply the
service rates. Then sweeps cache size to show the capacity-planning use
case.
"""
from __future__ import annotations

import argparse

from repro_torch.core.traffic import TrafficSpec
from repro_torch.sim import RateSpec, SimSpec, simulate, sweep
from repro_torch.storage.tiered_store import StoreConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    print("=== 1. One scenario end to end (fitted device rates) ===")
    spec = SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=4000, n_pages=1024,
                            write_fraction=0.3, seed=7),
        store=StoreConfig(n_lines=128, policy="ws"),
        n_shards=4,
        mapping="block",
        lam=200.0,
    )
    rep = simulate(spec, device=dev)
    print(f"  {rep.requests} requests over {spec.n_shards} shards "
          f"({spec.mapping} mapping, {spec.store.policy} policy)")
    print(f"  miss_rate={rep.miss_rate:.3f}  tier2: {rep.tier2_reads} reads, "
          f"{rep.tier2_writes} write-backs, {rep.evictions} evictions")
    print(f"  mu1={rep.rates.mu1:.0f}/s mu2={rep.rates.mu2:.1f}/s "
          f"(fitted NVMe/HDD behavioral models)")
    print(f"  queuing: lam_eff={rep.lam_eff:.1f} rho1={rep.rho1:.4f} "
          f"rho2={rep.rho2:.3f} response={rep.response_s*1e3:.3f} ms "
          f"equilibrium={rep.equilibrium}")
    print(f"  min-time model (eqs 1-4): T={rep.t_total_s:.4f}s -> "
          f"{rep.min_time_throughput_rps:.0f} req/s")
    for s in rep.shards:
        print(f"    shard {s.shard}: {s.requests:5d} reqs p12={s.p12:.3f} "
              f"w1={s.w1*1e3:.3f}ms w2={s.w2*1e3:.2f}ms")

    print("\n=== 2. The §V worked example through the same pipeline ===")
    worked = simulate(spec.replace(
        lam=100.0, rates=RateSpec(source="paper"), p12_override=0.2),
        device=dev)
    print("  paper constants mu1=1000 mu2=33, p12 pinned to 0.2:")
    print(f"  lam_eff={worked.lam_eff:.1f} (published: 86.6) "
          f"rho1={worked.rho1:.4f} rho2={worked.rho2:.3f}")

    print("\n=== 3. Capacity planning: sweep cache size x policy ===")
    res = sweep(spec.replace(lam=100.0),
                {"store.n_lines": [32, 128, 512],
                 "store.policy": ["lru", "ws"]}, device=dev)
    print(f"  {'n_lines':>8} {'policy':>7} {'miss_rate':>10} "
          f"{'response_ms':>12}")
    for row in res.rows():
        print(f"  {row['store.n_lines']:>8} {row['store.policy']:>7} "
              f"{row['miss_rate']:>10.3f} {row['response_s']*1e3:>12.3f}")
    best = min(res.rows(), key=lambda r: r["response_s"])
    print(f"  -> best response: n_lines={best['store.n_lines']} "
          f"policy={best['store.policy']}")
    print("end_to_end OK")


if __name__ == "__main__":
    main()
