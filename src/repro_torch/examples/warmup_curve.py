"""Time-resolved telemetry: warm-up curves and saturation onset.

  PYTHONPATH=src python -m repro_torch.examples.warmup_curve

The paper analyzes the two-tier store at equilibrium (§V); this example
shows what that summary hides. ``SimSpec.n_windows`` resolves every engine
counter over time windows of the request stream and re-solves the queuing
network per window (piecewise-stationary transient analysis):

1. a cold cache warming up — early windows miss hard, the tail converges
   to the steady-state report;
2. a phased workload drifting into overload — the report pinpoints the
   saturation-onset window (first window with utilization >= 1);
3. checkpoint bursts (on/off modulation) and their write-backs.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.traffic import TrafficSpec, phase_schedule
from repro_torch.sim import RateSpec, SimSpec, simulate
from repro_torch.storage.tiered_store import StoreConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    print("=== 1. Cold-cache warm-up curve (markov traffic, LRU) ===")
    spec = SimSpec(
        traffic=TrafficSpec(kind="markov", n_requests=4000, n_pages=256,
                            n_hot_states=24, seed=5),
        store=StoreConfig(n_lines=64, policy="lru"),
        n_shards=2,
        mapping="block_cyclic",
        lam=40.0,
        rates=RateSpec(source="paper"),
        n_windows=10,
    )
    rep = simulate(spec, device=dev)
    print(f"  {rep.requests} requests in {rep.n_windows} windows of "
          f"{rep.window_duration_s:.2f}s")
    print(f"  {'window':>7} {'p12':>7} {'rho2':>7} {'response_ms':>12}")
    for w in range(rep.n_windows):
        print(f"  {w:>7} {rep.transient.p12[w]:>7.3f} "
              f"{rep.transient.rho2[w]:>7.3f} "
              f"{rep.transient.response[w]*1e3:>12.3f}")
    print(f"  steady-state report (whole stream): p12={rep.p12:.3f} "
          f"response={rep.response_s*1e3:.3f} ms")
    print(f"  -> cold start misses "
          f"{rep.transient.p12[0]/rep.transient.p12[-1]:.1f}x "
          f"harder than the warmed-up tail")

    print("\n=== 2. Saturation onset: a warm phase, then a flood ===")
    warm = TrafficSpec(kind="strided", n_requests=800, n_pages=64, stride=1,
                       seed=1)
    flood = TrafficSpec(kind="irm", n_requests=800, n_pages=4096, zipf_s=0.8,
                        seed=2)
    drift = simulate(SimSpec(
        traffic=phase_schedule(warm, flood),
        store=StoreConfig(n_lines=64, policy="lru"),
        n_shards=2,
        mapping="block_cyclic",
        lam=50.0,
        rates=RateSpec(source="paper"),
        n_windows=8,
    ), device=dev)
    print(f"  phase boundary at window {drift.n_windows // 2}; "
          f"measured rho2 per window:")
    print("  " + "  ".join(f"{v:.2f}"
                           for v in np.asarray(drift.transient.rho2)))
    print(f"  equilibrium (whole-stream view): {drift.equilibrium}")
    print(f"  saturation onset: window {drift.saturation_onset} "
          f"(first window with rho >= 1)")
    onsets = [s.saturation_onset for s in drift.shards]
    print(f"  per-shard onsets (mapping skew included): {onsets}")

    print("\n=== 3. Checkpoint bursts (on/off modulation) ===")
    bursty = simulate(SimSpec(
        traffic=TrafficSpec(kind="onoff", n_requests=1600, n_pages=512,
                            on_len=100, off_len=300, burst_pages=16, seed=3),
        store=StoreConfig(n_lines=16, policy="lru"),
        n_shards=2,
        mapping="block_cyclic",
        lam=30.0,
        rates=RateSpec(source="paper"),
        n_windows=8,
    ), device=dev)
    t2w = np.asarray(bursty.windows.tier2_writes).sum(axis=0)
    print(f"  tier-2 write-backs per window: {t2w.tolist()} "
          f"(dirty checkpoint pages flushed after each burst)")
    print("  p12 per window: "
          + " ".join(f"{v:.2f}" for v in np.asarray(bursty.transient.p12)))
    print("warmup_curve OK")


if __name__ == "__main__":
    main()
