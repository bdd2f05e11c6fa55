"""Use the performance models to *configure* a two-tier system (§VII):
given a workload and a target arrival rate, sweep (cache size x IO threads)
through the miss-rate curve + queuing network, and print the equilibrium
frontier.

  PYTHONPATH=src python -m repro_torch.examples.configure_from_model

Each cache size is one run of the tier-1 engine: one cache-scan launch on
the card (``--device cpu``: its plain version).
"""
from __future__ import annotations

import argparse

from repro_torch.core.configurator import configure, miss_rate_curve
from repro_torch.core.traffic import TrafficSpec

SPEC = TrafficSpec(kind="irm", n_requests=2000, n_pages=512, seed=0)
SWEEP = dict(arrival_rate=200.0, cache_sizes=(32, 64, 128, 256),
             k_threads=(1, 4, 16))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device

    print("miss-rate curve (Fig. 3 machinery):")
    for n, mr in miss_rate_curve(SPEC, (32, 64, 128, 256), device=dev):
        print(f"  cache={n:4d} lines  miss_rate={mr:.3f}")

    print("\nconfiguration sweep @ arrival 200 req/s (queuing + device "
          "models):")
    cands = configure(SPEC, device=dev, **SWEEP)
    print(f"  {'lines':>6} {'k':>3} {'miss':>6} {'rho1':>6} {'rho2':>6} "
          f"{'eq':>3} {'T_pred(s)':>10}")
    for c in cands[:8]:
        print(f"  {c.n_lines:6d} {c.k_threads:3d} {c.miss_rate:6.3f} "
              f"{c.rho1:6.3f} {c.rho2:6.3f} {str(c.equilibrium)[:1]:>3} "
              f"{c.predicted_time_s:10.2f}")
    best = cands[0]
    print(f"\nchosen: {best.n_lines} lines x {best.k_threads} threads "
          f"(miss {best.miss_rate:.3f}, predicted "
          f"{best.predicted_time_s:.2f}s)")
    print("configure_from_model OK")
    return cands


if __name__ == "__main__":
    main()
