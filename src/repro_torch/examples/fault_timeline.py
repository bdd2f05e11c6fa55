"""Fault timeline: a shard dies, traffic fails over, the cache re-warms —
and the retry policy decides whether the cluster recovers at all.

  PYTHONPATH=src python -m repro_torch.examples.fault_timeline

Act 1 walks one outage through the engine: shard 1 goes down for three
seconds, its key range fails over to survivors (deterministic cyclic
remap, so the same keys land on the same survivor), and on recovery the
shard re-warms from a cold cache — post-recovery windows show the miss
spike that tier 2 has to absorb.

Act 2 replays the same degraded interval under two client retry policies
with the *same* retry budget. Hot timeouts with no backoff re-offer
timed-out work immediately: the queue never drains and the solve flags a
trailing metastable run (a retry storm — the system would be stable
without the feedback). Capped exponential backoff spreads the re-offers
and the backlog drains within a few windows of recovery.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.queuing import fluid_two_tier
from repro_torch.core.traffic import TrafficSpec
from repro_torch.sim import (FaultSpec, RateSpec, RetryPolicy, SimSpec,
                             shard_down, simulate)
from repro_torch.storage.tiered_store import StoreConfig

OUTAGE = (3.0, 6.0)  # shard 1 down over [3s, 6s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    base = SimSpec(
        traffic=TrafficSpec(kind="irm", n_requests=2400, n_pages=256,
                            zipf_s=0.9, seed=11, rate=160.0),
        store=StoreConfig(n_lines=64, policy="lru"),
        n_shards=4,
        lam=40.0,
        rates=RateSpec(mu1=100.0, mu2=33.0),
        p12_override=0.15,
        window_dt=1.0,
    )

    # --- Act 1: outage, failover, cold-cache recovery ---------------------
    healthy = simulate(base, device=dev)
    faulted = simulate(base.replace(
        faults=FaultSpec(events=(shard_down(1, *OUTAGE),))), device=dev)

    req_h = np.asarray(healthy.windows.requests)
    req_f = np.asarray(faulted.windows.requests)
    mis_h = np.asarray(healthy.windows.misses)
    mis_f = np.asarray(faulted.windows.misses)

    print(f"=== shard 1 down over [{OUTAGE[0]:.0f}s, {OUTAGE[1]:.0f}s), "
          f"{faulted.n_windows} windows of {faulted.window_duration_s:.0f}s "
          f"===")
    print(f"  {'win':>4} {'shard1_req':>11} {'survivors_req':>14} "
          f"{'shard1_miss':>12} {'note'}")
    for w in range(faulted.n_windows):
        t0, t1 = w * 1.0, (w + 1) * 1.0
        note = ""
        if t0 >= OUTAGE[0] and t1 <= OUTAGE[1]:
            note = "down -> failover"
        elif t0 >= OUTAGE[1] and mis_f[1, w] > mis_h[1, w]:
            note = "cold-cache refill"
        surv = int(req_f[0, w] + req_f[2, w] + req_f[3, w])
        print(f"  {w:>4} {int(req_f[1, w]):>11} {surv:>14} "
              f"{int(mis_f[1, w]):>12} {note}")

    down_w = slice(int(OUTAGE[0]), int(OUTAGE[1]))
    moved = int(req_h[1, down_w].sum())
    extra_miss = int(faulted.misses - healthy.misses)
    print(f"\nfailover moved {moved} requests off shard 1 "
          f"(per-window totals conserved: "
          f"{bool((req_f.sum(0) == req_h.sum(0)).all())}); "
          f"re-warming after recovery cost {extra_miss} extra misses "
          f"served from tier 2.")

    # --- Act 2: same outage, two retry policies ---------------------------
    # Degrade all tier-1 devices harder + a burst of external load so the
    # outage leaves real backlog, then compare retry policies on the drain.
    aggressive = RetryPolicy(timeout=0.2, max_retries=4,
                             backoff_base=1.0, backoff_init=0.2)
    capped = RetryPolicy(timeout=0.2, max_retries=4,
                         backoff_base=4.0, backoff_init=0.5, backoff_cap=8.0)

    lam_t = np.array([30.0] * 4 + [130.0] * 2 + [30.0] * 18)
    p12_t = np.full_like(lam_t, 0.1)
    print("\n=== same burst, two retry policies (mu1=100/s, k=1) ===")
    print(f"  {'win':>4} {'lam_ext':>8} {'q1_aggressive':>14} "
          f"{'q1_capped':>10} {'q1_no_retry':>12}")
    agg = fluid_two_tier(lam_t, p12_t, 100.0, 33.0, dt=1.0, retry=aggressive)
    cap = fluid_two_tier(lam_t, p12_t, 100.0, 33.0, dt=1.0, retry=capped)
    non = fluid_two_tier(lam_t, p12_t, 100.0, 33.0, dt=1.0)
    for w in range(0, len(lam_t), 2):
        print(f"  {w:>4} {lam_t[w]:>8.0f} {agg.q1[w]:>14.2f} "
              f"{cap.q1[w]:>10.2f} {non.q1[w]:>12.2f}")

    agg_on = int(agg.metastable_onset())
    cap_on = int(cap.metastable_onset())
    print(f"\naggressive policy: metastable from window {agg_on} — external "
          f"load is back to {lam_t[-1]:.0f}/s (< capacity 100/s) but "
          f"retries re-offer {float(agg.retry_rate[-1]):.0f}/s on top, so "
          f"the queue never drains (a retry storm).")
    print(f"capped backoff: metastable onset {cap_on} (never) — backlog "
          f"drains to q1={float(cap.q1[-1]):.2f} within a few windows; "
          f"time-to-recovery is set by the drain rate, not the retry rate.")
    assert agg_on >= 0 and cap_on == -1
    print("fault_timeline OK")


if __name__ == "__main__":
    main()
