"""Burst response: MMPP checkpoint bursts through the fluid transient path.

  PYTHONPATH=src python -m repro_torch.examples.burst_response

An on/off (MMPP-style) workload alternates Zipf-read background traffic
with checkpoint write bursts arriving 10x faster. With wall-clock windows
(``SimSpec.window_dt``) the per-window arrival rate is *measured* from the
arrival timestamps, and the default fluid transient solver carries queue
backlog across windows — so the report shows what the burst actually does
to latency: a peak during the burst and a multi-window drain after it,
where the window-independent piecewise solve snaps back instantly.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.traffic import TrafficSpec
from repro_torch.sim import RateSpec, SimSpec, simulate
from repro_torch.storage.tiered_store import StoreConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    spec = SimSpec(
        traffic=TrafficSpec(
            kind="onoff", n_requests=6000, n_pages=512,
            rate=120.0,          # background arrival rate (aggregate req/s)
            burst_rate=1200.0,   # checkpoint stripes stream 10x faster
            on_len=300, off_len=1700,
            burst_pages=256,     # working set >> cache: bursts miss hard
            seed=4,
        ),
        store=StoreConfig(n_lines=64, policy="lru"),
        n_shards=2,
        mapping="block_cyclic",
        lam=60.0,
        rates=RateSpec(source="paper"),
        window_dt=2.0,           # wall-clock bins; window count derived
    )

    fluid = simulate(spec, device=dev)
    piecewise = simulate(spec.replace(transient_mode="piecewise"),
                         device=dev)

    lam_w = np.asarray(fluid.windows.lam).sum(axis=0) / spec.n_shards
    resp_fl = np.asarray(fluid.transient.response) * 1e3
    resp_pw = np.asarray(piecewise.transient.response) * 1e3
    q2 = np.asarray(fluid.transient.q2)

    print(f"=== MMPP checkpoint bursts, {fluid.n_windows} windows of "
          f"{fluid.window_duration_s:.1f}s ===")
    print(f"  {'win':>4} {'lam_meas':>9} {'p12':>6} {'q2':>7} "
          f"{'fluid_ms':>9} {'piecewise_ms':>13}")
    for w in range(fluid.n_windows):
        pw_ms = f"{resp_pw[w]:13.3f}" if np.isfinite(resp_pw[w]) else (
            " " * 9 + "inf ")
        print(f"  {w:>4} {lam_w[w]:>9.1f} {fluid.transient.p12[w]:>6.3f} "
              f"{q2[w]:>7.2f} {resp_fl[w]:>9.3f} {pw_ms}")

    # Burst windows: measured rate well above background.
    background = np.median(lam_w)
    burst_wins = np.flatnonzero(lam_w > 1.5 * background)
    peak = int(np.argmax(resp_fl))
    pw_peak = ("inf" if not np.isfinite(resp_pw[peak])
               else f"{resp_pw[peak]:.2f} ms")
    print(f"\n  background rate ~{background:.0f} req/s; burst windows "
          f"{burst_wins.tolist()} (measured from timestamps, not assumed)")
    print(f"  peak latency: fluid {resp_fl[peak]:.2f} ms at window {peak} "
          f"(piecewise: {pw_peak})")

    # Time-to-drain: windows after the first burst until the fluid
    # response is back within 25% of the calm baseline. The piecewise model
    # by construction drains in 0 windows — queue state does not carry
    # over.
    calm = np.median(resp_fl[np.isfinite(resp_pw)])
    first_burst = int(burst_wins.min()) if burst_wins.size else 0
    drain = 0
    for w in range(first_burst + 1, fluid.n_windows):
        if resp_fl[w] <= 1.25 * calm:
            break
        drain += 1
    print(f"  time-to-drain after the first burst: fluid {drain} windows "
          f"({drain * fluid.window_duration_s:.0f}s of elevated latency, "
          f"backlog draining at tier-2 capacity); piecewise 0 windows "
          f"(snaps back by construction)")
    print(f"  saturation onset (offered rate >= capacity): "
          f"window {fluid.saturation_onset}")
    print("burst_response OK")


if __name__ == "__main__":
    main()
