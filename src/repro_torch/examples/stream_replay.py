"""Chunked streaming replay: multi-tenant workload, bounded device memory,
checkpoint/resume.

  PYTHONPATH=src python -m repro_torch.examples.stream_replay

Two tenants (an OLTP service and an analytics scanner) share one tiered
store. The trace is never materialized on the device: ``simulate_stream``
generates it chunk by chunk on the host, feeds each chunk through the
resumable chunk engine (the cache-scan kernel's masked mode on the card,
updating the carry in place), and carries the cache state, windowed
counters and fluid queue backlog across chunk boundaries. The report is
bit-identical to a one-shot replay of the same merged stream — plus
per-tenant attribution.

The second half pauses the replay mid-stream (``max_requests``), inspects
the partial report, and resumes from the checkpoint with a *different*
chunk size; the final report is identical to the uninterrupted run.

``--requests`` and ``--chunk`` shrink the replay (the pause stays at
25/60 of the stream and the resumed chunk at half the first): the CPU's
plain per-step scan takes minutes at the default 60,000 requests.
"""
from __future__ import annotations

import argparse

from repro_torch.core.traffic import TenantSpec, tenant_mix
from repro_torch.sim import SimSpec, simulate_stream
from repro_torch.storage.tiered_store import StoreConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=60_000)
    ap.add_argument("--chunk", type=int, default=8192)
    args = ap.parse_args(argv)
    dev, n, chunk = args.device, args.requests, args.chunk

    mix = tenant_mix(
        TenantSpec(name="oltp", rate=600.0, n_pages=1024, zipf_s=1.3,
                   write_fraction=0.4),
        TenantSpec(name="analytics", rate=200.0, n_pages=4096, zipf_s=0.9,
                   seed=1),
        n_requests=n, seed=7,
    )
    spec = SimSpec(
        traffic=mix,
        store=StoreConfig(n_lines=256, policy="ws"),
        n_shards=4,
        window_dt=2.0,
    )

    rep = simulate_stream(spec, chunk=chunk, device=dev)
    print(f"streamed {rep.requests} requests in chunks of {chunk} "
          f"({rep.n_windows} wall-clock windows)")
    print(f"pooled miss rate {rep.miss_rate:.3f}, "
          f"expected response {rep.response_s * 1e3:.2f} ms")
    for t in rep.tenants:
        print(f"  tenant {t.name:>9}: {t.requests:6d} req, "
              f"miss rate {t.miss_rate:.3f}, "
              f"mean response {t.mean_response_s * 1e3:.2f} ms")

    # -- pause mid-stream, then resume with a different chunk size --------
    partial, ck = simulate_stream(spec, chunk=chunk,
                                  max_requests=n * 25 // 60, device=dev)
    print(f"\npaused at {ck.offset}/{ck.total} requests "
          f"(partial miss rate {partial.miss_rate:.3f}); resuming...")
    resumed = simulate_stream(spec, chunk=chunk // 2, checkpoint=ck,
                              device=dev)
    same = resumed.to_dict() == rep.to_dict()
    print(f"resumed report bit-identical to uninterrupted run: {same}")
    assert same
    print("stream_replay OK")


if __name__ == "__main__":
    main()
