"""Configuration search driven by the performance models (paper §VII).

"For required arrival and service rates, these performance models can be
used to configure cache size (miss rate), number of processes and data sizes
at each tier."

Given a workload (traffic spec + request rate) and device models, the
configurator:

1. measures the miss-rate curve miss_rate(cache_lines) by running the
   tier-1 engine on a sample stream (Fig. 3's capacity-miss curve): one
   :func:`~repro_torch.storage.tiered_store.run_stream` a cache size, each
   one launch of the cache-scan kernel on the card (its plain version on
   the CPU),
2. composes μ1/μ2 from the device behavioral models,
3. sweeps candidate configurations through the queuing network and keeps
   those in equilibrium (all ρ < 1), ranked by predicted response time.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.queuing import TwoTierModel
from repro_torch.core.traffic import TrafficSpec, make_stream
from repro_torch.device import resolve_device
from repro_torch.storage.tier2 import Tier1Sim, Tier2Sim
from repro_torch.storage.tiered_store import StoreConfig, run_stream

__all__ = ["CandidateConfig", "miss_rate_curve", "configure"]


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    n_lines: int
    k_threads: int
    miss_rate: float
    rho1: float
    rho2: float
    equilibrium: bool
    predicted_time_s: float  # eq. 1-4 minimum service time for the workload
    w1: float
    w2: float


def miss_rate_curve(
    spec: TrafficSpec, cache_sizes: Sequence[int], policy: str = "ws", *,
    device=None,
) -> list[tuple[int, float]]:
    """Fig. 3: miss rate vs cache size (capacity misses, 1 process), on
    ``device`` (``None`` = the card). The rate is the f32 quotient of the
    counters, as the reference's ``StreamStats.miss_rate``."""
    device = resolve_device(device)
    pages, writes = make_stream(spec)
    out = []
    for n in cache_sizes:
        stats = run_stream(StoreConfig(n_lines=int(n), policy=policy), pages,
                           writes, device=device)
        rate = torch.true_divide(stats.misses,
                                 torch.clamp(stats.requests, min=1))
        out.append((int(n), float(rate)))
    return out


def configure(
    spec: TrafficSpec,
    *,
    arrival_rate: float,
    cache_sizes: Sequence[int] = (32, 64, 128, 256, 512),
    k_threads: Sequence[int] = (1, 4, 16, 64),
    tier1: Tier1Sim | None = None,
    tier2: Tier2Sim | None = None,
    policy: str = "ws",
    device=None,
) -> list[CandidateConfig]:
    """Sweep (cache size × thread count), return equilibrium-feasible
    candidates sorted by predicted completion time (a stable sort: ties
    keep the sweep's order)."""
    tier1 = tier1 or Tier1Sim()
    tier2 = tier2 or Tier2Sim()
    mu1 = tier1.mu1(read=True)
    mu2 = tier2.mu2(read=True)
    curve = dict(miss_rate_curve(spec, cache_sizes, policy, device=device))
    n = spec.n_requests
    out = []
    for n_lines, p12 in curve.items():
        for k in k_threads:
            model = TwoTierModel(
                lam=arrival_rate, mu1=mu1 * k, mu2=mu2, p12=p12, k=k
            )
            rep = model.analyze()
            # eq. 1–4 minimum completion time (single process, reads only)
            t_hit = n * (1 - p12) / (mu1 * k)
            t_miss = n * p12 / mu2
            out.append(
                CandidateConfig(
                    n_lines=n_lines,
                    k_threads=k,
                    miss_rate=p12,
                    rho1=rep.q1.rho,
                    rho2=rep.q2.rho,
                    equilibrium=rep.equilibrium,
                    predicted_time_s=max(t_hit, t_miss),
                    w1=rep.q1.wq,
                    w2=rep.q2.wq,
                )
            )
    out.sort(key=lambda c: (not c.equilibrium, c.predicted_time_s))
    return out
