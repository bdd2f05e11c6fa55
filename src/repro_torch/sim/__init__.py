"""End-to-end tiered-storage simulator (paper §V composed end to end).

``simulate(SimSpec)`` runs workload -> distributed tier-1 cache -> queuing
network -> report, with the tier-1 request loop on the card. Sweeps,
miss-rate curves and chunked replay are not ported yet.
"""
from repro_torch.sim.engine import (  # noqa: F401
    ShardReport,
    SimReport,
    TenantCounters,
    Tier1Counters,
    WindowSeries,
    batched_reports,
    report_from_counters,
    simulate,
    tier1_counters,
)
from repro_torch.sim.spec import (  # noqa: F401
    PAPER_MU1,
    PAPER_MU2,
    FaultEvent,
    FaultSpec,
    RateSpec,
    ResolvedRates,
    RetryPolicy,
    SimSpec,
    device_degrade,
    shard_down,
    tier2_outage,
)

__all__ = [
    "SimSpec", "RateSpec", "ResolvedRates", "PAPER_MU1", "PAPER_MU2",
    "FaultSpec", "FaultEvent", "RetryPolicy",
    "shard_down", "device_degrade", "tier2_outage",
    "SimReport", "ShardReport", "Tier1Counters", "WindowSeries",
    "TenantCounters",
    "simulate", "tier1_counters", "report_from_counters", "batched_reports",
]
