"""End-to-end tiered-storage simulator (paper §V composed end to end).

``simulate(SimSpec)`` runs workload -> distributed tier-1 cache -> queuing
network -> report, with the tier-1 request loop on the card.
``sweep(base, axes)`` evaluates a grid of scenarios: signatures that share
a structural store config run as the rows of one cache-scan launch, and
cache-size axes of LRU grids take the miss-rate-curve route
(``mrc_tier1_counters`` / ``mrc_curve``: one reuse-distance pass on the
card for every size at once); the reports of a sweep are solved in one
batched float64 torch call. ``simulate_stream`` / ``stream_tier1_counters``
replay a workload in bounded-memory chunks, resumable from a
``StreamCheckpoint``; ``tenant_mix`` workloads go through it and gain
per-tenant ``TenantReport`` attribution.
"""
from repro_torch.sim.engine import (  # noqa: F401
    ShardReport,
    SimReport,
    TenantCounters,
    TenantReport,
    Tier1Counters,
    WindowSeries,
    batched_reports,
    report_from_counters,
    simulate,
    tier1_counters,
)
from repro_torch.sim.mrc import (  # noqa: F401
    mrc_curve,
    mrc_tier1_counters,
    mrc_unsupported_reason,
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
from repro_torch.sim.stream import (  # noqa: F401
    StreamCheckpoint,
    simulate_stream,
    stream_tier1_counters,
)
from repro_torch.sim.sweep import (  # noqa: F401
    SweepResult,
    engine_compile_count,
    expand_grid,
    fluid_compile_count,
    reset_engine_compile_count,
    reset_fluid_compile_count,
    sweep,
)

__all__ = [
    "SimSpec", "RateSpec", "ResolvedRates", "PAPER_MU1", "PAPER_MU2",
    "FaultSpec", "FaultEvent", "RetryPolicy",
    "shard_down", "device_degrade", "tier2_outage",
    "SimReport", "ShardReport", "Tier1Counters", "WindowSeries",
    "TenantCounters", "TenantReport",
    "simulate", "tier1_counters", "report_from_counters", "batched_reports",
    "sweep", "expand_grid", "SweepResult",
    "engine_compile_count", "reset_engine_compile_count",
    "fluid_compile_count", "reset_fluid_compile_count",
    "mrc_curve", "mrc_tier1_counters", "mrc_unsupported_reason",
    "simulate_stream", "stream_tier1_counters", "StreamCheckpoint",
]
