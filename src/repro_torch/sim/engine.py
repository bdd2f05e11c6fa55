"""End-to-end two-tier simulator: traffic -> tier-1 shards -> queuing.

This is the composition the paper's §V builds by hand for one worked
example, as a subsystem: :func:`simulate` generates (or accepts) a request
stream, pushes it through the distributed tier-1 cache engine
(:func:`repro_torch.storage.tiered_store.run_distributed` — on the card, the
hand-written CUDA cache-scan kernel), converts the resulting counters into
queuing-network inputs (λ, p12, μ1, μ2), and reports per-shard and
aggregate latency / throughput / utilization plus the minimum-time model
(eqs. 1-4).

The counters -> queuing mapping:

=====================  ====================================================
counter                queuing-network input
=====================  ====================================================
``misses/requests``    p12, the tier-2 branch probability (per shard and
                       pooled; ``SimSpec.p12_override`` pins it instead)
``requests - writes``  n_read_i in eq. 1 (hit service at μ1_read)
``writes``             n_write_i in eq. 1 (hit service at μ1_write)
``misses``             n_miss_i in eq. 2 (miss service at μ2)
``tier2_reads/writes`` reported as device traffic (prefetch fetches and
                       dirty write-backs ride the same IO thread)
=====================  ====================================================

Service rates come from :class:`repro_torch.sim.spec.RateSpec` (fitted
device models or the §V paper constants).

**Time-resolved reports.** With ``SimSpec.n_windows > 1`` every counter is
additionally resolved over windows of the request stream
(:class:`WindowSeries`), each window's measured arrival rate and miss
fraction re-solve the network (:func:`repro_torch.core.queuing.
transient_two_tier`), and the report carries the resulting
latency/utilization time series plus the saturation onset. With
``SimSpec.window_dt`` set, windows are wall-clock time bins of the
stream's arrival timestamps.

**Fault injection.** With ``SimSpec.faults`` set (wall-clock path only),
arrivals during a ``shard_down`` interval fail over to surviving shards
(:func:`fault_owner`), the fluid transient runs at per-window degraded
rates μ(t), and on recovery the failed shard re-warms from a cold cache
(:func:`_cold_refill`).

The tier-1 stage runs on the ``device`` the caller names (``None`` = the
card); the report stage is host-side numpy, a copy of the reference's
scalar report path. :func:`batched_reports` solves many points' fluid
transients in one float64 torch call on a device
(:func:`repro_torch.core.queuing.fluid_two_tier_batched`).

**Multi-tenant workloads.** ``tenant_mix`` specs (no trace override) go
through the chunked streaming replay (:func:`repro_torch.sim.stream.
simulate_stream`), whose composite ``window x tenant`` counters give each
tenant its :class:`TenantReport`: its windowed miss mix priced at the
pooled transient solve's residence times.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.mapping import apply_failover, page_to_shard
from repro_torch.core.queuing import (
    FluidReport,
    ServiceTimes,
    TransientReport,
    TwoTierModel,
    expected_response,
    fluid_two_tier_batched,
    residence_times,
    service_time_model,
    transient_two_tier,
)
from repro_torch.core.traffic import make_stream, make_timed_stream
from repro_torch.sim.spec import ResolvedRates, SimSpec
from repro_torch.storage.tiered_store import (
    correct_padded_stats,
    run_distributed,
)

__all__ = ["Tier1Counters", "TenantCounters", "WindowSeries", "ShardReport",
           "TenantReport", "SimReport", "tier1_counters",
           "report_from_counters", "batched_reports", "counters_from_stats",
           "simulate", "fault_owner", "stream_for_spec", "sim_n_pages"]

class Tier1Counters(NamedTuple):
    """Per-shard int64 counter arrays measured by the tier-1 engine.

    ``win_*`` fields resolve the same counters over the time windows of the
    global request stream (shape ``[n_shards, n_windows]``; window sums
    equal the whole-stream counters exactly)."""

    requests: np.ndarray
    reads: np.ndarray
    writes: np.ndarray
    hits: np.ndarray
    misses: np.ndarray
    prefetch_hits: np.ndarray
    tier2_reads: np.ndarray
    tier2_writes: np.ndarray
    evictions: np.ndarray
    win_requests: np.ndarray
    win_hits: np.ndarray
    win_misses: np.ndarray
    win_prefetch_hits: np.ndarray
    win_tier2_reads: np.ndarray
    win_tier2_writes: np.ndarray
    win_evictions: np.ndarray
    win_expert_use: np.ndarray   # int64[n_shards, n_windows, E]
    win_weights: np.ndarray      # float[n_shards, n_windows, E]

    @property
    def n_windows(self) -> int:
        return self.win_requests.shape[-1]


class TenantCounters(NamedTuple):
    """Per-tenant windowed engine counters of a ``tenant_mix`` workload,
    pooled across shards (shapes ``[n_tenants, n_windows]``; sums over the
    tenant axis equal the pooled :class:`Tier1Counters` window series
    exactly). Produced by the streaming replay
    (:func:`repro_torch.sim.stream.stream_tier1_counters`), which resolves
    the engine's windowed counters over composite ``window x tenant`` ids —
    attribution costs no extra launch."""

    names: tuple            # tenant names, declaration order
    win_requests: np.ndarray
    win_hits: np.ndarray
    win_misses: np.ndarray

    @property
    def n_tenants(self) -> int:
        return self.win_requests.shape[0]

    @property
    def n_windows(self) -> int:
        return self.win_requests.shape[-1]


class WindowSeries(NamedTuple):
    """Per-shard, per-window telemetry (shapes ``[n_shards, n_windows]``):
    the windowed engine counters plus the measured queuing-network inputs
    (arrival rate and miss fraction) each window feeds into the transient
    solve.

    ``lam`` is each *shard's* share of the offered load in that window. On
    the wall-clock path (``SimSpec.window_dt``) it is genuinely measured —
    bursty arrival processes show up as per-window rate swings, pooled and
    per shard. On the request-index path windows are equal slices of a
    constant-rate stream, so per-shard rates resolve mapping skew and
    phased footprint shifts while the across-shard pooled rate stays ~λ by
    construction.

    ``expert_use`` / ``weights`` resolve the online learner over the same
    windows (``[n_shards, n_windows, E]``): evictions issued per expert,
    and the expert weight vector at each window's last request (empty
    windows carry the previous window's weights forward — the learner did
    not move), so adaptation at phase boundaries is observable."""

    requests: np.ndarray
    hits: np.ndarray
    misses: np.ndarray
    prefetch_hits: np.ndarray
    tier2_reads: np.ndarray
    tier2_writes: np.ndarray
    evictions: np.ndarray
    expert_use: np.ndarray  # [n_shards, n_windows, E] evictions per expert
    weights: np.ndarray     # [n_shards, n_windows, E] learner weights
    lam: np.ndarray   # measured per-shard arrival rate (req/s)
    p12: np.ndarray   # measured per-shard miss fraction

    def to_dict(self) -> dict:
        return {name: _plain(getattr(self, name)) for name in self._fields}


@dataclasses.dataclass(frozen=True)
class ShardReport:
    """One tier-1 shard: measured counters + its queuing-network solution."""

    shard: int
    requests: int
    reads: int
    writes: int
    hits: int
    misses: int
    prefetch_hits: int
    tier2_reads: int
    tier2_writes: int
    evictions: int
    p12: float           # miss fraction used by the queue model
    lam_eff: float       # effective arrival rate at the k-server queue
    rho1: float          # tier-1 offered load (a = lam_eff/mu1)
    rho2: float          # tier-2 utilization
    w1: float            # tier-1 residence time (s)
    w2: float            # tier-2 residence time (s)
    response_s: float    # expected response: w1 + p12 * w2
    equilibrium: bool
    # First window in which this shard's transient solve saturates (ρ ≥ 1);
    # None when every window is stable (or n_windows == 1 and stable).
    saturation_onset: Optional[int] = None
    # First window of the *trailing* metastable run — external load back
    # under capacity, but retry feedback keeping total offered load above
    # it. None when the shard ends healthy or no retry policy is active.
    metastable_onset: Optional[int] = None

    def to_dict(self) -> dict:
        return _plain(dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class TenantReport:
    """One tenant of a ``tenant_mix`` workload: measured windowed counters
    plus the latency the tenant observes riding the *pooled* queues.

    Tenants share the tier-1/tier-2 service processes, so each window's
    residence times come from the pooled transient solve; what is per
    tenant is the miss mix — ``response_s[w] = w1[w] + p12[w] * w2[w]``
    with the *tenant's* measured per-window miss fraction."""

    tenant: int              # index in the spec's declaration order
    name: str
    requests: int
    hits: int
    misses: int
    miss_rate: float         # whole-stream: misses / requests
    win_requests: np.ndarray  # [n_windows] pooled across shards
    win_misses: np.ndarray    # [n_windows]
    lam: np.ndarray           # [n_windows] measured tenant arrival rate
    p12: np.ndarray           # [n_windows] tenant miss fraction
    response_s: np.ndarray    # [n_windows] expected response this tenant sees
    mean_response_s: float    # request-weighted mean of response_s

    def to_dict(self) -> dict:
        return _plain(dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Aggregate + per-shard results for one :class:`SimSpec` scenario."""

    spec: SimSpec
    rates: ResolvedRates
    shards: tuple
    # aggregate counters
    requests: int
    hits: int
    misses: int
    prefetch_hits: int
    tier2_reads: int
    tier2_writes: int
    evictions: int
    miss_rate: float        # measured: misses / requests
    p12: float              # miss fraction used by the queue model
    # aggregate queuing network (pooled p12, per-process λ)
    lam_eff: float
    rho1: float
    rho2: float
    w1: float
    w2: float
    response_s: float       # expected response time: w1 + p12 * w2
    mu_system: float        # eq. 5 composed service rate
    rho_system: float
    equilibrium: bool
    throughput_rps: float   # equilibrium throughput across all shards
    # minimum-time model (eqs. 1-4)
    min_time: ServiceTimes
    t_total_s: float        # eq. 4: max over shards
    min_time_throughput_rps: float  # total requests / t_total
    # time-resolved telemetry (window axis = n_windows slices of the stream:
    # wall-clock bins when spec.window_dt is set, request-count otherwise)
    n_windows: int
    window_duration_s: float
    windows: WindowSeries
    # Pooled transient solve: FluidReport (carryover, the default — adds
    # q1/q2 backlog series) or TransientReport (mode="piecewise").
    transient: "TransientReport | FluidReport"
    saturation_onset: Optional[int]  # first pooled window ρ ≥ 1 (None=never)
    # First window of the pooled solve's trailing retry-storm run (see
    # ShardReport.metastable_onset). None = ends healthy / no retry policy.
    metastable_onset: Optional[int] = None
    # Per-tenant attribution (tenant_mix streaming replays); empty for
    # single-tenant specs.
    tenants: tuple = ()

    def to_dict(self) -> dict:
        d = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("spec", "rates", "shards", "min_time",
                              "windows", "transient", "tenants")
        }
        d["rates"] = dataclasses.asdict(self.rates)
        d["spec"] = {
            "traffic": dataclasses.asdict(self.spec.traffic),
            "store": dataclasses.asdict(self.spec.store),
            "n_shards": self.spec.n_shards,
            "mapping": self.spec.mapping,
            "lam": self.spec.lam,
            "k_servers": self.spec.k_servers,
            "flow": self.spec.flow,
            "p12_override": self.spec.p12_override,
            "n_windows": self.spec.n_windows,
            "window_dt": self.spec.window_dt,
            "transient_mode": self.spec.transient_mode,
            "faults": (dataclasses.asdict(self.spec.faults)
                       if self.spec.faults is not None else None),
        }
        d["min_time"] = {
            "t_hit": [float(v) for v in np.atleast_1d(self.min_time.t_hit)],
            "t_miss": [float(v) for v in np.atleast_1d(self.min_time.t_miss)],
            "t_proc": [float(v) for v in np.atleast_1d(self.min_time.t_proc)],
            "t_total": float(self.min_time.t_total),
        }
        d = _plain(d)  # scalar fields, rates (tuples!), spec, min_time
        # These sub-reports sanitize themselves — attach after the walk so
        # nothing is converted twice.
        d["windows"] = self.windows.to_dict()
        d["transient"] = {
            name: _plain(getattr(self.transient, name))
            for name in self.transient._fields
        }
        d["shards"] = [s.to_dict() for s in self.shards]
        d["tenants"] = [t.to_dict() for t in self.tenants]
        return d


def _plain(obj):
    """Recursively convert numpy scalars/arrays (and tuples) into plain
    JSON-serializable Python values."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _plain(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def sim_n_pages(spec: SimSpec, pages: np.ndarray) -> int:
    """Page-space size for the §III mapping: the declared traffic page
    space, widened if the stream outgrew it (IRM page ids are unbounded —
    expired pages are replaced by fresh ids)."""
    return max(spec.traffic.n_pages, int(pages.max()) + 1)



def fault_owner(spec: SimSpec, pages: np.ndarray,
                times: Optional[np.ndarray], n_pages: int) -> np.ndarray:
    """Per-request owner shard under the spec's fault schedule: the §III
    mapping, with requests arriving during a shard_down interval rerouted
    to survivors (:func:`repro_torch.core.mapping.apply_failover`). Pure
    host-side data."""
    owner = page_to_shard(pages, spec.n_shards, n_pages, spec.mapping)
    if spec.faults is None or times is None:
        return owner
    down = spec.faults.down_intervals()
    if not down:
        return owner
    owner, _ = apply_failover(owner, times, down, spec.n_shards)
    return owner


def stream_for_spec(spec: SimSpec, trace=None):
    """Resolve the concrete request stream a spec (plus optional trace
    override) describes: ``(pages, is_write, times, n_pages, n_windows,
    window_dt)``. ``times`` is None on the request-index path. The
    reference's stream for the same spec, byte for byte. ``trace`` overrides the
    generated stream with a user-provided ``(pages, is_write)`` pair — or
    ``(pages, is_write, times)`` triple on the wall-clock path
    (``spec.window_dt`` set; a 2-tuple trace then gets deterministic
    arrivals at the aggregate offered rate) — mapped over its own observed
    page space."""
    n_windows, window_dt = spec.window_grid()
    times = None
    if trace is not None:
        pages, is_write = np.asarray(trace[0]), np.asarray(trace[1], bool)
        n_pages = int(pages.max()) + 1
        if window_dt is not None:
            if len(trace) > 2:
                times = np.asarray(trace[2], float)
                # Normalize to t0 = 0: real traces carry absolute (epoch)
                # timestamps, and the window origin is the trace start —
                # otherwise a derived grid sizes itself to the epoch.
                if times.size:
                    times = times - times.min()
            else:
                times = (1.0 + np.arange(pages.shape[0])) / spec.agg_rate()
            if spec.n_windows == 1:
                # Derived grids must cover the *trace's* horizon — the
                # spec's nominal traffic no longer describes the stream.
                n_windows = max(1, int(np.ceil(
                    float(times.max()) / window_dt)))
    elif window_dt is not None:
        pages, is_write, times = make_timed_stream(
            spec.traffic, default_rate=spec.agg_rate())
        n_pages = sim_n_pages(spec, pages)
    else:
        pages, is_write = make_stream(spec.traffic)
        n_pages = sim_n_pages(spec, pages)
    return pages, is_write, times, n_pages, n_windows, window_dt


def tier1_counters(spec: SimSpec, trace=None, *, engine: str = "fused",
                   device=None) -> Tier1Counters:
    """Run the workload through the distributed tier-1 cache
    (:func:`repro_torch.storage.tiered_store.run_distributed`) on ``device``
    (``None`` = the card) and return exact per-shard counters
    (whole-stream and per-window). ``trace`` overrides the generated
    stream (see :func:`stream_for_spec`; a ``tenant_mix`` spec is drained
    in one shot). ``engine`` selects the fused cache-scan engine (default)
    or the per-step ``"scan"`` engine it is bit-exact against."""
    pages, is_write, times, n_pages, n_windows, window_dt = stream_for_spec(
        spec, trace)
    owner = fault_owner(spec, pages, times, n_pages)
    stats, counts = run_distributed(
        spec.store, pages, is_write,
        n_shards=spec.n_shards, mapping=spec.mapping, n_pages=n_pages,
        n_windows=n_windows, timestamps=times, window_dt=window_dt,
        owner=owner, engine=engine, device=device,
    )
    writes = np.bincount(owner[is_write], minlength=spec.n_shards)
    return _assemble_counters(stats, counts, writes)


def _assemble_counters(corrected_stats, counts, writes) -> Tier1Counters:
    """Build :class:`Tier1Counters` from padding-corrected StreamStats
    (tensors on any device, or numpy arrays)."""
    counts = np.asarray(counts, np.int64)
    s = type(corrected_stats)(*(
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in corrected_stats))
    return Tier1Counters(
        requests=counts,
        reads=counts - np.asarray(writes, np.int64),
        writes=np.asarray(writes, np.int64),
        hits=np.asarray(s.hits, np.int64),
        misses=np.asarray(s.misses, np.int64),
        prefetch_hits=np.asarray(s.prefetch_hits, np.int64),
        tier2_reads=np.asarray(s.tier2_reads, np.int64),
        tier2_writes=np.asarray(s.tier2_writes, np.int64),
        evictions=np.asarray(s.evictions, np.int64),
        win_requests=np.asarray(s.win_requests, np.int64),
        win_hits=np.asarray(s.win_hits, np.int64),
        win_misses=np.asarray(s.win_misses, np.int64),
        win_prefetch_hits=np.asarray(s.win_prefetch_hits, np.int64),
        win_tier2_reads=np.asarray(s.win_tier2_reads, np.int64),
        win_tier2_writes=np.asarray(s.win_tier2_writes, np.int64),
        win_evictions=np.asarray(s.win_evictions, np.int64),
        win_expert_use=np.asarray(s.win_expert_use, np.int64),
        win_weights=np.asarray(s.win_weights, float),
    )


def counters_from_stats(stats, counts, writes, *, cap: int) -> Tier1Counters:
    """Assemble :class:`Tier1Counters` from *padded* per-shard StreamStats
    (the sweep engine's batched path), delegating the padding/phantom-miss
    correction to :func:`repro_torch.storage.tiered_store.
    correct_padded_stats`."""
    return _assemble_counters(
        correct_padded_stats(stats, counts, cap), counts, writes
    )


def _shard_rate_vectors(spec: SimSpec, rates: ResolvedRates):
    """Per-shard queue-model (μ1, μ2) arrays (scalars broadcast)."""
    per = [rates.for_shard(i) for i in range(spec.n_shards)]
    return (np.asarray([r.mu1 for r in per], float),
            np.asarray([r.mu2 for r in per], float))


def _ffill_weights(win_weights, win_requests) -> np.ndarray:
    """Carry expert weights forward over empty windows: a window with no
    real requests left a zero row in the engine's snapshot accumulator —
    the learner did not move, so it inherits the previous window's weights
    (leading empties get the uniform initial weights)."""
    w = np.array(win_weights, float, copy=True)      # [..., W, E]
    req = np.asarray(win_requests)
    n_experts = w.shape[-1]
    prev = np.full(w.shape[:-2] + (n_experts,), 1.0 / n_experts)
    for t in range(w.shape[-2]):
        empty = (req[..., t] == 0)[..., None]
        w[..., t, :] = np.where(empty, prev, w[..., t, :])
        prev = w[..., t, :]
    return w


def _cold_refill(spec: SimSpec, ctr: Tier1Counters,
                 window_dt: float) -> Tier1Counters:
    """Model the cold-cache refill after each shard_down recovery.

    The jitted cache engine keeps its state through an outage (the remap is
    an input-side reroute), but a real recovering shard comes back *cold*:
    its first post-recovery requests re-miss up to one cache's worth of
    lines while survivors evicted its working set. Approximate that by
    reclassifying post-recovery windowed hits into misses (+ tier-2 reads)
    on the recovered shard, with a budget of ``store.n_lines`` touched
    lines; the whole-stream totals get the same correction, so windowed
    counters still reconcile bit-exactly with totals."""
    hits = np.array(ctr.win_hits, np.int64, copy=True)
    misses = np.array(ctr.win_misses, np.int64, copy=True)
    t2r = np.array(ctr.win_tier2_reads, np.int64, copy=True)
    reqs = np.asarray(ctr.win_requests, np.int64)
    n_windows = ctr.n_windows
    for shard, _, t1 in spec.faults.down_intervals():
        w_rec = int(np.floor(t1 / window_dt))
        budget = int(spec.store.n_lines)
        for w in range(max(w_rec, 0), n_windows):
            if budget <= 0:
                break
            cold = min(budget, int(reqs[shard, w]))
            extra = min(int(hits[shard, w]), cold)
            hits[shard, w] -= extra
            misses[shard, w] += extra
            t2r[shard, w] += extra
            budget -= cold
    d_hits = hits.sum(axis=1) - np.asarray(ctr.win_hits).sum(axis=1)
    return ctr._replace(
        win_hits=hits, win_misses=misses, win_tier2_reads=t2r,
        hits=np.asarray(ctr.hits, np.int64) + d_hits,
        misses=np.asarray(ctr.misses, np.int64) - d_hits,
        tier2_reads=np.asarray(ctr.tier2_reads, np.int64) - d_hits,
    )



class _PreparedReport(NamedTuple):
    """Everything :func:`report_from_counters` derives *before* the
    transient solves: resolved rates, windowed telemetry, and the fluid
    solver inputs."""

    spec: SimSpec
    ctr: Tier1Counters            # cold-refill-corrected counters
    tenants: Optional[TenantCounters]
    rates: ResolvedRates
    mu1_v: np.ndarray             # [S] equilibrium per-shard rates
    mu2_v: np.ndarray
    p12_sh: np.ndarray            # [S] whole-stream per-shard miss fraction
    req: np.ndarray               # [S] per-shard request totals
    total_req: int
    total_miss: int
    miss_rate: float
    p12: float                    # aggregate miss fraction for the solves
    duration: float
    n_windows: int
    windows: WindowSeries
    lam_sw: np.ndarray            # [S, W] measured per-shard rates
    p12_sw: np.ndarray
    mode: str                     # fluid | piecewise (after idle fallback)
    tr_kw: dict                   # transient kwargs (dt/retry/spill/mu_load)
    sh_mu1: np.ndarray            # [S, 1] or [S, W] degraded μ1(t)
    sh_mu2: np.ndarray
    pool_lam: np.ndarray          # [W] pooled per-process rate
    pool_p12: np.ndarray
    pool_mu1: object              # scalar or [W] degraded pooled μ1(t)
    pool_mu2: object



class _Equilibrium(NamedTuple):
    """Stationary queue solutions feeding the report: per-shard fields
    carry a trailing shard axis, aggregate fields are scalars — both with
    arbitrary leading (point) axes, so one call serves a single report or
    a whole stacked batch."""

    sh_lam_eff: np.ndarray
    sh_rho1: np.ndarray
    sh_rho2: np.ndarray
    sh_w1: np.ndarray
    sh_w2: np.ndarray
    sh_resp: np.ndarray
    sh_eq: np.ndarray
    agg_lam_eff: object
    agg_rho1: object
    agg_rho2: object
    agg_mu_system: object
    agg_rho_system: object
    agg_eq: object
    w1: object
    w2: object



def _prepare_report(
    spec: SimSpec, ctr: Tier1Counters,
    tenants: Optional[TenantCounters] = None,
) -> _PreparedReport:
    """Counters → queuing-network inputs (the pre-solve half of
    :func:`report_from_counters`)."""
    rates = spec.rates.resolve()
    # (mu*_shards length vs n_shards is enforced by SimSpec.__post_init__.)
    mu1_v, mu2_v = _shard_rate_vectors(spec, rates)
    _, window_dt = spec.window_grid()
    if (spec.faults is not None and spec.faults.refill_cold
            and window_dt is not None and spec.faults.down_intervals()):
        ctr = _cold_refill(spec, ctr, window_dt)

    req = np.asarray(ctr.requests, np.int64)
    p12_sh = (
        np.full(spec.n_shards, spec.p12_override, float)
        if spec.p12_override is not None
        else np.asarray(ctr.misses, float) / np.maximum(req, 1)
    )

    n_windows = ctr.n_windows
    total_req = int(req.sum())
    if window_dt is not None:
        # Wall-clock bins: fixed duration, measured per-window rates.
        duration = float(window_dt)
        if not duration > 0:
            # SimSpec validation rejects non-finite/non-positive window_dt;
            # a spec that bypassed it (pickles of older versions, direct
            # object.__setattr__) must fail here, not divide rates by 0.
            raise ValueError(
                f"timed spec has a non-positive window duration "
                f"({duration!r} s from window_dt={spec.window_dt!r}) — the "
                f"wall-clock report path needs a positive finite window_dt")
    else:
        # Request-index windows: the whole stream arrives at aggregate rate
        # λ·S, so each of the n_windows equal request-count slices spans
        # this duration. λ ≤ 0 is the idle regime (no arrivals): windows
        # have no duration and the measured rates below stay 0.
        duration = (
            total_req / (spec.lam * spec.n_shards * n_windows)
            if total_req and spec.lam > 0 else 0.0
        )
    win_req = np.asarray(ctr.win_requests, float)
    lam_sw = win_req / duration if duration > 0 else np.zeros_like(win_req)
    p12_sw = (
        np.full_like(win_req, spec.p12_override)
        if spec.p12_override is not None
        else np.asarray(ctr.win_misses, float) / np.maximum(win_req, 1)
    )
    windows = WindowSeries(
        requests=ctr.win_requests,
        hits=ctr.win_hits,
        misses=ctr.win_misses,
        prefetch_hits=ctr.win_prefetch_hits,
        tier2_reads=ctr.win_tier2_reads,
        tier2_writes=ctr.win_tier2_writes,
        evictions=ctr.win_evictions,
        expert_use=ctr.win_expert_use,
        weights=_ffill_weights(ctr.win_weights, ctr.win_requests),
        lam=lam_sw,
        p12=p12_sw,
    )
    # Fluid carryover needs a positive window duration; an all-idle stream
    # (duration 0) degenerates to per-window stationary (= idle) solves.
    mode = spec.transient_mode if duration > 0 else "piecewise"
    tr_kw = dict(k=spec.k_servers, flow=spec.flow, mode=mode)
    if mode == "fluid":
        tr_kw["dt"] = duration
        if rates.mu_load is not None:
            # Load-dependent μ(Q) rides the fluid solve only (SimSpec
            # validation requires transient_mode='fluid'; an all-idle
            # stream that degenerated to piecewise has no load to bend μ).
            tr_kw["mu_load"] = rates.mu_load
    # Fault schedule → time-varying μ(t) per shard/window plus retry
    # feedback. Only the fluid solver understands these dynamics (SimSpec
    # validation guarantees transient_mode='fluid'; an all-idle stream that
    # degenerated to piecewise above has no arrivals to retry anyway).
    sh_mu1: np.ndarray = mu1_v[:, None]
    sh_mu2: np.ndarray = mu2_v[:, None]
    pool_mu1, pool_mu2 = rates.mu1, rates.mu2
    if spec.faults is not None and mode == "fluid":
        tr_kw["retry"] = spec.faults.retry
        if spec.faults.events and window_dt is not None:
            # Degraded tier-1 can't absorb its offered load: spill the
            # excess to tier-2 so the backup tier serves what tier-1 drops.
            tr_kw["tier1_spill"] = True
            mu1_mult, mu2_mult = spec.faults.mu_multipliers(
                n_windows, window_dt, spec.n_shards)
            sh_mu1 = sh_mu1 * mu1_mult
            sh_mu2 = sh_mu2 * mu2_mult[None, :]
            pool_mu1 = rates.mu1 * mu1_mult.mean(axis=0)
            pool_mu2 = rates.mu2 * mu2_mult
    # Pooled per-process arrival rate and miss fraction per window.
    pool_req = win_req.sum(axis=0)
    pool_lam = (
        pool_req / (duration * spec.n_shards)
        if duration > 0 else np.zeros(n_windows)
    )
    pool_p12 = (
        np.full(n_windows, spec.p12_override, float)
        if spec.p12_override is not None
        else np.asarray(ctr.win_misses, float).sum(axis=0)
        / np.maximum(pool_req, 1)
    )
    total_miss = int(ctr.misses.sum())
    miss_rate = total_miss / total_req if total_req else 0.0
    p12 = spec.p12_override if spec.p12_override is not None else miss_rate
    return _PreparedReport(
        spec=spec, ctr=ctr, tenants=tenants, rates=rates,
        mu1_v=mu1_v, mu2_v=mu2_v, p12_sh=p12_sh, req=req,
        total_req=total_req, total_miss=total_miss, miss_rate=miss_rate,
        p12=p12, duration=duration, n_windows=n_windows, windows=windows,
        lam_sw=lam_sw, p12_sw=p12_sw, mode=mode, tr_kw=tr_kw,
        sh_mu1=sh_mu1, sh_mu2=sh_mu2, pool_lam=pool_lam, pool_p12=pool_p12,
        pool_mu1=pool_mu1, pool_mu2=pool_mu2,
    )


def _solve_equilibrium(
    lam_sh, mu1_sh, mu2_sh, p12_sh, lam_agg, mu1_agg, mu2_agg, p12_agg,
    *, k: int, flow: str,
) -> _Equilibrium:
    """Per-shard + aggregate stationary solves — elementwise over any
    leading axes, so a ``[point, shard]`` stack costs two model calls for
    the whole batch instead of two per point."""
    sh_rep = TwoTierModel(
        lam=lam_sh, mu1=mu1_sh, mu2=mu2_sh, p12=p12_sh, k=k,
        flow=flow,  # type: ignore[arg-type]
    ).analyze()
    sh_sum = sh_rep.summary()
    sh_eq = np.asarray(sh_rep.equilibrium, bool)
    sh_w1, sh_w2 = residence_times(sh_sum["W1"], sh_sum["W2"],
                                   mu1_sh, mu2_sh, sh_eq)
    sh_resp = expected_response(sh_w1, sh_w2, p12_sh)
    agg_rep = TwoTierModel(
        lam=lam_agg, mu1=mu1_agg, mu2=mu2_agg, p12=p12_agg, k=k,
        flow=flow,  # type: ignore[arg-type]
    ).analyze()
    s = agg_rep.summary()
    w1, w2 = residence_times(s["W1"], s["W2"], mu1_agg, mu2_agg,
                             agg_rep.equilibrium)
    return _Equilibrium(
        sh_lam_eff=np.asarray(sh_sum["lam_eff"]),
        sh_rho1=np.asarray(sh_sum["rho1"]),
        sh_rho2=np.asarray(sh_sum["rho2"]),
        sh_w1=np.asarray(sh_w1), sh_w2=np.asarray(sh_w2),
        sh_resp=np.asarray(sh_resp), sh_eq=sh_eq,
        agg_lam_eff=s["lam_eff"], agg_rho1=s["rho1"], agg_rho2=s["rho2"],
        agg_mu_system=s["mu_system"], agg_rho_system=s["rho_system"],
        agg_eq=agg_rep.equilibrium, w1=w1, w2=w2,
    )


def _point_equilibrium(prep: _PreparedReport) -> _Equilibrium:
    return _solve_equilibrium(
        np.full(prep.spec.n_shards, prep.spec.lam, float),
        prep.mu1_v, prep.mu2_v, prep.p12_sh,
        prep.spec.lam, prep.rates.mu1, prep.rates.mu2, prep.p12,
        k=prep.spec.k_servers, flow=prep.spec.flow,
    )


def _onsets(sh_tr, transient) -> tuple:
    """(sh_onsets[S], sh_meta[S]|None, saturation_onset, metastable_onset)
    of one point's transient solves."""
    sh_onsets = np.asarray(sh_tr.onset())
    # Report-level onset = the pooled solve's first saturated window (system
    # drifting into overload). Per-shard onsets — which also capture mapping
    # skew concentrating load on one shard — live on each ShardReport.
    pooled_onset = int(transient.onset())
    saturation_onset = pooled_onset if pooled_onset >= 0 else None
    # Metastable onset (retry feedback keeping total offered load above
    # capacity after external load subsides) — fluid+retry solves only.
    pooled_meta = None
    sh_meta = None
    if isinstance(transient, FluidReport) and transient.metastable is not None:
        mo = int(transient.metastable_onset())
        pooled_meta = mo if mo >= 0 else None
    if isinstance(sh_tr, FluidReport) and sh_tr.metastable is not None:
        sh_meta = np.asarray(sh_tr.metastable_onset())
    return sh_onsets, sh_meta, saturation_onset, pooled_meta



def _finish_report(
    prep: _PreparedReport, eq: _Equilibrium, sh_tr, transient, onsets: tuple,
) -> SimReport:
    """Assemble the :class:`SimReport` from the solved pieces (the
    post-solve half of :func:`report_from_counters`)."""
    spec, ctr, rates = prep.spec, prep.ctr, prep.rates
    duration = prep.duration
    sh_onsets, sh_meta, saturation_onset, pooled_meta = onsets

    shard_reports = []
    for i in range(spec.n_shards):
        onset_i = int(sh_onsets[i])
        shard_reports.append(ShardReport(
            shard=i,
            requests=int(prep.req[i]),
            reads=int(ctr.reads[i]),
            writes=int(ctr.writes[i]),
            hits=int(ctr.hits[i]),
            misses=int(ctr.misses[i]),
            prefetch_hits=int(ctr.prefetch_hits[i]),
            tier2_reads=int(ctr.tier2_reads[i]),
            tier2_writes=int(ctr.tier2_writes[i]),
            evictions=int(ctr.evictions[i]),
            p12=float(prep.p12_sh[i]),
            lam_eff=float(np.asarray(eq.sh_lam_eff).reshape(-1)[i]),
            rho1=float(np.asarray(eq.sh_rho1).reshape(-1)[i]),
            rho2=float(np.asarray(eq.sh_rho2).reshape(-1)[i]),
            w1=float(eq.sh_w1[i]),
            w2=float(eq.sh_w2[i]),
            response_s=float(eq.sh_resp[i]),
            equilibrium=bool(eq.sh_eq[i]),
            saturation_onset=onset_i if onset_i >= 0 else None,
            metastable_onset=(
                int(sh_meta[i])
                if sh_meta is not None and int(sh_meta[i]) >= 0 else None
            ),
        ))

    # Minimum-time model (eqs. 1-4) over the per-shard counters: eq. 1 at
    # the read/write device rates, eq. 2 at the miss rate, eq. 4 = max.
    # Heterogeneous rate specs feed per-shard μ vectors into eqs. 1-2.
    mu1_read_v, mu1_write_v, mu2_mt_v = rates.shard_vectors(spec.n_shards)
    mt = service_time_model(
        ctr.reads, ctr.writes, ctr.misses, mu1_read_v, mu1_write_v, mu2_mt_v,
    )
    t_total = float(mt.t_total)

    # --- per-tenant attribution (tenant_mix streaming replays) ------------
    tenant_reports: tuple = ()
    if prep.tenants is not None:
        tenants = prep.tenants
        t_reports = []
        w1_t = np.asarray(transient.w1, float)
        w2_t = np.asarray(transient.w2, float)
        for k, name in enumerate(tenants.names):
            t_req = np.asarray(tenants.win_requests[k], np.int64)
            t_miss = np.asarray(tenants.win_misses[k], np.int64)
            t_hits = int(np.asarray(tenants.win_hits[k]).sum())
            n_req = int(t_req.sum())
            t_p12 = t_miss / np.maximum(t_req, 1)
            t_lam = (t_req / duration if duration > 0
                     else np.zeros_like(t_req, float))
            t_resp = w1_t + t_p12 * w2_t
            wsum = float(t_req.sum())
            t_reports.append(TenantReport(
                tenant=k,
                name=str(name),
                requests=n_req,
                hits=t_hits,
                misses=int(t_miss.sum()),
                miss_rate=float(t_miss.sum() / max(n_req, 1)),
                win_requests=t_req,
                win_misses=t_miss,
                lam=np.asarray(t_lam, float),
                p12=np.asarray(t_p12, float),
                response_s=np.asarray(t_resp, float),
                mean_response_s=(
                    float((t_resp * t_req).sum() / wsum) if wsum > 0 else 0.0
                ),
            ))
        tenant_reports = tuple(t_reports)

    equilibrium = bool(eq.agg_eq) and bool(eq.sh_eq.all())
    return SimReport(
        spec=spec,
        rates=rates,
        shards=tuple(shard_reports),
        requests=prep.total_req,
        hits=int(ctr.hits.sum()),
        misses=prep.total_miss,
        prefetch_hits=int(ctr.prefetch_hits.sum()),
        tier2_reads=int(ctr.tier2_reads.sum()),
        tier2_writes=int(ctr.tier2_writes.sum()),
        evictions=int(ctr.evictions.sum()),
        miss_rate=float(prep.miss_rate),
        p12=float(prep.p12),
        lam_eff=float(eq.agg_lam_eff),
        rho1=float(eq.agg_rho1),
        rho2=float(eq.agg_rho2),
        w1=float(eq.w1),
        w2=float(eq.w2),
        response_s=float(expected_response(eq.w1, eq.w2, prep.p12)),
        mu_system=float(eq.agg_mu_system),
        rho_system=float(eq.agg_rho_system),
        equilibrium=equilibrium,
        throughput_rps=float(spec.lam * spec.n_shards) if equilibrium
        else float(eq.agg_mu_system) * spec.n_shards,
        min_time=mt,
        t_total_s=t_total,
        min_time_throughput_rps=(
            prep.total_req / t_total if t_total > 0 else 0.0),
        n_windows=prep.n_windows,
        window_duration_s=float(duration),
        windows=prep.windows,
        transient=transient,
        saturation_onset=saturation_onset,
        metastable_onset=pooled_meta,
        tenants=tenant_reports,
    )


def report_from_counters(
    spec: SimSpec, ctr: Tier1Counters,
    tenants: Optional[TenantCounters] = None,
) -> SimReport:
    """Solve the queuing network for measured counters (no traffic rerun).

    Per-shard service-rate heterogeneity (``RateSpec.mu1_shards`` /
    ``mu2_shards``) is honored here: each shard's queue is solved at its
    own μ1/μ2 and the minimum-time model (eqs. 1–4) uses the per-shard rate
    vectors; the aggregate/pooled queue uses the scalar (mean) rates. All
    per-shard and per-window solves are vectorized numpy calls into
    :mod:`repro_torch.core.queuing`.

    ``tenants`` (a :class:`TenantCounters`, produced by the streaming
    replay of a ``tenant_mix`` workload) adds per-tenant
    :class:`TenantReport` attribution: each tenant's windowed miss mix
    priced at the pooled transient solve's per-window residence times."""
    prep = _prepare_report(spec, ctr, tenants)
    # Per-shard transient: measured per-shard rates at per-shard μ.
    sh_tr = transient_two_tier(
        prep.lam_sw, prep.p12_sw, prep.sh_mu1, prep.sh_mu2, **prep.tr_kw,
    )
    # Pooled transient: per-process pooled arrival rate and miss fraction.
    transient = transient_two_tier(
        prep.pool_lam, prep.pool_p12, prep.pool_mu1, prep.pool_mu2,
        **prep.tr_kw,
    )
    eq = _point_equilibrium(prep)
    return _finish_report(prep, eq, sh_tr, transient,
                          _onsets(sh_tr, transient))


def _report_group_key(prep: _PreparedReport) -> Optional[tuple]:
    """Points whose fluid solves can stack into one batched call share a
    key: same window grid / shard count (operand shapes), same window
    duration, and same structural solver config (k, flow convention, retry
    policy, spill, μ(Q) hook). None = solve this point on the scalar path
    (piecewise / idle-degenerate reports)."""
    if prep.mode != "fluid":
        return None
    return (
        np.shape(prep.lam_sw), prep.duration, prep.spec.k_servers,
        prep.spec.flow, prep.tr_kw.get("retry"),
        bool(prep.tr_kw.get("tier1_spill", False)),
        prep.tr_kw.get("mu_load"),
    )


def _take_fluid(rep: FluidReport, i: int) -> FluidReport:
    """Slice point ``i`` out of a batched FluidReport (every array field
    carries the point axis first; None diagnostics stay None)."""
    return FluidReport(*(None if v is None else np.asarray(v)[i]
                         for v in rep))


def batched_reports(
    items: Sequence, *, solver: str = "batched", _prof: Optional[dict] = None,
    device=None,
) -> list[SimReport]:
    """Reports for many ``(spec, counters[, tenant_counters])`` points with
    the fluid
    transient solves *batched*: compatible points' windowed rates stack
    into one ``[point, shard, window]`` tensor solved by one float64 torch
    window loop on ``device`` (``None`` = the card;
    :func:`repro_torch.core.queuing.fluid_two_tier_batched`, one solver
    per structural config, counted by
    :func:`repro_torch.core.queuing.fluid_compile_count`), the stationary
    equilibrium solves run as two ``[point, shard]`` array calls per group,
    and the saturation/metastability onset scans vectorize over the point
    axis. Report assembly happens host-side from the batched outputs.

    ``solver="scalar"`` runs the same prepare/finish pipeline with the
    per-point numpy solver (the reference path; it touches no device).
    Piecewise-mode points (``transient_mode="piecewise"`` or idle streams)
    always take the scalar path. A third item element (per-tenant
    :class:`TenantCounters`, or ``None``) adds tenant attribution.

    Batched and scalar solves agree to ~1e-13 on the analytic ``k = 1``
    path (~1e-9 for the ``k > 1`` bisection).

    ``_prof`` (internal, used by ``sweep(profile=True)``): a dict that
    accumulates ``report_solve`` / ``assembly`` stage seconds.
    """
    if solver not in ("batched", "scalar"):
        raise ValueError(
            f"solver must be 'batched' or 'scalar', got {solver!r}")
    preps = []
    for item in items:
        spec, ctr = item[0], item[1]
        tenants = item[2] if len(item) > 2 else None
        preps.append(_prepare_report(spec, ctr, tenants))

    groups: dict[Optional[tuple], list[int]] = {}
    for i, prep in enumerate(preps):
        key = _report_group_key(prep) if solver == "batched" else None
        groups.setdefault(key, []).append(i)

    solve_s = 0.0
    asm_s = 0.0
    reports: list = [None] * len(preps)
    for key, idxs in groups.items():
        if key is None:
            for i in idxs:
                prep = preps[i]
                t0 = perf_counter()
                sh_tr = transient_two_tier(
                    prep.lam_sw, prep.p12_sw, prep.sh_mu1, prep.sh_mu2,
                    **prep.tr_kw)
                transient = transient_two_tier(
                    prep.pool_lam, prep.pool_p12, prep.pool_mu1,
                    prep.pool_mu2, **prep.tr_kw)
                eq = _point_equilibrium(prep)
                t1 = perf_counter()
                reports[i] = _finish_report(prep, eq, sh_tr, transient,
                                            _onsets(sh_tr, transient))
                t2 = perf_counter()
                solve_s += t1 - t0
                asm_s += t2 - t1
            continue

        group = [preps[i] for i in idxs]
        p0 = group[0]
        full = np.shape(p0.lam_sw)          # [S, W]
        t0 = perf_counter()
        kw = {k: v for k, v in p0.tr_kw.items() if k not in ("mode", "dt")}
        # Stacked per-shard solve: [P, S, W].
        sh_tr_b = fluid_two_tier_batched(
            np.stack([p.lam_sw for p in group]),
            np.stack([p.p12_sw for p in group]),
            np.stack([np.broadcast_to(p.sh_mu1, full) for p in group]),
            np.stack([np.broadcast_to(p.sh_mu2, full) for p in group]),
            dt=p0.duration, device=device, **kw)
        # Stacked pooled solve: [P, W].
        tr_b = fluid_two_tier_batched(
            np.stack([p.pool_lam for p in group]),
            np.stack([p.pool_p12 for p in group]),
            np.stack([np.broadcast_to(np.asarray(p.pool_mu1, float),
                                      full[-1:]) for p in group]),
            np.stack([np.broadcast_to(np.asarray(p.pool_mu2, float),
                                      full[-1:]) for p in group]),
            dt=p0.duration, device=device, **kw)
        # Onset scans once over the whole stack.
        sh_onsets_b = np.asarray(sh_tr_b.onset())            # [P, S]
        pooled_onset_b = np.asarray(tr_b.onset())            # [P]
        sh_meta_b = (np.asarray(sh_tr_b.metastable_onset())
                     if sh_tr_b.metastable is not None else None)
        pooled_meta_b = (np.asarray(tr_b.metastable_onset())
                         if tr_b.metastable is not None else None)
        # Stationary solves for the whole group: [P, S] + [P].
        eq_b = _solve_equilibrium(
            np.stack([np.full(p.spec.n_shards, p.spec.lam, float)
                      for p in group]),
            np.stack([p.mu1_v for p in group]),
            np.stack([p.mu2_v for p in group]),
            np.stack([p.p12_sh for p in group]),
            np.asarray([p.spec.lam for p in group], float),
            np.asarray([p.rates.mu1 for p in group], float),
            np.asarray([p.rates.mu2 for p in group], float),
            np.asarray([p.p12 for p in group], float),
            k=p0.spec.k_servers, flow=p0.spec.flow,
        )
        t1 = perf_counter()
        for j, i in enumerate(idxs):
            onset_j = int(pooled_onset_b[j])
            meta_j = (int(pooled_meta_b[j])
                      if pooled_meta_b is not None else -1)
            reports[i] = _finish_report(
                preps[i], _Equilibrium(*(np.asarray(f)[j] for f in eq_b)),
                _take_fluid(sh_tr_b, j), _take_fluid(tr_b, j),
                (sh_onsets_b[j],
                 sh_meta_b[j] if sh_meta_b is not None else None,
                 onset_j if onset_j >= 0 else None,
                 meta_j if meta_j >= 0 else None),
            )
        t2 = perf_counter()
        solve_s += t1 - t0
        asm_s += t2 - t1
    if _prof is not None:
        _prof["report_solve"] = _prof.get("report_solve", 0.0) + solve_s
        _prof["assembly"] = _prof.get("assembly", 0.0) + asm_s
    return reports


def simulate(spec: SimSpec, trace=None, *, device=None) -> SimReport:
    """The end-to-end model: workload -> distributed tier 1 -> queuing.
    The tier-1 stage runs on ``device`` (``None`` = the card, raising when
    there is none).

    ``tenant_mix`` workloads (no trace override) go through the chunked
    streaming replay (:func:`repro_torch.sim.stream.simulate_stream`):
    counters equal to the one-shot engine's (the tenant merge is chunk
    invariant), and the report gains per-tenant :class:`TenantReport`
    attribution the one-shot path cannot produce."""
    if spec.traffic.kind == "tenant_mix" and trace is None:
        from repro_torch.sim.stream import simulate_stream
        return simulate_stream(spec, device=device)
    return report_from_counters(
        spec, tier1_counters(spec, trace, device=device))
