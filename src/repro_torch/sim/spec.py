"""Declarative specs for the end-to-end two-tier simulator.

A :class:`SimSpec` names everything the paper's end-to-end model needs in
one object: the workload (:class:`repro_torch.core.traffic.TrafficSpec`), the
distributed tier-1 cache (:class:`repro_torch.storage.tiered_store.StoreConfig`
plus shard count / mapping policy), and the queuing-network parameters
(§V, Fig. 5). :class:`RateSpec` decides where the service rates μ1/μ2 come
from:

- ``source="devices"``: fitted behavioral device models (§V-A/B) via
  :class:`repro_torch.storage.tier2.Tier1Sim` / ``Tier2Sim`` — the paper's
  "behavioral models feed the queuing network" composition;
- ``source="paper"``: the §V worked-example constants (μ1=1000, μ2=33);
- explicit ``mu1``/``mu2`` overrides win over either source.

Specs are frozen dataclasses so they hash/compare — the sweep engine uses
equality of sub-specs to dedupe expensive cache simulations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.queuing import RetryPolicy, _norm_mu_load
from repro_torch.core.traffic import (
    TrafficSpec,
    nominal_duration,
    nominal_duration_std,
)
from repro_torch.storage.tier2 import Tier1Sim, Tier2Sim
from repro_torch.storage.tiered_store import StoreConfig

__all__ = [
    "RateSpec", "ResolvedRates", "SimSpec", "PAPER_MU1", "PAPER_MU2",
    "FaultEvent", "FaultSpec", "RetryPolicy",
    "shard_down", "device_degrade", "tier2_outage",
]

# §V worked example constants: "μ1 = 1000 requests/sec, μ2 = 33 stripes/sec".
PAPER_MU1 = 1000.0
PAPER_MU2 = 33.0


@dataclasses.dataclass(frozen=True)
class ResolvedRates:
    """Concrete service rates handed to the queuing network (req/s).

    ``mu1_shards``/``mu2_shards`` carry optional per-shard rate vectors (the
    paper's Tables VII–IX strong-scaling runs, where the tier-1 device count
    X1 — and hence each process's service rate — varies). When set, the
    scalar fields hold the across-shard means used by the pooled/aggregate
    queue solve; :meth:`for_shard` yields each shard's own rates.
    """

    mu1: float        # tier-1 service rate used by the queue model
    mu2: float        # tier-2 (miss) service rate
    mu1_read: float   # read/write split for the minimum-time model (eqs 1-4)
    mu1_write: float
    mu1_shards: Optional[tuple] = None  # per-shard μ1 overrides
    mu2_shards: Optional[tuple] = None  # per-shard μ2 overrides
    # Load-dependent service hook ((a1, b1), (a2, b2)) — see RateSpec.mu_load.
    mu_load: Optional[tuple] = None

    def for_shard(self, i: int) -> "ResolvedRates":
        """Shard ``i``'s rates. Per-shard μ1 scales the read/write split
        proportionally, preserving the base source's read:write ratio."""
        if self.mu1_shards is None and self.mu2_shards is None:
            return self
        mu1 = float(self.mu1_shards[i]) if self.mu1_shards else self.mu1
        mu2 = float(self.mu2_shards[i]) if self.mu2_shards else self.mu2
        scale = mu1 / self.mu1
        return ResolvedRates(
            mu1=mu1,
            mu2=mu2,
            mu1_read=self.mu1_read * scale,
            mu1_write=self.mu1_write * scale,
            mu_load=self.mu_load,
        )

    def shard_vectors(self, n_shards: int):
        """(mu1_read[n], mu1_write[n], mu2[n]) arrays for eqs. 1–4."""
        per = [self.for_shard(i) for i in range(n_shards)]
        return (
            np.asarray([r.mu1_read for r in per]),
            np.asarray([r.mu1_write for r in per]),
            np.asarray([r.mu2 for r in per]),
        )


@dataclasses.dataclass(frozen=True)
class RateSpec:
    """Where μ1/μ2 come from. Explicit values override the chosen source."""

    source: str = "devices"  # devices | paper
    mu1: Optional[float] = None
    mu2: Optional[float] = None
    mu1_read: Optional[float] = None
    mu1_write: Optional[float] = None
    # Per-shard heterogeneous rates (paper Tables VII–IX: X1 varies per
    # process). Tuples so the spec stays hashable; length must equal the
    # SimSpec's n_shards. When set, the scalar mu1/mu2 (explicit or the
    # across-shard mean) feed the pooled queue solve.
    mu1_shards: Optional[tuple] = None
    mu2_shards: Optional[tuple] = None
    # Device-model operating points (used when source="devices").
    tier1: Tier1Sim = Tier1Sim()
    tier2: Tier2Sim = Tier2Sim()
    n_requests_op: float = 1e5   # NVMe operating point (x4) for μ1
    n_stripes_op: float = 1024.0  # HDD operating point for μ2
    # Load-dependent service: per-tier rational factors ((a1, b1), (a2, b2))
    # scaling μ_i by (1 + a·Q)/(1 + b·Q) at the instantaneous fluid backlog
    # Q — the queue-depth dependence NVMe/HDD devices actually show
    # (deeper queues batch better until they saturate). Fit from device
    # curves with repro_torch.core.device_models.fit_mu_load. None (default)
    # keeps service rates load-independent — the solver paths are then
    # bit-identical to pre-hook behavior. Fluid-only dynamics.
    mu_load: Optional[tuple] = None

    def __post_init__(self):
        # Normalize to nested float tuples so the spec stays hashable and
        # malformed coefficient pairs fail at construction time.
        object.__setattr__(self, "mu_load", _norm_mu_load(self.mu_load))
        for name in ("mu1", "mu2", "mu1_read", "mu1_write"):
            val = getattr(self, name)
            if val is not None and val <= 0:
                raise ValueError(
                    f"RateSpec.{name} must be a positive rate (req/s), got "
                    f"{val} — model a failed device with SimSpec.faults, "
                    f"not a zero service rate")
        for name in ("mu1_shards", "mu2_shards"):
            vec = getattr(self, name)
            if vec is not None and (len(vec) == 0 or min(vec) <= 0):
                raise ValueError(f"RateSpec.{name} must be a non-empty "
                                 "tuple of positive rates")
        if self.n_requests_op <= 0:
            raise ValueError(
                f"RateSpec.n_requests_op must be positive, got "
                f"{self.n_requests_op}")
        if self.n_stripes_op <= 0:
            raise ValueError(
                f"RateSpec.n_stripes_op must be positive, got "
                f"{self.n_stripes_op}")

    def resolve(self) -> ResolvedRates:
        if self.source == "paper":
            mu1_r = mu1_w = PAPER_MU1
            mu2 = PAPER_MU2
        elif self.source == "devices":
            mu1_r = self.tier1.mu1(read=True, n_requests=self.n_requests_op)
            mu1_w = self.tier1.mu1(read=False, n_requests=self.n_requests_op)
            mu2 = self.tier2.mu2(read=True, n_stripes=self.n_stripes_op)
        else:
            raise ValueError(f"unknown rate source: {self.source!r}")
        for name, vec in (("mu1_shards", self.mu1_shards),
                          ("mu2_shards", self.mu2_shards)):
            if vec is not None and (len(vec) == 0 or min(vec) <= 0):
                raise ValueError(f"{name} must be a non-empty tuple of "
                                 "positive rates")
        mu1_r = self.mu1_read if self.mu1_read is not None else mu1_r
        mu1_w = self.mu1_write if self.mu1_write is not None else mu1_w
        mu1 = self.mu1 if self.mu1 is not None else mu1_r
        mu2 = self.mu2 if self.mu2 is not None else mu2
        if self.mu1_shards is not None and self.mu1 is None:
            # Scalar μ1 becomes the across-shard mean; the read/write split
            # rescales with it so for_shard(i) lands exactly on mu1_shards[i]
            # while preserving the source's read:write ratio.
            new_mu1 = sum(self.mu1_shards) / len(self.mu1_shards)
            mu1_r *= new_mu1 / mu1
            mu1_w *= new_mu1 / mu1
            mu1 = new_mu1
        if self.mu2_shards is not None and self.mu2 is None:
            mu2 = sum(self.mu2_shards) / len(self.mu2_shards)
        if min(mu1, mu2, mu1_r, mu1_w) <= 0:
            raise ValueError("service rates must be positive")
        return ResolvedRates(
            mu1=mu1, mu2=mu2, mu1_read=mu1_r, mu1_write=mu1_w,
            mu1_shards=(tuple(float(v) for v in self.mu1_shards)
                        if self.mu1_shards is not None else None),
            mu2_shards=(tuple(float(v) for v in self.mu2_shards)
                        if self.mu2_shards is not None else None),
            mu_load=self.mu_load,
        )


# ---------------------------------------------------------------------------
# Fault injection: wall-clock schedules of device failures and degradation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault on the wall-clock timeline, active over ``[t0, t1)``.

    Built via the :func:`shard_down` / :func:`device_degrade` /
    :func:`tier2_outage` constructors rather than directly.

    kind:    "shard_down" | "degrade" | "tier2_outage"
    t0, t1:  activation interval in seconds (0 <= t0 < t1)
    shard:   affected shard index; -1 = every shard (degrade only —
             shard_down names one shard)
    tier:    affected tier for "degrade" (1 or 2)
    factor:  remaining-capacity fraction in [0, 1] for "degrade"
             (0 = dead, 1 = no-op); unused by the other kinds
    """

    kind: str
    t0: float
    t1: float
    shard: int = -1
    tier: int = 1
    factor: float = 0.0

    def __post_init__(self):
        if self.kind not in ("shard_down", "degrade", "tier2_outage"):
            raise ValueError(f"unknown fault kind: {self.kind!r}")
        if not (0.0 <= self.t0 < self.t1):
            raise ValueError(
                f"fault interval must satisfy 0 <= t0 < t1, got "
                f"[{self.t0}, {self.t1})")
        if self.kind == "degrade":
            if self.tier not in (1, 2):
                raise ValueError(f"degrade tier must be 1 or 2, got "
                                 f"{self.tier}")
            if not 0.0 <= self.factor <= 1.0:
                raise ValueError(
                    f"degrade factor (remaining-capacity fraction) must be "
                    f"in [0, 1], got {self.factor}")
        if self.kind == "shard_down" and self.shard < 0:
            raise ValueError("shard_down needs a concrete shard index")


def shard_down(shard: int, t0: float, t1: float) -> FaultEvent:
    """Shard ``shard``'s tier-1 device is down over ``[t0, t1)``: its μ1
    drops to 0 for the overlap and its key range fails over to survivors
    (the engine remaps its arrivals; on recovery the shard re-warms from a
    cold cache)."""
    return FaultEvent(kind="shard_down", t0=t0, t1=t1, shard=shard)


def device_degrade(tier: int, factor: float, t0: float, t1: float,
                   shard: int = -1) -> FaultEvent:
    """Tier ``tier`` runs at ``factor`` of its service rate over
    ``[t0, t1)`` — a straggler NVMe (tier 1) or a slow disk (tier 2).
    ``shard`` restricts a tier-1 degrade to one shard (-1 = all shards;
    tier-2 is a shared device, so ``shard`` is ignored there)."""
    return FaultEvent(kind="degrade", t0=t0, t1=t1, shard=shard, tier=tier,
                      factor=factor)


def tier2_outage(t0: float, t1: float) -> FaultEvent:
    """The shared tier-2 (HDD / IO thread) is unreachable over ``[t0, t1)``:
    μ2 drops to 0 — misses queue up with nowhere to drain."""
    return FaultEvent(kind="tier2_outage", t0=t0, t1=t1)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A wall-clock fault-injection schedule plus the client retry policy.

    events:      tuple of :class:`FaultEvent` (overlapping events compose
                 multiplicatively on the affected service rates)
    retry:       optional :class:`repro_torch.core.queuing.RetryPolicy` — client
                 timeout / backoff behavior; enables retry-feedback
                 dynamics (and metastability detection) in the fluid solve
    refill_cold: model the cold-cache refill after a shard_down recovery
                 by resetting the shard's windowed hit-rate telemetry (its
                 first post-recovery requests re-miss up to one cache's
                 worth of lines)

    The schedule is pure *data*: per-window μ-multipliers and λ-remap
    arrays derived from it ride the megabatch as operands, so fault grids
    sweep without recompiling the engine.
    """

    events: tuple = ()
    retry: Optional[RetryPolicy] = None
    refill_cold: bool = True

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, FaultEvent):
                raise ValueError(
                    f"FaultSpec.events must contain FaultEvent instances "
                    f"(use shard_down()/device_degrade()/tier2_outage()), "
                    f"got {ev!r}")

    def validate(self, n_shards: int) -> None:
        """Schedule/spec cross-checks (shard indices in range)."""
        for ev in self.events:
            if ev.shard >= n_shards:
                raise ValueError(
                    f"fault event {ev.kind!r} names shard {ev.shard} but "
                    f"n_shards={n_shards}")

    def down_intervals(self) -> tuple:
        """``(shard, t0, t1)`` triples of the shard_down events — the λ
        failover remap the storage layer applies."""
        return tuple((ev.shard, ev.t0, ev.t1) for ev in self.events
                     if ev.kind == "shard_down")

    def remap_signature(self) -> tuple:
        """The part of the schedule that changes the *tier-1 counter
        simulation* (arrival remapping): shard_down intervals only.
        Degrades, outages and retry policy act on the queuing side and are
        free to sweep over one cached counter run."""
        return self.down_intervals()

    def mu_multipliers(self, n_windows: int, window_dt: float,
                       n_shards: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-window service-rate multipliers ``(mu1_mult[S, W],
        mu2_mult[W])`` implied by the schedule.

        Each event scales the affected rates by its overlap fraction with
        every window (an event covering half a window at factor 0 halves
        that window's rate); overlapping events compose multiplicatively.
        These arrays are plain data — they feed ``fluid_two_tier``'s
        time-varying μ(t) and ride sweeps as operands.
        """
        edges = np.arange(n_windows + 1) * float(window_dt)
        mu1_mult = np.ones((n_shards, n_windows))
        mu2_mult = np.ones(n_windows)
        for ev in self.events:
            overlap = (np.minimum(edges[1:], ev.t1)
                       - np.maximum(edges[:-1], ev.t0))
            frac = np.clip(overlap / float(window_dt), 0.0, 1.0)
            if ev.kind == "shard_down":
                mu1_mult[ev.shard] *= 1.0 - frac
            elif ev.kind == "tier2_outage":
                mu2_mult *= 1.0 - frac
            elif ev.kind == "degrade" and ev.tier == 1:
                scale = 1.0 - frac * (1.0 - ev.factor)
                if ev.shard < 0:
                    mu1_mult *= scale[None, :]
                else:
                    mu1_mult[ev.shard] *= scale
            else:  # degrade tier 2 (shared device)
                mu2_mult *= 1.0 - frac * (1.0 - ev.factor)
        return mu1_mult, mu2_mult


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """One end-to-end scenario: traffic -> distributed tier 1 -> queuing."""

    traffic: TrafficSpec
    store: StoreConfig = StoreConfig()
    n_shards: int = 4
    mapping: str = "block"       # §III page->shard policy
    lam: float = 100.0           # offered arrival rate per process (req/s)
    k_servers: int = 1           # RPC service threads per process (M/G/k k)
    flow: str = "paper"          # paper | conserving (see core.queuing)
    rates: RateSpec = RateSpec()
    # When set, the queuing network uses this miss fraction instead of the
    # measured one (the §V worked example fixes p12 = 0.2).
    p12_override: Optional[float] = None
    # Time resolution of the report: every engine counter is additionally
    # resolved over this many equal windows of the request stream, and the
    # queuing network is re-solved per window (transient analysis +
    # saturation-onset detection). 1 = the historic steady-state-only
    # report.
    n_windows: int = 1
    # Wall-clock window duration in seconds. When set, it supersedes the
    # request-index windows: traffic is generated with arrival timestamps
    # (rate = traffic.rate, or lam * n_shards when unset), counters are
    # binned by arrival time (bin = t // window_dt, overflow clipping into
    # the last bin), and the per-window arrival rate is *measured* rather
    # than flat by construction. n_windows == 1 derives the window count
    # from the spec's nominal horizon (n_requests / rate — deterministic,
    # so compiled shapes do not depend on the sampled timestamps);
    # n_windows > 1 pins the count explicitly.
    window_dt: Optional[float] = None
    # Transient solver fed with the measured per-window rates: "fluid"
    # (queue-length carryover between windows, the default — see
    # repro_torch.core.queuing.fluid_two_tier) or "piecewise" (independent
    # per-window stationary solves, the stationary oracle path).
    transient_mode: str = "fluid"
    # Wall-clock fault-injection schedule + client retry policy (see
    # FaultSpec). Requires the wall-clock path (window_dt set) — faults are
    # timeline events — and transient_mode="fluid" when a retry policy or
    # any event is present (degraded-mode dynamics are fluid-only).
    faults: Optional[FaultSpec] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.n_windows < 1:
            raise ValueError("n_windows must be >= 1")
        if self.lam < 0:
            raise ValueError(
                f"lam (offered arrival rate) must be non-negative, got "
                f"{self.lam}")
        if self.k_servers < 1:
            raise ValueError(
                f"k_servers must be >= 1, got {self.k_servers}")
        if self.window_dt is not None and not (
                math.isfinite(self.window_dt) and self.window_dt > 0):
            raise ValueError(
                f"window_dt must be a positive finite number of seconds, "
                f"got {self.window_dt}")
        if self.transient_mode not in ("fluid", "piecewise"):
            raise ValueError(
                f"unknown transient_mode: {self.transient_mode!r}")
        if self.faults is not None:
            if self.window_dt is None:
                raise ValueError(
                    "fault schedules are wall-clock events: set window_dt "
                    "(the timed-arrivals path) to use SimSpec.faults")
            if self.transient_mode != "fluid":
                raise ValueError(
                    "SimSpec.faults needs transient_mode='fluid' (degraded-"
                    "mode and retry dynamics are fluid-only)")
            self.faults.validate(self.n_shards)
        if (self.rates.mu_load is not None
                and self.transient_mode != "fluid"):
            raise ValueError(
                "rates.mu_load (load-dependent service) needs "
                "transient_mode='fluid' — the piecewise mode solves "
                "stationary networks at fixed rates")
        if self.flow not in ("paper", "conserving"):
            raise ValueError(f"unknown flow convention: {self.flow!r}")
        for name in ("mu1_shards", "mu2_shards"):
            vec = getattr(self.rates, name)
            if vec is not None and len(vec) != self.n_shards:
                raise ValueError(
                    f"rates.{name} has {len(vec)} entries but n_shards="
                    f"{self.n_shards}"
                )
        if self.p12_override is not None and not 0.0 <= self.p12_override <= 1.0:
            raise ValueError("p12_override must be in [0, 1]")

    # -- wall-clock time axis ------------------------------------------------
    def agg_rate(self) -> float:
        """Aggregate offered arrival rate (req/s) of the workload's
        wall-clock arrival process: the traffic spec's own ``rate`` when
        set, else the queuing-side offered load ``lam * n_shards`` (the
        whole stream arrives at the aggregate rate — exactly the historic
        request-index assumption, now realized as actual timestamps)."""
        if self.traffic.rate > 0:
            return float(self.traffic.rate)
        return float(self.lam * self.n_shards)

    def window_grid(self) -> tuple[int, Optional[float]]:
        """The report's time grid ``(n_windows, window_dt)``.

        ``window_dt=None`` (historic): ``n_windows`` equal request-count
        slices. Otherwise wall-clock bins of ``window_dt`` seconds — the
        bin *count* comes from the spec's nominal horizon
        (:func:`repro_torch.core.traffic.nominal_duration`, padded by 4 standard
        deviations of the realized span so the sampled arrival process
        almost never overflows into the clipped last bin — trailing
        windows an early-finishing seed leaves empty are idle-guarded)
        when ``n_windows`` is the default 1, or from an explicit
        ``n_windows``. The count is deterministic from the spec (never
        from sampled timestamps), so compiled engine shapes are stable
        across seeds.
        """
        if self.window_dt is None:
            return self.n_windows, None
        if self.n_windows > 1:
            return self.n_windows, self.window_dt
        rate = self.agg_rate()
        horizon = (nominal_duration(self.traffic, rate)
                   + 4.0 * nominal_duration_std(self.traffic, rate))
        return max(1, math.ceil(horizon / self.window_dt)), self.window_dt

    # -- sweep support -------------------------------------------------------
    def replace(self, **updates) -> "SimSpec":
        """dataclasses.replace with dotted-path support:
        ``spec.replace(**{"store.n_lines": 128, "traffic.kind": "irm"})``.
        """
        direct: dict = {}
        nested: dict[str, dict] = {}
        for key, val in updates.items():
            if "." in key:
                head, rest = key.split(".", 1)
                nested.setdefault(head, {})[rest] = val
            else:
                direct[key] = val
        spec = dataclasses.replace(self, **direct) if direct else self
        for head, sub in nested.items():
            child = getattr(spec, head)
            new_child = (
                child.replace(**sub)
                if isinstance(child, SimSpec)
                else _replace_nested(child, sub)
            )
            spec = dataclasses.replace(spec, **{head: new_child})
        return spec

    def cache_signature(self) -> tuple:
        """Everything the tier-1 counter simulation depends on. Sweep points
        sharing a signature reuse one cache run (queuing params are free).
        The window grid is part of the signature: windowed counters depend
        on the time resolution even though totals do not. On the
        wall-clock path the *rate* of the arrival process matters too
        (timestamps scale with it), which is why ``agg_rate`` — and hence
        ``lam`` when the traffic spec carries no rate of its own — joins
        the signature only when ``window_dt`` is set. A fault schedule
        joins through its *remap signature* only (shard_down intervals
        reroute arrivals and so change the counters); degrades, outages
        and retry policies are queuing-side and sweep over one cached
        run."""
        remap = (self.faults.remap_signature() or None
                 if self.faults is not None else None)
        return (self.traffic, self.store, self.n_shards, self.mapping,
                self.window_grid(),
                self.agg_rate() if self.window_dt is not None else None,
                remap)


def _replace_nested(obj, updates: dict):
    direct = {k: v for k, v in updates.items() if "." not in k}
    out = dataclasses.replace(obj, **direct)
    for key, val in updates.items():
        if "." in key:
            head, rest = key.split(".", 1)
            out = dataclasses.replace(
                out, **{head: _replace_nested(getattr(out, head), {rest: val})}
            )
    return out
