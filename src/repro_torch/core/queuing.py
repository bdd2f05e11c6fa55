"""Queuing-network performance model of the two-tier store (paper §V).

Implements equations 1–7 plus the standard M/M/1, M/M/k and (Allen–Cunneen
approximate) M/G/k building blocks, and the paper's worked example.

The network (Fig. 5): read/write requests arrive at tier 1 at rate λ; hits
exit via the k-server RPC pool (M/G/k, service rate μ1); misses (fraction
``p12``) enter the single IO-thread queue (M/M/1, service rate μ2) and
re-enter tier 1 when serviced. The system is analyzable at equilibrium
(all utilization ratios < 1).

Two conventions for the *effective arrival rate* at the k-server queue:

- ``flow="paper"`` reproduces §V's worked example, which feeds the miss
  traffic back at rate ``p12 * μ2``  (λ_eff = (1-p12)·λ + p12·μ2; gives
  λ_eff = 86.6 for the example).
- ``flow="conserving"`` uses flow conservation at equilibrium (the miss
  queue's throughput equals its arrival rate): λ_eff = (1-p12)·λ + p12·λ = λ.

Every queue primitive and :class:`TwoTierModel` is **vectorized**: λ, μ and
``p12`` may be scalars or arbitrary-shape numpy arrays (broadcast against
each other); ``k`` stays a Python int (it is structural). Scalar inputs
return plain-float metrics, array inputs return arrays elementwise equal to
the scalar formulas — one call solves a whole ``[point, shard]`` or
``[shard, window]`` grid instead of a Python loop.

Beyond the equilibrium analysis, :func:`transient_two_tier` solves the
network over time windows in one of two modes:

- ``mode="piecewise"``: each window is an *independent* stationary solve at
  that window's measured arrival rate and miss fraction (the earlier path,
  kept as the stationary-limit oracle);
- ``mode="fluid"`` (:func:`fluid_two_tier`, the pipeline default): a
  pointwise-stationary fluid ODE ``dQ/dt = lam(t) - G(Q)`` integrated over
  the window grid **with queue-length carryover between windows**. The
  drain ``G`` is the exact inverse of the stationary queue-length map
  (PSFFA — for M/M/1, ``G(Q) = mu*Q/(1+Q)``; the pure-fluid limit of
  ``G`` is ``mu*min(Q, k)``), so constant-rate workloads land exactly on
  the piecewise/stationary solution while rate bursts show non-instant
  backlog drain — the transient view the paper's steady-state summary
  (and a window-independent solve) hides.

The fluid path additionally models **degraded-mode dynamics**: μ1/μ2 may
vary per window (fault schedules — a dead device is μ(t) = 0, handled
exactly: backlog grows at λ(t) and residence times report ∞ only where
load is actually offered), ``k_scale`` scales effective tier-1 capacity
over time, ``tier1_spill=True`` routes offered-above-capacity tier-1 work
to tier-2, and ``retry=RetryPolicy(...)`` closes a retrial-orbit feedback
loop (``dQ/dt = λ(t) + λ_retry(Q,t) − G(Q; μ(t))``): work that times out
re-enters the arrival stream after its backoff delay, so aggressive
timeouts produce *retry storms* — windows flagged ``metastable`` (stable
in external rates, unstable in total offered rate) with
:meth:`FluidReport.metastable_onset` locating the trailing storm.

This copy of the reference module carries its numpy half only: the
batched fluid solver (``fluid_two_tier_batched``) belongs to the sweep
route and is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, NamedTuple, Optional

import numpy as np

__all__ = [
    "ServiceTimes",
    "service_time_model",
    "system_service_rate",
    "mm1_queue",
    "mmk_queue",
    "mgk_queue",
    "QueueMetrics",
    "RetryPolicy",
    "TwoTierModel",
    "TwoTierReport",
    "TransientReport",
    "FluidReport",
    "transient_two_tier",
    "fluid_two_tier",
    "residence_times",
    "expected_response",
]


# ---------------------------------------------------------------------------
# Equations 1–4: total service time (non-equilibrium / minimum-time model).
# ---------------------------------------------------------------------------


class ServiceTimes(NamedTuple):
    t_hit: np.ndarray   # T_h_i per process (eq. 1)
    t_miss: np.ndarray  # T_m_i per process (eq. 2)
    t_proc: np.ndarray  # T_i = max(T_h, T_m) per process (eq. 3)
    t_total: float      # T = max_i T_i (eq. 4)


def service_time_model(
    n_read: np.ndarray,
    n_write: np.ndarray,
    n_miss: np.ndarray,
    mu1_read: float,
    mu1_write: float,
    mu2: float,
) -> ServiceTimes:
    """Equations 1–4. Inputs are per-process request/miss counts."""
    n_read = np.asarray(n_read, float)
    n_write = np.asarray(n_write, float)
    n_miss = np.asarray(n_miss, float)
    t_hit = n_read / mu1_read + n_write / mu1_write
    t_miss = n_miss / mu2
    t_proc = np.maximum(t_hit, t_miss)
    return ServiceTimes(t_hit, t_miss, t_proc, float(np.max(t_proc)))


def system_service_rate(mu1, mu2, p12):
    """Equation 5: harmonic composition of tier service rates (elementwise
    over broadcastable array inputs)."""
    inv = (1.0 - p12) / mu1 + p12 / mu2
    return 1.0 / inv


# ---------------------------------------------------------------------------
# Queue primitives (vectorized; scalar in -> scalar out).
# ---------------------------------------------------------------------------


class QueueMetrics(NamedTuple):
    rho: np.ndarray     # utilization (per-server for k-server queues)
    p0: np.ndarray      # probability of an empty system
    lq: np.ndarray      # expected queue length (waiting)
    l: np.ndarray       # expected number in system
    wq: np.ndarray      # expected waiting time
    w: np.ndarray       # expected time in system
    stable: np.ndarray  # bool


def _metrics(rho, p0, lq, l, wq, w, stable) -> QueueMetrics:
    """Pack metrics; 0-d arrays collapse to plain float/bool (the historic
    scalar API)."""
    if np.ndim(rho) == 0:
        return QueueMetrics(float(rho), float(p0), float(lq), float(l),
                            float(wq), float(w), bool(stable))
    return QueueMetrics(np.asarray(rho, float), np.asarray(p0, float),
                        np.asarray(lq, float), np.asarray(l, float),
                        np.asarray(wq, float), np.asarray(w, float),
                        np.asarray(stable, bool))


def mm1_queue(lam, mu) -> QueueMetrics:
    """M/M/1 (paper eq. 7 uses Lq = rho^2/(1-rho)). Vectorized over
    broadcastable ``lam``/``mu`` arrays; λ ≤ 0 means an idle queue (empty,
    residence = pure service) and ρ ≥ 1 a saturated one (inf waits).
    A dead device (μ ≤ 0) reports ρ = inf / unstable when offered work and
    a stable-but-unserviceable queue (inf residence) when idle."""
    lam, mu = np.broadcast_arrays(np.asarray(lam, float), np.asarray(mu, float))
    idle = lam <= 0.0
    dead = mu <= 0.0
    lam_safe = np.where(idle, 1.0, lam)
    mu_safe = np.where(dead, 1.0, mu)
    rho = np.where(idle, 0.0, np.where(dead, np.inf, lam_safe / mu_safe))
    stable = rho < 1.0
    live = stable & ~idle
    one_minus = np.where(stable, 1.0 - rho, 1.0)
    lq = np.where(stable, rho * rho / one_minus, np.inf)
    l = np.where(stable, rho / one_minus, np.inf)
    wq = np.where(live, lq / lam_safe, np.where(idle, 0.0, np.inf))
    w_idle = np.where(dead, np.inf, 1.0 / mu_safe)
    w = np.where(live, l / lam_safe, np.where(idle, w_idle, np.inf))
    p0 = np.where(stable, 1.0 - rho, 0.0)
    return _metrics(rho, p0, lq, l, wq, w, stable)


def _mmk_p0(a, k: int):
    """P0 for M/M/k with offered load a = lam/mu (paper cites [42]).
    Vectorized over ``a``; only meaningful where a < k."""
    a = np.asarray(a, float)
    a_clip = np.minimum(a, k * (1.0 - 1e-12))  # keep the tail term finite
    s = sum(a_clip**i / math.factorial(i) for i in range(k))
    s = s + a_clip**k / (math.factorial(k) * (1.0 - a_clip / k))
    return 1.0 / s


def mmk_queue(lam, mu, k: int) -> QueueMetrics:
    """M/M/k. Paper eq. 6: L1 = P0 * a^(k+1) / ((k-1)! (k-a)^2), a = lam/mu.
    Vectorized over broadcastable ``lam``/``mu``; ``k`` is a Python int.
    Dead devices (μ ≤ 0) follow the :func:`mm1_queue` convention: offered
    work ⇒ a = inf / unstable; idle ⇒ stable with inf residence."""
    lam, mu = np.broadcast_arrays(np.asarray(lam, float), np.asarray(mu, float))
    idle = lam <= 0.0
    dead = mu <= 0.0
    lam_safe = np.where(idle, 1.0, lam)
    mu_safe = np.where(dead, 1.0, mu)
    a = np.where(idle, 0.0, np.where(dead, np.inf, lam_safe / mu_safe))
    rho = a / k
    stable = rho < 1.0
    live = stable & ~idle
    p0 = np.where(stable, _mmk_p0(a, k), 0.0)
    k_minus_a = np.where(stable, k - a, 1.0)
    # a is finite wherever `stable` picks the first branch; a_fin keeps the
    # discarded branch's powers finite so no inf*0 NaNs leak out of where.
    a_fin = np.where(stable, a, 0.0)
    lq = np.where(
        stable,
        p0 * a_fin ** (k + 1) / (math.factorial(k - 1) * k_minus_a**2),
        np.inf,
    )
    l = np.where(stable, lq + a_fin, np.inf)
    wq = np.where(live, lq / lam_safe, np.where(idle, 0.0, np.inf))
    w_idle = np.where(dead, np.inf, 1.0 / mu_safe)
    w = np.where(live, l / lam_safe, np.where(idle, w_idle, np.inf))
    p0 = np.where(idle, 1.0, p0)
    return _metrics(rho, p0, lq, l, wq, w, stable)


def mgk_queue(lam, mean_s, var_s, k: int) -> QueueMetrics:
    """M/G/k via the Allen–Cunneen approximation:
    Lq(M/G/k) ≈ Lq(M/M/k) * (1 + C_s^2) / 2, C_s^2 = var/mean^2.

    The paper derives its tier-1 queue "using the mean and variance of the
    read/write service (hit) time distribution" — this is that model.
    Vectorized like :func:`mmk_queue`.
    """
    # Broadcast *before* the base M/M/k solve so its metrics already carry
    # the full output shape (a var_s wider than lam must widen everything).
    lam_b, mean_b, var_b = np.broadcast_arrays(
        np.asarray(lam, float), np.asarray(mean_s, float),
        np.asarray(var_s, float))
    # A dead device arrives here as mean_s = inf (1/mu with mu = 0): its
    # service rate becomes 0 and mmk_queue's dead-device convention applies.
    with np.errstate(divide="ignore"):
        base = mmk_queue(lam_b, 1.0 / mean_b, k)
    idle = lam_b <= 0.0
    lam_safe = np.where(idle, 1.0, lam_b)
    live = np.asarray(base.stable, bool) & ~idle
    mean_fin = np.where(np.isfinite(mean_b), mean_b, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        cs2 = var_b / (mean_b * mean_b)
    cs2 = np.where(np.isfinite(cs2), cs2, 0.0)
    scale = (1.0 + cs2) / 2.0
    lq = np.where(live, base.lq * scale, base.lq)
    l = np.where(live, lq + lam_b * mean_fin, base.l)
    wq = np.where(live, lq / lam_safe, base.wq)
    w = np.where(live, l / lam_safe, base.w)
    return _metrics(base.rho, base.p0, lq, l, wq, w, base.stable)


# ---------------------------------------------------------------------------
# The composed two-tier model (Fig. 5 + eqs. 5–7).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTierModel:
    """Per-process two-tier queuing network.

    lam:  workload request arrival rate (reqs/sec per process)
    mu1:  tier-1 hit service rate (per RPC server; includes RPC + sync costs)
    mu2:  tier-2 miss service rate (IO thread + HDD)
    p12:  miss rate (fraction of requests forwarded to tier 2)
    k:    RPC service threads per process (k-server queue)
    var_s1: variance of tier-1 service time (M/G/k); 0 => exponential M/M/k

    ``lam``/``mu1``/``mu2``/``p12`` may be broadcastable numpy arrays; the
    whole analysis then runs elementwise (one solve for a grid of operating
    points instead of a Python loop).
    """

    lam: float
    mu1: float
    mu2: float
    p12: float
    k: int = 1
    var_s1: float = 0.0
    flow: Literal["paper", "conserving"] = "paper"

    def effective_arrival(self):
        """Arrival rate at the k-server (tier-1) queue."""
        if self.flow == "paper":
            # §V worked example: misses re-enter at rate p12 * mu2.
            return (1.0 - self.p12) * self.lam + self.p12 * self.mu2
        return self.lam

    def analyze(self) -> "TwoTierReport":
        lam_eff = self.effective_arrival()
        # Tier-1 k-server queue: M/G/k where var_s1 > 0, M/M/k where it is
        # 0 — elementwise, so a mixed var_s1 array keeps the documented
        # "0 => exponential M/M/k" contract per element. Dead devices
        # (mu = 0) flow through as 1/mu = inf mean service times; the
        # errstate guard keeps that conversion warning-free.
        var = np.asarray(self.var_s1, float)
        if not np.any(var > 0):
            q1 = mmk_queue(lam_eff, self.mu1, self.k)
        else:
            with np.errstate(divide="ignore"):
                inv_mu1 = 1.0 / np.asarray(self.mu1, float)
            q1 = mgk_queue(lam_eff, inv_mu1, var, self.k)
            if np.any(var <= 0):
                q_m = mmk_queue(lam_eff, self.mu1, self.k)
                pick = var > 0
                # np.where keeps bool dtype for the stable field.
                q1 = QueueMetrics(*[
                    np.where(pick, g, m) for g, m in zip(q1, q_m)
                ])
        # Tier-2 M/M/1 miss queue (eq. 7).
        lam_miss = self.p12 * self.lam
        q2 = mm1_queue(lam_miss, self.mu2)
        with np.errstate(divide="ignore", invalid="ignore"):
            mu_sys = system_service_rate(self.mu1, self.mu2, self.p12)
            rho_sys = self.lam / mu_sys
        eq = np.logical_and(q1.stable, q2.stable)
        return TwoTierReport(
            model=self,
            lam_eff=lam_eff,
            q1=q1,
            q2=q2,
            mu_system=mu_sys,
            rho_system=rho_sys,
            equilibrium=bool(eq) if np.ndim(eq) == 0 else eq,
        )

    def time_for(self, n_requests: int) -> dict[str, float]:
        """§V worked example: wall time for ``n_requests`` arrivals plus the
        pure response time (all requests at tier-1 service rate)."""
        lam_eff = self.effective_arrival()
        return {
            "arrival_window_s": n_requests / lam_eff,
            "response_time_s": n_requests / self.mu1,
        }


@dataclasses.dataclass(frozen=True)
class TwoTierReport:
    model: TwoTierModel
    lam_eff: float
    q1: QueueMetrics
    q2: QueueMetrics
    mu_system: float
    rho_system: float
    equilibrium: bool

    def summary(self) -> dict[str, float]:
        return {
            "lam_eff": self.lam_eff,
            "rho1": self.q1.rho * self.model.k,  # offered load a = lam/mu
            "rho2": self.q2.rho,
            "L1": self.q1.lq,
            "W1": self.q1.wq,
            "L2": self.q2.lq,
            "W2": self.q2.wq,
            "mu_system": self.mu_system,
            "rho_system": self.rho_system,
            "equilibrium": (
                float(self.equilibrium)
                if np.ndim(self.equilibrium) == 0
                else np.asarray(self.equilibrium, float)
            ),
        }


def residence_times(wq1, wq2, mu1, mu2, stable):
    """Residence times W = Wq + 1/μ for both tiers; wherever *either* queue
    saturates (``stable`` False) both report inf — the shared convention of
    the steady-state and transient reports."""
    stable = np.asarray(stable, bool)
    # 1/mu -> inf for dead devices (mu = 0): residence on a dead-but-idle
    # tier is inf by convention, not a warning.
    with np.errstate(divide="ignore"):
        w1 = np.where(stable, wq1 + 1.0 / np.asarray(mu1, float), np.inf)
        w2 = np.where(stable, wq2 + 1.0 / np.asarray(mu2, float), np.inf)
    return w1, w2


def expected_response(w1, w2, p12):
    """Expected response time w1 + p12*w2, elementwise, guarding both
    factors so p12 = 0 never multiplies an inf w2 (0*inf = nan)."""
    has_miss = np.asarray(p12) > 0.0
    return w1 + np.where(has_miss, p12, 0.0) * np.where(has_miss, w2, 0.0)


# ---------------------------------------------------------------------------
# Retry policy (client timeouts + exponential backoff).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client retry behavior: timeout, retry budget, exponential backoff.

    A request whose *virtual wait* at tier 1 (backlog over capacity,
    ``w_v = (Q1 + 1) / (k * mu1)``) exceeds ``timeout`` is abandoned by its
    client and re-issued after a backoff delay — but the abandoned work
    **stays in the server queue** (the server cannot tell), which is the
    wasted-work amplification that turns aggressive timeouts into retry
    storms. The fluid model tracks one *orbit* per retry attempt ``r``
    (0-based): timed-out offered work enters orbit 0, re-offers at rate
    ``R_r / d_r``, and on a further timeout cascades to orbit ``r+1``
    until the retry budget is spent (then it is *dropped* — the client
    gives up).

    timeout:       client timeout in seconds (must be > 0). Requests whose
                   virtual wait exceeds it re-enter the arrival stream.
    max_retries:   retry budget per request (>= 0; 0 disables retries —
                   timed-out requests are dropped immediately).
    backoff_base:  exponential backoff multiplier between attempts (>= 1;
                   1.0 = constant backoff, i.e. no exponential growth).
    backoff_init:  delay before the first retry, seconds (0 -> ``timeout``,
                   the common "retry as soon as the RPC deadline fires").
    backoff_cap:   upper bound on any backoff delay, seconds (0 -> no cap).
    jitter:        fractional jitter in [0, 1) applied by real clients to
                   desynchronize retries. The fluid (mean-field) model is
                   jitter-invariant — the *mean* re-offer rate of a jittered
                   exponential backoff equals the unjittered one — so this
                   field documents the client config but does not change
                   the ODE. Kept for spec fidelity and report metadata.
    """

    timeout: float
    max_retries: int = 3
    backoff_base: float = 2.0
    backoff_init: float = 0.0
    backoff_cap: float = 0.0
    jitter: float = 0.0

    def __post_init__(self):
        if not (self.timeout > 0.0):
            raise ValueError(
                f"RetryPolicy.timeout must be > 0, got {self.timeout}")
        if self.max_retries < 0:
            raise ValueError(
                f"RetryPolicy.max_retries must be >= 0, got "
                f"{self.max_retries}")
        if self.backoff_base < 1.0:
            raise ValueError(
                f"RetryPolicy.backoff_base must be >= 1, got "
                f"{self.backoff_base}")
        if self.backoff_init < 0.0:
            raise ValueError(
                f"RetryPolicy.backoff_init must be >= 0, got "
                f"{self.backoff_init}")
        if self.backoff_cap < 0.0:
            raise ValueError(
                f"RetryPolicy.backoff_cap must be >= 0, got "
                f"{self.backoff_cap}")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(
                f"RetryPolicy.jitter must be in [0, 1), got {self.jitter}")

    def delays(self) -> np.ndarray:
        """Backoff delay before attempt ``r`` (seconds), shape
        ``[max_retries]``: ``min(cap, init * base**r)`` with the 0-means-
        default conventions of :class:`RetryPolicy`."""
        init = self.backoff_init if self.backoff_init > 0.0 else self.timeout
        d = init * self.backoff_base ** np.arange(self.max_retries, dtype=float)
        if self.backoff_cap > 0.0:
            d = np.minimum(d, self.backoff_cap)
        return d


# ---------------------------------------------------------------------------
# Transient analysis (windowed telemetry -> the network).
# ---------------------------------------------------------------------------


def _sanitize_rates(lam, p12):
    """Guard measured per-window inputs: all-idle windows (lambda = 0 burst
    gaps) sometimes reach the solver as NaN (0/0 from an empty window's
    rate estimate). Treat non-finite entries as idle (lambda = 0, p12 = 0)
    so they solve as empty queues instead of poisoning the utilization
    series — and through it the saturation-onset index."""
    lam = np.asarray(lam, float)
    p12 = np.asarray(p12, float)
    lam = np.where(np.isfinite(lam), lam, 0.0)
    idle = lam <= 0.0
    p12 = np.where(np.isfinite(p12) & ~idle, p12, 0.0)
    return lam, p12


def _sanitize_mu(mu):
    """Guard service-rate inputs: clamp negatives and non-finite entries to
    0 (= dead device). A fault schedule that zeroes mu during an outage
    window must flow through as a *dead* device — cleanly growing fluid
    backlog / unstable stationary solve — never as a divide-by-zero or a
    poisoned bisection bracket. Strictly positive finite rates pass through
    bit-identical."""
    mu = np.asarray(mu, float)
    return np.where(np.isfinite(mu), np.maximum(mu, 0.0), 0.0)


class TransientReport(NamedTuple):
    """Per-window solution of the two-tier network, last axis = time window.

    Each window is solved as a stationary network at that window's measured
    arrival rate and miss fraction (piecewise-stationary approximation —
    valid when windows are long relative to queue relaxation times). ``w1``
    / ``w2`` are residence times (waiting + service); windows where either
    queue saturates report ``inf`` latencies and ``stable=False``.
    """

    lam: np.ndarray       # measured arrival rate per window
    p12: np.ndarray       # measured miss fraction per window
    lam_eff: np.ndarray   # effective tier-1 arrival rate
    rho1: np.ndarray      # tier-1 offered load (a = lam_eff/mu1)
    rho2: np.ndarray      # tier-2 utilization
    w1: np.ndarray        # tier-1 residence time (s)
    w2: np.ndarray        # tier-2 residence time (s)
    response: np.ndarray  # expected response: w1 + p12 * w2
    stable: np.ndarray    # bool per window

    def onset(self) -> np.ndarray:
        """Saturation onset: index of the first unstable window along the
        time axis, -1 where every window is stable. Shape = stable.shape
        minus the window axis."""
        unstable = ~np.asarray(self.stable, bool)
        first = np.argmax(unstable, axis=-1)
        return np.where(np.any(unstable, axis=-1), first, -1)


def transient_two_tier(
    lam,
    p12,
    mu1,
    mu2,
    *,
    k: int = 1,
    var_s1: float = 0.0,
    flow: str = "paper",
    mode: Literal["piecewise", "fluid"] = "piecewise",
    dt: Optional[float] = None,
    q0=None,
    n_substeps: int = 8,
    retry: Optional[RetryPolicy] = None,
    tier1_spill: bool = False,
    k_scale=None,
    mu_load=None,
) -> "TransientReport | FluidReport":
    """Solve the two-tier network over the window grid.

    ``lam``/``p12`` carry the time axis last (e.g. ``[window]`` or
    ``[shard, window]``); ``mu1``/``mu2`` broadcast against them (scalars,
    or ``[shard, 1]`` for per-shard device rates). Returns latency /
    utilization time series plus per-series saturation onsets via
    :meth:`TransientReport.onset`.

    ``mode="piecewise"`` (this function's historic behavior, the
    stationary-limit oracle) solves every window independently at its own
    measured rates. ``mode="fluid"`` delegates to :func:`fluid_two_tier`
    (requires ``dt``, the wall-clock window duration): the same per-window
    rates drive a fluid ODE whose queue state carries over between windows.
    """
    if mode == "fluid":
        if dt is None:
            raise ValueError("mode='fluid' requires dt (window duration, s)")
        return fluid_two_tier(
            lam, p12, mu1, mu2, dt=dt, k=k, var_s1=var_s1, flow=flow,
            q0=q0, n_substeps=n_substeps, retry=retry,
            tier1_spill=tier1_spill, k_scale=k_scale, mu_load=mu_load,
        )
    if mode != "piecewise":
        raise ValueError(f"unknown transient mode: {mode!r}")
    if retry is not None or tier1_spill or k_scale is not None \
            or mu_load is not None:
        raise ValueError(
            "retry feedback / tier-1 spill / k(t) scaling / load-dependent "
            "mu(Q) are fluid-only dynamics: use mode='fluid' (the piecewise "
            "mode solves each window as an independent stationary network)")
    lam, p12 = _sanitize_rates(lam, p12)
    lam = np.atleast_1d(lam)
    p12 = np.atleast_1d(p12)
    mu1 = np.asarray(mu1, float)
    mu2 = np.asarray(mu2, float)
    rep = TwoTierModel(
        lam=lam, mu1=mu1, mu2=mu2, p12=p12, k=k, var_s1=var_s1,
        flow=flow,  # type: ignore[arg-type]
    ).analyze()
    stable = np.broadcast_arrays(
        np.asarray(rep.equilibrium, bool), lam
    )[0].astype(bool)
    w1, w2 = residence_times(rep.q1.wq, rep.q2.wq, mu1, mu2, stable)
    response = expected_response(w1, w2, p12)
    return TransientReport(
        lam=lam,
        p12=p12,
        lam_eff=np.broadcast_arrays(np.asarray(rep.lam_eff, float), lam)[0],
        rho1=np.broadcast_arrays(np.asarray(rep.q1.rho, float) * k, lam)[0],
        rho2=np.broadcast_arrays(np.asarray(rep.q2.rho, float), lam)[0],
        w1=w1,
        w2=w2,
        response=response,
        stable=stable,
    )


# ---------------------------------------------------------------------------
# Fluid transient analysis: pointwise-stationary fluid ODE with carryover.
# ---------------------------------------------------------------------------


class FluidReport(NamedTuple):
    """Fluid-flow transient solution of the two-tier network, last axis =
    time window.

    Unlike :class:`TransientReport` (independent per-window stationary
    solves), the fluid state carries over between windows: after a rate
    burst the backlog drains at the servers' capacity, so latency stays
    elevated for a physically-determined number of windows instead of
    snapping back. ``w1``/``w2`` stay *finite* through saturated windows
    (the fluid backlog is finite at any finite time); ``stable`` flags
    windows whose offered rates exceed capacity (same onset semantics as
    the piecewise report), and ``q1``/``q2`` expose the window-mean fluid
    queue lengths themselves.
    """

    lam: np.ndarray       # measured arrival rate per window
    p12: np.ndarray       # measured miss fraction per window
    lam_eff: np.ndarray   # nominal effective tier-1 arrival rate
    rho1: np.ndarray      # tier-1 served offered load (throughput / mu1)
    rho2: np.ndarray      # tier-2 utilization (throughput / mu2)
    w1: np.ndarray        # tier-1 residence time (s), finite in overload
    w2: np.ndarray        # tier-2 residence time (s)
    response: np.ndarray  # expected response: w1 + p12 * w2
    stable: np.ndarray    # bool per window (offered rate below capacity)
    q1: np.ndarray        # window-mean tier-1 fluid queue length
    q2: np.ndarray        # window-mean tier-2 fluid queue length
    # Retry-feedback diagnostics (None unless solved with a RetryPolicy):
    retry_rate: Optional[np.ndarray] = None  # window-mean re-offered rate
    orbit: Optional[np.ndarray] = None       # window-mean orbit population
    dropped: Optional[np.ndarray] = None     # window-mean give-up rate
    # metastable: external rates below capacity but total offered (external
    # + retries) above it — the system would be stable without the retry
    # feedback yet cannot drain. None unless solved with a RetryPolicy.
    metastable: Optional[np.ndarray] = None
    # Terminal (end-of-horizon) fluid backlogs — the q0 a continuation
    # solve resumes from (q1/q2 above are window *means*, useless as
    # initial conditions). Shape = the leading axes, no window axis.
    q1_end: Optional[np.ndarray] = None
    q2_end: Optional[np.ndarray] = None

    def onset(self) -> np.ndarray:
        """Saturation onset: index of the first unstable window along the
        time axis, -1 where every window is stable (idle/NaN-rate windows
        count as stable — see ``_sanitize_rates``)."""
        unstable = ~np.asarray(self.stable, bool)
        first = np.argmax(unstable, axis=-1)
        return np.where(np.any(unstable, axis=-1), first, -1)

    def metastable_onset(self) -> np.ndarray:
        """Onset of the *trailing* metastable run: the first window of the
        contiguous metastable stretch that persists through the end of the
        horizon, -1 where the final window is healthy (a transient storm
        that drains before the horizon ends is not metastable — the flag
        marks non-recovering states, analogous to :meth:`onset` for
        saturation). Shape = metastable.shape minus the window axis."""
        if self.metastable is None:
            return np.full(np.shape(self.stable)[:-1], -1, dtype=int)
        m = np.asarray(self.metastable, bool)
        n = m.shape[-1]
        rev = m[..., ::-1]
        # Length of the trailing True run = index of the first False in the
        # reversed series (n when the whole series is metastable).
        trail = np.where(rev.all(axis=-1), n, np.argmin(rev, axis=-1))
        return np.where(m[..., -1], n - trail, -1)


def _stationary_l1(x, mu1, k: int, var_s1) -> np.ndarray:
    """Stationary tier-1 queue length L(x) at arrival rate ``x`` (M/M/k, or
    M/G/k elementwise where var_s1 > 0 — the same dispatch as
    :meth:`TwoTierModel.analyze`)."""
    var = np.asarray(var_s1, float)
    if not np.any(var > 0):
        return np.asarray(mmk_queue(x, mu1, k).l, float)
    with np.errstate(divide="ignore"):
        inv_mu1 = 1.0 / np.asarray(mu1, float)
    l_g = np.asarray(mgk_queue(x, inv_mu1, var, k).l, float)
    if np.any(var <= 0):
        l_m = np.asarray(mmk_queue(x, mu1, k).l, float)
        return np.where(var > 0, l_g, l_m)
    return l_g


def _implicit_mm1_step(l, a, mu, h):
    """One implicit-Euler substep of the M/M/1 PSFFA ODE
    ``dL/dt = a - mu*L/(1+L)``: returns (L_next, served rate x). The update
    solves ``L' + h*x = L + h*a`` with ``L' = x/(mu-x)`` — a quadratic in
    ``x`` whose lower root always lies in [0, mu)."""
    r = l + h * a
    b = 1.0 + h * mu + r
    disc = b * b - 4.0 * h * r * mu
    x = (b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * h)
    x = np.clip(x, 0.0, None)
    return l + h * (a - x), x


def _implicit_l1_step(l, a, mu1, k: int, var_s1, h, hi):
    """One implicit-Euler substep for the tier-1 queue: solve the served
    rate ``x`` in [0, k*mu1) with ``L1(x) + h*x = L + h*a`` (monotone in
    ``x`` — vectorized bisection), where L1 is the stationary M/M/k / M/G/k
    queue-length map."""
    rhs = l + h * a
    lo = np.zeros_like(rhs)
    hi = np.broadcast_to(hi, rhs.shape).copy()
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        too_high = _stationary_l1(mid, mu1, k, var_s1) + h * mid > rhs
        hi = np.where(too_high, mid, hi)
        lo = np.where(too_high, lo, mid)
        # The bracket halves every iteration; stop once the whole grid is
        # resolved well past f32-output precision (each iteration is a
        # full vectorized M/M/k / M/G/k solve — the dominant cost here).
        if np.all(hi - lo <= 1e-9 * np.maximum(hi, 1.0)):
            break
    x = 0.5 * (lo + hi)
    return l + h * (a - x), x


def _norm_mu_load(mu_load):
    """Validate/normalize the load-dependent service hook: ``((a1, b1),
    (a2, b2))`` per-tier coefficients of the rational load factor
    ``f(Q) = (1 + a*Q) / (1 + b*Q)`` applied multiplicatively to μ at each
    substep's queue state (``b > a`` models a device that slows under
    backlog, ``a > b`` one that batches better; ``a = b = 0`` is exactly
    the identity). Returns the normalized nested float tuple or None."""
    if mu_load is None:
        return None
    try:
        (a1, b1), (a2, b2) = mu_load
        coefs = tuple(float(v) for v in (a1, b1, a2, b2))
    except (TypeError, ValueError) as exc:
        raise ValueError(
            "mu_load must be ((a1, b1), (a2, b2)) per-tier load-factor "
            f"coefficients, got {mu_load!r}") from exc
    for v in coefs:
        if not (math.isfinite(v) and v >= 0.0):
            raise ValueError(
                "mu_load coefficients must be finite and >= 0, got "
                f"{mu_load!r}")
    if not any(coefs):
        # a = b = 0 is the identity factor: route to the plain fixed-rate
        # kernel so "all-zero coefficients" is *bitwise* "off" (a separate
        # kernel computing f(Q)=1 would fuse differently at the ulp level).
        return None
    return ((coefs[0], coefs[1]), (coefs[2], coefs[3]))


class _FluidInputs(NamedTuple):
    """Sanitized/broadcast solver inputs shared by the numpy and batched
    fluid paths (everything before the window loop, bit-identical)."""

    lam: np.ndarray       # [..., W] sanitized arrival rates
    p12: np.ndarray       # [..., W] sanitized miss fractions
    p12_fill: np.ndarray  # [..., W] p12 carried forward over idle windows
    lam_eff: np.ndarray   # [..., W] nominal effective tier-1 arrivals
    lam2: np.ndarray      # [..., W] nominal tier-2 arrivals
    mu1_w: np.ndarray     # [..., W] per-window tier-1 rates (k_scale folded)
    mu2_w: np.ndarray     # [..., W] per-window tier-2 rates
    h: np.ndarray         # [lead] substep duration
    l1: np.ndarray        # [lead] initial tier-1 fluid backlog
    l2: np.ndarray        # [lead] initial tier-2 fluid backlog
    full: tuple           # broadcast shape incl. window axis
    lead: tuple           # leading (batch) shape
    n_windows: int
    analytic1: bool       # k == 1 and no service-time variance anywhere


def _fluid_inputs(lam, p12, mu1, mu2, *, dt, k, var_s1, flow, q0,
                  n_substeps, k_scale) -> _FluidInputs:
    """Shared head of the fluid solvers: sanitize, broadcast, compute the
    nominal flows, forward-fill p12 over idle windows and warm-start the
    initial backlog. Pure numpy — both the scalar and the batched solver
    consume bit-identical inputs."""
    lam, p12 = _sanitize_rates(lam, p12)
    lam = np.atleast_1d(lam)
    p12 = np.atleast_1d(p12)
    lam, p12 = np.broadcast_arrays(lam, p12)
    mu1 = _sanitize_mu(mu1)
    mu2 = _sanitize_mu(mu2)
    if k_scale is not None:
        mu1 = mu1 * np.maximum(np.asarray(k_scale, float), 0.0)
    full = np.broadcast_shapes(lam.shape, mu1.shape, mu2.shape)
    lam = np.broadcast_to(lam, full)
    p12 = np.broadcast_to(p12, full)
    mu1_w = np.broadcast_to(mu1, full)
    mu2_w = np.broadcast_to(mu2, full)
    lead = full[:-1]
    n_windows = full[-1]
    dt = np.broadcast_to(np.asarray(dt, float), lead)
    if np.any(dt <= 0.0):
        raise ValueError("dt (window duration) must be positive")
    if n_substeps < 1:
        raise ValueError("n_substeps must be >= 1")

    # Nominal effective arrival rates per window (same flow conventions as
    # the stationary model).
    if flow == "paper":
        lam_eff = (1.0 - p12) * lam + p12 * mu2_w
    elif flow == "conserving":
        lam_eff = lam.copy()
    else:
        raise ValueError(f"unknown flow convention: {flow!r}")
    # Idle windows offer nothing to tier 1 (no arrivals -> no re-entries).
    lam_eff = np.where(lam > 0.0, lam_eff, 0.0)
    lam2 = p12 * lam

    cap1 = float(k) * mu1_w[..., 0] * (1.0 - 1e-12)
    analytic1 = k == 1 and not np.any(np.asarray(var_s1, float) > 0)

    # Initial state: warm (first-window equilibrium, clipped to empty where
    # that window is already saturated) or explicit backlogs.
    if q0 is None:
        a1_0, a2_0 = lam_eff[..., 0], lam2[..., 0]
        s1 = a1_0 < cap1
        l1 = np.where(
            s1, _stationary_l1(np.where(s1, a1_0, 0.0), mu1_w[..., 0], k,
                               var_s1), 0.0)
        s2 = a2_0 < mu2_w[..., 0]
        l2 = np.where(
            s2,
            np.asarray(mm1_queue(np.where(s2, a2_0, 0.0), mu2_w[..., 0]).l,
                       float),
            0.0)
        l1 = np.broadcast_to(l1, lead).astype(float).copy()
        l2 = np.broadcast_to(l2, lead).astype(float).copy()
    else:
        q1_0, q2_0 = q0 if isinstance(q0, (tuple, list)) else (q0, q0)
        l1 = np.broadcast_to(np.asarray(q1_0, float), lead).copy()
        l2 = np.broadcast_to(np.asarray(q2_0, float), lead).copy()

    # p12 carried forward over idle windows: sanitizing set their p12 to 0,
    # which would snap `response` to bare service time while w2/q2 still
    # show a residual tier-2 backlog draining — the virtual-wait convention
    # must survive composition. The retry path also composes re-offered
    # traffic with the filled p12 (retries during an idle gap are re-issued
    # reads with the workload's last observed miss fraction).
    p12_fill = np.array(p12, copy=True)
    idle = lam <= 0.0
    for w in range(1, n_windows):
        p12_fill[..., w] = np.where(idle[..., w], p12_fill[..., w - 1],
                                    p12[..., w])

    h = dt / n_substeps
    return _FluidInputs(
        lam=lam, p12=p12, p12_fill=p12_fill, lam_eff=lam_eff, lam2=lam2,
        mu1_w=mu1_w, mu2_w=mu2_w, h=h, l1=l1, l2=l2, full=full, lead=lead,
        n_windows=n_windows, analytic1=analytic1,
    )


def _fluid_report(fi: _FluidInputs, *, k, has_retry, q1_mean, q2_mean,
                  g1_mean, g2_mean, off1, off2, tot1, tot2, retry_mean,
                  orbit_mean, drop_mean, l1, l2) -> FluidReport:
    """Shared tail of the fluid solvers: dead-device guards, Little's-law
    residence times, stability/metastability flags and report packing —
    pure numpy on the window-loop outputs, bit-identical across paths."""
    lam_eff, lam2 = fi.lam_eff, fi.lam2
    mu1_w, mu2_w = fi.mu1_w, fi.mu2_w
    # Dead-device guards: mu = 0 windows report rho = inf (work offered) or
    # 0 (truly idle), and inf residence whenever anything is offered or
    # backlogged. For mu > 0 every expression below is op-identical to the
    # historic path (safe_mu == mu elementwise).
    tiny = 1e-9
    dead1 = mu1_w <= 0.0
    dead2 = mu2_w <= 0.0
    safe_mu1 = np.where(dead1, 1.0, mu1_w)
    safe_mu2 = np.where(dead2, 1.0, mu2_w)
    rho1 = np.where(dead1, np.where(off1 > tiny, np.inf, 0.0),
                    g1_mean / safe_mu1)
    rho2 = np.where(dead2, np.where(off2 > tiny, np.inf, 0.0),
                    g2_mean / safe_mu2)
    # Residence via Little's law on the fluid state for windows that see
    # arrivals. Idle windows (lambda = 0 burst gaps) have no arriving
    # requests to attribute waits to — Little's ratio degenerates (0/0 is
    # the NaN the onset guard exists for, and a residual backlog collapsing
    # mid-window inflates it) — so they report the *virtual* waiting time
    # instead: residual backlog over capacity, plus service.
    w1 = np.where(
        dead1,
        np.where((off1 > tiny) | (q1_mean > tiny), np.inf, 0.0),
        np.where(
            lam_eff > tiny,
            q1_mean / np.maximum(g1_mean, tiny),
            q1_mean / (float(k) * safe_mu1) + 1.0 / safe_mu1))
    w2 = np.where(
        dead2,
        np.where((off2 > tiny) | (q2_mean > tiny), np.inf, 0.0),
        np.where(
            lam2 > tiny,
            q2_mean / np.maximum(g2_mean, tiny),
            q2_mean / safe_mu2 + 1.0 / safe_mu2))
    response = expected_response(w1, w2, fi.p12_fill)
    # Stability keeps the piecewise onset semantics: a window saturates when
    # its *offered* rates reach capacity (the fluid drain itself never
    # exceeds capacity, so served rates cannot flag it). The `<= 0` escape
    # keeps idle-but-dead windows stable (nothing offered, nothing lost) —
    # for mu > 0 it is implied by `rate < capacity` and changes nothing.
    stable = (((lam_eff < k * mu1_w) | (lam_eff <= 0.0))
              & ((lam2 < mu2_w) | (lam2 <= 0.0)))
    metastable = None
    if has_retry:
        # Metastable: the external rates alone are within capacity, but the
        # total offered stream (external + retry re-offers) is not — the
        # retry feedback sustains an overload the workload itself would
        # recover from.
        stable_tot = (((tot1 < k * mu1_w) | (tot1 <= 0.0))
                      & ((tot2 < mu2_w) | (tot2 <= 0.0)))
        metastable = stable & ~stable_tot
    return FluidReport(
        lam=fi.lam,
        p12=fi.p12,
        lam_eff=lam_eff,
        rho1=rho1,
        rho2=rho2,
        w1=w1,
        w2=w2,
        response=response,
        stable=stable,
        q1=q1_mean,
        q2=q2_mean,
        retry_rate=retry_mean,
        orbit=orbit_mean,
        dropped=drop_mean,
        metastable=metastable,
        q1_end=np.array(l1),
        q2_end=np.array(l2),
    )


def fluid_two_tier(
    lam,
    p12,
    mu1,
    mu2,
    *,
    dt,
    k: int = 1,
    var_s1: float = 0.0,
    flow: str = "paper",
    q0=None,
    n_substeps: int = 8,
    retry: Optional[RetryPolicy] = None,
    tier1_spill: bool = False,
    k_scale=None,
    mu_load=None,
) -> FluidReport:
    """Fluid-flow transient solve of the two-tier network over time windows
    **with queue-length carryover**.

    Both queues follow the pointwise-stationary fluid ODE
    ``dQ/dt = lam(t) - G(Q)`` where the drain ``G`` inverts the stationary
    queue-length map (PSFFA): tier 2 (M/M/1) uses the analytic
    ``G(Q) = mu2*Q/(1+Q)``, tier 1 (M/M/k / M/G/k) inverts its map by
    vectorized bisection. The pure-fluid limit of ``G`` is
    ``mu*min(Q, k)``; the stationary inverse additionally reproduces the
    stochastic queueing delay, so under a constant arrival rate the fixed
    point ``G(Q*) = lam`` lands *exactly* on the piecewise-stationary
    (equilibrium) solution — the piecewise mode is this solver's
    stationary-limit oracle. Integration is implicit Euler
    (unconditionally stable, exact at fixed points), ``n_substeps`` per
    window.

    ``lam``/``p12`` carry the window axis last, ``mu1``/``mu2`` broadcast
    against them (e.g. ``[shard, 1]``), and the solve is vectorized over
    all leading axes — only the window axis is sequential (carryover).
    ``dt`` is the wall-clock window duration in seconds (scalar or
    broadcastable to the leading axes). ``q0`` sets the initial queue
    lengths: ``None`` warm-starts at the first window's stationary
    solution (an equilibrium start — constant-rate workloads then match
    the piecewise oracle in *every* window), a scalar or ``(q1_0, q2_0)``
    pair starts cold at explicit backlogs (0 = empty system).

    Fault-injection extensions (each exactly inert at its default):

    - ``mu1``/``mu2`` may carry the window axis (time-varying service
      rates, e.g. a fault schedule's per-window μ-multipliers); μ = 0
      during an outage window is a *dead* device — the backlog grows at
      the offered rate, residence is inf, and the window flags unstable.
    - ``k_scale``: optional per-window multiplier on tier-1 *capacity*
      (the fluid representation of a time-varying server count ``k(t)``:
      capacity is ``k · μ1(t) · k_scale(t)``, folded into μ1).
    - ``retry``: a :class:`RetryPolicy`. The ODE becomes
      ``dQ/dt = λ(t) + λ_retry(Q, t) − G(Q; μ(t))``: work whose virtual
      wait exceeds the timeout re-enters the arrival stream from backoff
      orbits (one per retry attempt), while the abandoned copy stays in
      the queue — wasted work. The report then carries ``retry_rate`` /
      ``orbit`` / ``dropped`` series plus the ``metastable`` flag
      (external rates below capacity, total offered above — a retry
      storm that cannot drain) and :meth:`FluidReport.metastable_onset`.
    - ``tier1_spill``: route tier-1 offered work above capacity
      (``max(a1 − k·μ1(t), 0)``, exactly 0 for a healthy tier) into the
      tier-2 arrival stream — degraded tier 1 sheds reads to tier 2.
    - ``mu_load``: load-dependent service rates μ(Q) — ``((a1, b1),
      (a2, b2))`` coefficients of the rational factor
      ``f(Q) = (1 + a·Q)/(1 + b·Q)`` applied to each tier's μ at the
      substep's own queue state (the queue-depth sensitivity the device
      models measure; ``b > a`` = slows under backlog). ``None`` (default)
      keeps the solver bit-identical to the historic path.
    """
    ml = _norm_mu_load(mu_load)
    fi = _fluid_inputs(lam, p12, mu1, mu2, dt=dt, k=k, var_s1=var_s1,
                       flow=flow, q0=q0, n_substeps=n_substeps,
                       k_scale=k_scale)
    lam, p12 = fi.lam, fi.p12
    lam_eff, lam2 = fi.lam_eff, fi.lam2
    mu1_w, mu2_w = fi.mu1_w, fi.mu2_w
    p12_fill, h, l1, l2 = fi.p12_fill, fi.h, fi.l1, fi.l2
    full, lead, n_windows = fi.full, fi.lead, fi.n_windows
    analytic1 = fi.analytic1

    q1_mean = np.empty(full)
    q2_mean = np.empty(full)
    g1_mean = np.empty(full)
    g2_mean = np.empty(full)
    faulted = retry is not None or tier1_spill or ml is not None
    if not faulted:
        # The historic (pre-fault) loop, kept verbatim: the fault-aware
        # loop below is exactly equivalent at spill = retry = 0, but this
        # path guarantees healthy solves stay bit-identical op-for-op.
        for w in range(n_windows):
            a1, a2 = lam_eff[..., w], lam2[..., w]
            l1_sum = 0.5 * l1
            l2_sum = 0.5 * l2
            x1_sum = np.zeros(lead)
            x2_sum = np.zeros(lead)
            for s in range(n_substeps):
                if analytic1:
                    l1, x1 = _implicit_mm1_step(l1, a1, mu1_w[..., w], h)
                else:
                    l1, x1 = _implicit_l1_step(
                        l1, a1, mu1_w[..., w], k, var_s1, h,
                        float(k) * mu1_w[..., w] * (1.0 - 1e-12))
                l2, x2 = _implicit_mm1_step(l2, a2, mu2_w[..., w], h)
                weight = 0.5 if s == n_substeps - 1 else 1.0
                l1_sum += weight * l1
                l2_sum += weight * l2
                x1_sum += x1
                x2_sum += x2
            q1_mean[..., w] = l1_sum / n_substeps
            q2_mean[..., w] = l2_sum / n_substeps
            g1_mean[..., w] = x1_sum / n_substeps
            g2_mean[..., w] = x2_sum / n_substeps
        off1, off2 = lam_eff, lam2
        retry_mean = orbit_mean = drop_mean = None
        tot1 = tot2 = None
    else:
        # Fault-aware loop: arrival flows are re-composed every substep so
        # retry feedback (orbit re-offers join the external stream) and
        # tier-1 overflow spill can respond to the evolving queue state.
        m = retry.max_retries if retry is not None else 0
        delays = retry.delays() if retry is not None else np.empty(0)
        orbits = [np.zeros(lead) for _ in range(m)]
        off1 = np.empty(full)   # post-spill offered rate at tier 1
        off2 = np.empty(full)   # post-spill offered rate at tier 2
        tot1 = np.empty(full)   # pre-spill offered (external + retries)
        tot2 = np.empty(full)
        retry_mean = np.empty(full) if retry is not None else None
        orbit_mean = np.empty(full) if retry is not None else None
        drop_mean = np.empty(full) if retry is not None else None
        for w in range(n_windows):
            lam_w = lam[..., w]
            p12_w = p12_fill[..., w]
            mu1_ww = mu1_w[..., w]
            mu2_ww = mu2_w[..., w]
            cap_w = float(k) * mu1_ww
            l1_sum = 0.5 * l1
            l2_sum = 0.5 * l2
            x1_sum = np.zeros(lead)
            x2_sum = np.zeros(lead)
            a1_sum = np.zeros(lead)
            a2_sum = np.zeros(lead)
            o1_sum = np.zeros(lead)
            o2_sum = np.zeros(lead)
            r_sum = np.zeros(lead)
            orb_sum = np.zeros(lead)
            d_sum = np.zeros(lead)
            for s in range(n_substeps):
                # Load-dependent service rates: μ evaluated at the substep's
                # own queue state (semi-implicit — μ is frozen over the
                # substep). ml = None reuses the nominal per-window arrays,
                # keeping every expression below op-identical.
                if ml is not None:
                    (a1c, b1c), (a2c, b2c) = ml
                    mu1_s = mu1_ww * (1.0 + a1c * l1) / (1.0 + b1c * l1)
                    mu2_s = mu2_ww * (1.0 + a2c * l2) / (1.0 + b2c * l2)
                    cap_s = float(k) * mu1_s
                else:
                    mu1_s, mu2_s, cap_s = mu1_ww, mu2_ww, cap_w
                # Re-offered rate from the backoff orbits (pre-update).
                reoffer = [orbits[r] / delays[r] for r in range(m)]
                lam_r = sum(reoffer, np.zeros(lead))
                lam_tot = lam_w + lam_r
                # Flow composition at the total arrival rate — identical
                # expression to the nominal lam_eff when lam_r = 0.
                if flow == "paper":
                    a1 = np.where(lam_tot > 0.0,
                                  (1.0 - p12_w) * lam_tot + p12_w * mu2_s,
                                  0.0)
                else:
                    a1 = lam_tot
                a2 = p12_w * lam_tot
                # Tier-1 overflow spills to tier 2 (exactly 0 when the
                # offered rate is within capacity).
                if tier1_spill:
                    spill = np.maximum(a1 - cap_s, 0.0)
                else:
                    spill = np.zeros(lead)
                a1s = a1 - spill
                a2s = a2 + spill
                if retry is not None:
                    # Timeout fraction from the *virtual wait* at tier 1,
                    # w_v = (Q1 + 1)/(k mu1): p_to = clip(1 - T/w_v, 0, 1)
                    # — written multiplication-only so a dead tier
                    # (cap = 0, w_v = inf) lands on p_to = 1 cleanly.
                    p_to = np.clip(
                        1.0 - retry.timeout * cap_s / (l1 + 1.0), 0.0, 1.0)
                if analytic1:
                    l1, x1 = _implicit_mm1_step(l1, a1s, mu1_s, h)
                else:
                    l1, x1 = _implicit_l1_step(
                        l1, a1s, mu1_s, k, var_s1, h,
                        cap_s * (1.0 - 1e-12))
                l2, x2 = _implicit_mm1_step(l2, a2s, mu2_s, h)
                if retry is not None:
                    # Orbit chain: timed-out external work enters orbit 0,
                    # a re-offer that times out again cascades one orbit
                    # down, and the last orbit's timeouts are dropped (the
                    # client's retry budget is spent). The abandoned copy
                    # is NOT removed from the queue — wasted work.
                    inflow = [p_to * lam_w] + [p_to * reoffer[r]
                                               for r in range(m - 1)]
                    dropped_now = (p_to * reoffer[m - 1] if m > 0
                                   else p_to * lam_w)
                    for r in range(m):
                        orbits[r] = ((orbits[r] + h * inflow[r])
                                     / (1.0 + h / delays[r]))
                    r_sum += lam_r
                    orb_sum += sum(orbits, np.zeros(lead))
                    d_sum += dropped_now
                weight = 0.5 if s == n_substeps - 1 else 1.0
                l1_sum += weight * l1
                l2_sum += weight * l2
                x1_sum += x1
                x2_sum += x2
                a1_sum += a1
                a2_sum += a2
                o1_sum += a1s
                o2_sum += a2s
            q1_mean[..., w] = l1_sum / n_substeps
            q2_mean[..., w] = l2_sum / n_substeps
            g1_mean[..., w] = x1_sum / n_substeps
            g2_mean[..., w] = x2_sum / n_substeps
            tot1[..., w] = a1_sum / n_substeps
            tot2[..., w] = a2_sum / n_substeps
            off1[..., w] = o1_sum / n_substeps
            off2[..., w] = o2_sum / n_substeps
            if retry is not None:
                retry_mean[..., w] = r_sum / n_substeps
                orbit_mean[..., w] = orb_sum / n_substeps
                drop_mean[..., w] = d_sum / n_substeps

    return _fluid_report(
        fi, k=k, has_retry=retry is not None,
        q1_mean=q1_mean, q2_mean=q2_mean, g1_mean=g1_mean, g2_mean=g2_mean,
        off1=off1, off2=off2, tot1=tot1, tot2=tot2,
        retry_mean=retry_mean, orbit_mean=orbit_mean, drop_mean=drop_mean,
        l1=l1, l2=l2,
    )
