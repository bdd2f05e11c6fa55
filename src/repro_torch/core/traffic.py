"""IO traffic models (paper §VI-A).

The paper evaluates cache replacement under two traffic models:

- **Poisson**: "the probability of a page request decreases exponentially
  with time since its arrival" — pages have exponentially-decaying temporal
  locality. Chosen so the sequence is *slow evolving* (LRU-friendly, §II).
- **IRM** (Independent Reference Model): pages have fixed popularities drawn
  from a Zipf distribution and fixed lifetimes (maximum request counts).
  A page expires once its requests exceed the maximum and is replaced by a
  fresh page (sharp popularity changes; LFU-friendly).

Also provided: strided streams (exercise the stream-identifier prefetcher,
§III) and Markov-chain streams (§II, [40]) for the Markov prefetcher.

**Non-stationary workloads** (the time axis the equilibrium analysis hides):

- **phase schedules** (``kind="phased"`` / :func:`phase_schedule`) compose
  existing :class:`TrafficSpec` s into sequential phases — read-then-write,
  IRM-then-Poisson, anything the base generators produce — so miss rate and
  per-shard load drift over the stream;
- **on/off burst modulation** (``kind="onoff"`` / :func:`onoff_stream`)
  alternates background Zipf-read traffic with checkpoint-style sequential
  write bursts over a small hot page range (the paper's bursty checkpoint
  evaluation traffic).

**Wall-clock arrival timestamps** (the time axis the request-index view
hides): :func:`make_timed_stream` emits an arrival-time process alongside
every stream — Poisson arrivals (exponential inter-arrival gaps) for the
stationary kinds, MMPP-style modulated rates for ``onoff`` (background
stretches arrive at the base rate, checkpoint bursts at ``burst_rate``
with *deterministic* spacing — a checkpoint writer streams stripes
back-to-back, it does not jitter), and second-composed phases for
``phased`` (each phase's own rate process, offset by the previous phase's
realized end — :func:`phase_schedule` composes in seconds, not request
counts). Timestamps let the windowed pipeline bin outcomes by wall-clock
time, so per-window arrival rates are *measured*, not flat by
construction.

**Multi-tenant chunked workloads** (``kind="tenant_mix"`` /
:func:`tenant_mix`): N tenants with distinct Poisson arrival rates,
disjoint Zipf key spaces and read/write mixes, merged by arrival time.
:class:`TenantStream` generates the merged stream *chunk by chunk* — each
tenant is a deterministic event sequence drawn in fixed-size blocks, so
the merged prefix is bit-identical whatever the chunking and the full mix
never has to materialize at once (the streaming replay path's generator).
``state()``/``restore()`` snapshot the generator for checkpoint/resume.

Generators are host-side (numpy, seeded) — traffic is an *input* to the
jitted storage engine, mirroring the paper where clients generate requests
outside the cache. Each generator returns ``(pages, is_write)`` int32/bool
arrays of length ``n``; :func:`make_timed_stream` adds a float64 ``times``
array (strictly increasing arrival seconds).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "TrafficSpec",
    "TenantSpec",
    "TenantStream",
    "tenant_mix",
    "tenant_mix_stream",
    "poisson_stream",
    "irm_stream",
    "strided_stream",
    "markov_stream",
    "mixed_stream",
    "phased_stream",
    "phase_schedule",
    "onoff_stream",
    "make_stream",
    "arrival_times",
    "onoff_arrival_times",
    "make_timed_stream",
    "nominal_duration",
    "nominal_duration_std",
]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Declarative description of a workload (used by benchmarks/configs).

    Nonsensical configurations raise ``ValueError`` at construction (not as
    NaN reports downstream): ``n_requests``/``n_pages`` must be positive,
    ``write_fraction`` must lie in [0, 1], and the wall-clock rates must be
    non-negative (0 = unset, the caller supplies a default).
    """

    kind: str  # poisson | irm | strided | markov | mixed | phased | onoff
    n_requests: int
    n_pages: int
    write_fraction: float = 0.0
    seed: int = 0
    # poisson
    decay_tau: float = 200.0
    arrival_rate: float = 0.05
    # irm
    zipf_s: float = 1.1
    lifetime: int = 200
    # strided
    stride: int = 1
    n_streams: int = 1
    # markov
    n_hot_states: int = 16
    hot_self_p: float = 0.85
    # phased: sequential composition of other TrafficSpecs (hashable tuple;
    # build via phase_schedule() so n_requests/n_pages stay consistent)
    phases: Optional[tuple] = None
    # onoff: background traffic modulated by checkpoint-style write bursts
    on_len: int = 64      # burst length (requests)
    off_len: int = 192    # background stretch between bursts (requests)
    burst_pages: int = 32  # checkpoint working-set size (hot page range)
    # wall-clock arrival process (make_timed_stream): offered arrival rate
    # in req/s. 0.0 = unset — the caller supplies a default (repro_torch.sim uses
    # lam * n_shards, the aggregate offered rate).
    rate: float = 0.0
    # onoff: arrival rate inside checkpoint bursts (req/s, deterministic
    # back-to-back stripes). 0.0 = BURST_RATE_MULT x the base rate.
    burst_rate: float = 0.0
    # tenant_mix: per-tenant arrival/key-space/write profiles (hashable
    # tuple of TenantSpec; build via tenant_mix() so rate/n_pages stay
    # consistent with the tenant sums).
    tenants: Optional[tuple] = None

    def __post_init__(self):
        if self.kind == "tenant_mix":
            if not self.tenants:
                raise ValueError(
                    "tenant_mix TrafficSpec needs a non-empty tenants "
                    "tuple (build it via tenant_mix())")
            for t in self.tenants:
                if not isinstance(t, TenantSpec):
                    raise ValueError(
                        "TrafficSpec.tenants entries must be TenantSpec, "
                        f"got {type(t).__name__}")
            total_pages = sum(t.n_pages for t in self.tenants)
            if self.n_pages != total_pages:
                raise ValueError(
                    f"tenant_mix n_pages={self.n_pages} must equal the sum "
                    f"of tenant page spaces {total_pages} (tenants own "
                    "disjoint key ranges; build the spec via tenant_mix())")
            total_rate = sum(t.rate for t in self.tenants)
            if not math.isclose(self.rate, total_rate, rel_tol=1e-9):
                raise ValueError(
                    f"tenant_mix rate={self.rate} must equal the sum of "
                    f"tenant rates {total_rate} (build the spec via "
                    "tenant_mix())")
        elif self.tenants is not None:
            raise ValueError(
                "TrafficSpec.tenants is only meaningful for "
                f"kind='tenant_mix', got kind={self.kind!r}")
        if self.n_requests <= 0:
            raise ValueError(
                f"TrafficSpec.n_requests must be positive, got "
                f"{self.n_requests}")
        if self.n_pages <= 0:
            raise ValueError(
                f"TrafficSpec.n_pages must be positive, got {self.n_pages}")
        if not 0.0 <= self.write_fraction <= 1.0:
            raise ValueError(
                f"TrafficSpec.write_fraction must be in [0, 1], got "
                f"{self.write_fraction}")
        if self.rate < 0.0:
            raise ValueError(
                f"TrafficSpec.rate must be non-negative (0 = unset), got "
                f"{self.rate}")
        if self.burst_rate < 0.0:
            raise ValueError(
                f"TrafficSpec.burst_rate must be non-negative (0 = unset), "
                f"got {self.burst_rate}")


def _writes(rng: np.random.Generator, n: int, frac: float) -> np.ndarray:
    if frac <= 0.0:
        return np.zeros(n, dtype=bool)
    return rng.random(n) < frac


def poisson_stream(
    n: int,
    n_pages: int,
    *,
    decay_tau: float = 200.0,
    arrival_rate: float = 0.05,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Poisson traffic model: exponential temporal decay since page arrival.

    Pages "arrive" (become active) according to a Poisson process with rate
    ``arrival_rate`` per step; at each step a request is drawn with
    probability proportional to ``exp(-(t - arrival_t[p]) / decay_tau)`` over
    active pages. ``decay_tau`` large => slow-evolving (paper's choice).
    """
    rng = np.random.default_rng(seed)
    arrival_t = np.full(n_pages, np.inf)
    # Seed a small active set so the stream is well-defined from step 0.
    n_seed = max(1, n_pages // 16)
    arrival_t[:n_seed] = 0.0
    next_page = n_seed
    pages = np.empty(n, dtype=np.int32)
    for t in range(n):
        # New page arrivals.
        k = rng.poisson(arrival_rate)
        for _ in range(k):
            if next_page < n_pages:
                arrival_t[next_page] = t
                next_page += 1
        active = np.isfinite(arrival_t)
        w = np.exp(-(t - arrival_t[active]) / decay_tau)
        w_sum = w.sum()
        if w_sum <= 0:
            w = np.ones_like(w)
            w_sum = w.sum()
        idx = rng.choice(np.nonzero(active)[0], p=w / w_sum)
        pages[t] = idx
    return pages, _writes(rng, n, write_fraction)


def irm_stream(
    n: int,
    n_pages: int,
    *,
    zipf_s: float = 1.1,
    lifetime: int = 200,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """IRM traffic: Zipf popularity + fixed lifetimes (max requests).

    ``n_pages`` concurrent popularity *slots*; when a slot's page exceeds its
    lifetime it expires and a brand-new page id takes over the slot (sharp
    change in the active set, preserving the popularity distribution).
    Page ids grow beyond ``n_pages`` as pages expire — callers should treat
    the page id space as unbounded (the cache engine hashes tags, not ranks).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    pop = ranks ** (-zipf_s)
    pop /= pop.sum()
    slot_page = np.arange(n_pages, dtype=np.int64)  # page id per slot
    slot_count = np.zeros(n_pages, dtype=np.int64)
    slot_life = rng.poisson(lifetime, size=n_pages).clip(min=1)
    next_id = n_pages
    pages = np.empty(n, dtype=np.int32)
    slots = rng.choice(n_pages, size=n, p=pop)
    for t, s in enumerate(slots):
        pages[t] = slot_page[s]
        slot_count[s] += 1
        if slot_count[s] >= slot_life[s]:  # page expired -> fresh page
            slot_page[s] = next_id
            next_id += 1
            slot_count[s] = 0
            slot_life[s] = max(1, int(rng.poisson(lifetime)))
    return pages, _writes(rng, n, write_fraction)


def strided_stream(
    n: int,
    n_pages: int,
    *,
    stride: int = 1,
    n_streams: int = 1,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved constant-stride streams (prefetcher-friendly)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, n_pages, size=n_streams)
    pages = np.empty(n, dtype=np.int32)
    for t in range(n):
        s = t % n_streams
        step = t // n_streams
        pages[t] = (starts[s] + step * stride) % n_pages
    return pages, _writes(rng, n, write_fraction)


def markov_stream(
    n: int,
    n_pages: int,
    *,
    n_hot_states: int = 16,
    hot_self_p: float = 0.85,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """First-order Markov page stream: a hot ring with occasional jumps.

    From hot page ``h`` the next request is ``h+1`` in the hot ring with
    probability ``hot_self_p``, otherwise a uniform random page. Exercises
    the Markov prefetcher (non-strided but predictable transitions).
    """
    rng = np.random.default_rng(seed)
    hot = rng.choice(n_pages, size=min(n_hot_states, n_pages), replace=False)
    pages = np.empty(n, dtype=np.int32)
    pos = 0
    for t in range(n):
        if rng.random() < hot_self_p:
            pages[t] = hot[pos]
            pos = (pos + 1) % len(hot)
        else:
            pages[t] = rng.integers(0, n_pages)
    return pages, _writes(rng, n, write_fraction)


def mixed_stream(
    n: int,
    n_pages: int,
    *,
    switch_every: int = 1000,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Alternate Poisson and IRM phases — the paper's motivation for OL:
    "a mix of cache replacement algorithms will perform better for complex
    IO traffic" (§I). Phase switches force the OL policy to re-learn.
    """
    rng = np.random.default_rng(seed)
    pages = np.empty(n, dtype=np.int32)
    t = 0
    phase = 0
    while t < n:
        m = min(switch_every, n - t)
        gen = poisson_stream if phase == 0 else irm_stream
        p, _ = gen(m, n_pages, seed=int(rng.integers(2**31)))
        pages[t : t + m] = p
        t += m
        phase ^= 1
    return pages, _writes(rng, n, write_fraction)


def phased_stream(
    phases: Sequence[TrafficSpec],
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate the streams of sequential phases (shared page space).

    Each phase is generated by its own :class:`TrafficSpec` (own kind, seed,
    write fraction, length); the phases run back to back, so the composed
    stream's locality, write mix and page footprint shift at phase
    boundaries — exactly the non-stationarity a windowed report resolves.
    """
    if not phases:
        raise ValueError("phased traffic needs at least one phase")
    parts = [make_stream(p) for p in phases]
    pages = np.concatenate([p for p, _ in parts]).astype(np.int32)
    writes = np.concatenate([w for _, w in parts]).astype(bool)
    return pages, writes


def phase_schedule(*phases: TrafficSpec, seed: int = 0) -> TrafficSpec:
    """Compose :class:`TrafficSpec` phases into one ``kind="phased"`` spec.

    The schedule's ``n_requests`` is the sum over phases and its ``n_pages``
    the max (the §III mapping partitions the widest declared page space).

    The composed schedule runs in **seconds**, not request counts: when
    every phase declares an arrival ``rate``, the schedule's ``rate`` is
    the mean over the composed wall-clock span (total requests / total
    duration), and :func:`make_timed_stream` emits each phase's arrivals at
    that phase's own rate, offset by the previous phase's end — a
    high-rate phase occupies a proportionally *short* stretch of the
    timeline (a true rate burst), instead of one fixed window per equal
    request count.
    """
    if not phases:
        raise ValueError("phase_schedule needs at least one phase")
    rate = 0.0
    if all(p.rate > 0 for p in phases):
        total_n = sum(p.n_requests for p in phases)
        rate = total_n / sum(p.n_requests / p.rate for p in phases)
    return TrafficSpec(
        kind="phased",
        n_requests=sum(p.n_requests for p in phases),
        n_pages=max(p.n_pages for p in phases),
        seed=seed,
        phases=tuple(phases),
        rate=rate,
    )


def onoff_stream(
    n: int,
    n_pages: int,
    *,
    on_len: int = 64,
    off_len: int = 192,
    burst_pages: int = 32,
    zipf_s: float = 1.1,
    write_fraction: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """On/off burst modulation: Zipf-read background with periodic
    checkpoint-style write bursts.

    OFF stretches (``off_len`` requests) draw Zipf-popular pages over the
    full page space with the base ``write_fraction``; ON bursts (``on_len``
    requests) issue sequential *writes* over a small hot checkpoint range
    (``burst_pages`` pages, resuming where the previous burst stopped).
    Bursts shift both the miss fraction and the write mix window to window —
    the paper's bursty checkpoint traffic.
    """
    if on_len < 0 or off_len < 0 or on_len + off_len == 0:
        raise ValueError("need on_len + off_len > 0 (both non-negative)")
    rng = np.random.default_rng(seed)
    burst_span = max(1, min(burst_pages, n_pages))
    ranks = np.arange(1, n_pages + 1, dtype=np.float64)
    pop = ranks ** (-zipf_s)
    pop /= pop.sum()
    pages = np.empty(n, dtype=np.int32)
    writes = np.zeros(n, dtype=bool)
    t = 0
    ckpt = 0
    while t < n:
        m = min(off_len, n - t)
        if m:
            pages[t : t + m] = rng.choice(n_pages, size=m, p=pop)
            writes[t : t + m] = rng.random(m) < write_fraction
            t += m
        m = min(on_len, n - t)
        if m:
            pages[t : t + m] = (ckpt + np.arange(m)) % burst_span
            writes[t : t + m] = True
            ckpt = (ckpt + m) % burst_span
            t += m
    return pages, writes


def make_stream(spec: TrafficSpec) -> tuple[np.ndarray, np.ndarray]:
    """Build a stream from a :class:`TrafficSpec`."""
    common = dict(
        write_fraction=spec.write_fraction,
        seed=spec.seed,
    )
    if spec.kind == "poisson":
        return poisson_stream(
            spec.n_requests,
            spec.n_pages,
            decay_tau=spec.decay_tau,
            arrival_rate=spec.arrival_rate,
            **common,
        )
    if spec.kind == "irm":
        return irm_stream(
            spec.n_requests,
            spec.n_pages,
            zipf_s=spec.zipf_s,
            lifetime=spec.lifetime,
            **common,
        )
    if spec.kind == "strided":
        return strided_stream(
            spec.n_requests,
            spec.n_pages,
            stride=spec.stride,
            n_streams=spec.n_streams,
            **common,
        )
    if spec.kind == "markov":
        return markov_stream(
            spec.n_requests,
            spec.n_pages,
            n_hot_states=spec.n_hot_states,
            hot_self_p=spec.hot_self_p,
            **common,
        )
    if spec.kind == "mixed":
        return mixed_stream(spec.n_requests, spec.n_pages, **common)
    if spec.kind == "phased":
        _validate_phased(spec)
        return phased_stream(spec.phases)
    if spec.kind == "onoff":
        return onoff_stream(
            spec.n_requests,
            spec.n_pages,
            on_len=spec.on_len,
            off_len=spec.off_len,
            burst_pages=spec.burst_pages,
            zipf_s=spec.zipf_s,
            **common,
        )
    if spec.kind == "tenant_mix":
        pages, writes, _, _ = tenant_mix_stream(spec)
        return pages, writes
    raise ValueError(f"unknown traffic kind: {spec.kind!r}")


def _validate_phased(spec: TrafficSpec) -> None:
    """The phased-spec invariants shared by the timed and untimed
    generators: a non-empty phase tuple whose lengths sum to the composed
    ``n_requests`` (both guaranteed by :func:`phase_schedule`)."""
    if not spec.phases:
        raise ValueError("phased TrafficSpec needs a non-empty phases "
                         "tuple (see phase_schedule())")
    total = sum(p.n_requests for p in spec.phases)
    if total != spec.n_requests:
        raise ValueError(
            f"phased n_requests={spec.n_requests} != sum of phase "
            f"lengths {total} (build the spec via phase_schedule())"
        )


# ---------------------------------------------------------------------------
# Wall-clock arrival-time processes.
# ---------------------------------------------------------------------------

# Default ON-burst rate multiplier when TrafficSpec.burst_rate is unset: a
# checkpoint writer streams stripes much faster than the offered background
# rate (the paper's bursty checkpoint traffic).
BURST_RATE_MULT = 4.0

# Seed stream for arrival times, decorrelated from the page-generator seed
# so timestamps never perturb the request sequence itself.
_TIME_SEED = 0x7157


def arrival_times(
    n: int,
    rate: float,
    *,
    seed: int = 0,
    gap_rates: Optional[np.ndarray] = None,
    deterministic: Optional[np.ndarray] = None,
    t0: float = 0.0,
) -> np.ndarray:
    """Arrival timestamps (seconds, strictly increasing) for ``n`` requests.

    The base process is Poisson at ``rate`` (i.i.d. exponential inter-arrival
    gaps). ``gap_rates`` (float[n]) modulates the rate per gap — request i
    arrives ``Exp(1/gap_rates[i])`` after request i-1, the conditional form
    of an MMPP whose modulating state is indexed by request position.
    ``deterministic`` (bool[n]) marks gaps with *no* jitter (exactly
    ``1/gap_rates[i]`` — checkpoint bursts stream back-to-back). ``t0``
    offsets the whole process (phase composition in seconds).
    """
    if rate <= 0.0 and gap_rates is None:
        raise ValueError("arrival rate must be positive")
    rng = np.random.default_rng([seed, _TIME_SEED])
    rates = (np.full(n, float(rate)) if gap_rates is None
             else np.asarray(gap_rates, float))
    if rates.shape != (n,):
        raise ValueError(f"gap_rates must have shape ({n},)")
    if np.any(rates <= 0.0):
        raise ValueError("all gap rates must be positive")
    gaps = rng.exponential(1.0, size=n) / rates
    if deterministic is not None:
        det = np.asarray(deterministic, bool)
        gaps = np.where(det, 1.0 / rates, gaps)
    return t0 + np.cumsum(gaps)


def onoff_arrival_times(
    n: int,
    rate: float,
    *,
    on_len: int,
    off_len: int,
    burst_rate: float = 0.0,
    seed: int = 0,
    t0: float = 0.0,
) -> np.ndarray:
    """MMPP-style arrivals for the ``onoff`` kind: OFF stretches are Poisson
    at the base ``rate``, ON bursts arrive *deterministically* at
    ``burst_rate`` (default :data:`BURST_RATE_MULT` x base — checkpoint
    stripes stream back-to-back, they do not jitter). The ON/OFF regime of
    position ``i`` mirrors :func:`onoff_stream`'s layout exactly
    (``off_len`` background requests, then ``on_len`` burst requests,
    repeating)."""
    if burst_rate <= 0.0:
        burst_rate = BURST_RATE_MULT * rate
    period = on_len + off_len
    if period <= 0:
        raise ValueError("need on_len + off_len > 0")
    pos = np.arange(n) % period
    on = pos >= off_len  # onoff_stream emits the OFF stretch first
    return arrival_times(
        n, rate, seed=seed, t0=t0,
        gap_rates=np.where(on, burst_rate, rate),
        deterministic=on,
    )


def nominal_duration(spec: TrafficSpec, default_rate: float = 0.0) -> float:
    """Expected wall-clock span of a spec's arrival process (seconds):
    ``n_requests / rate``, phases summed over their own rates, and the
    ``onoff`` MMPP accounting for its burst stretches arriving at
    ``burst_rate``. Deterministic from the spec (no sampling), so callers
    can derive a fixed window grid that does not recompile across seeds."""
    if spec.kind == "phased" and spec.phases:
        return sum(nominal_duration(p, default_rate) for p in spec.phases)
    rate = spec.rate if spec.rate > 0 else default_rate
    if rate <= 0:
        raise ValueError(
            "traffic spec has no arrival rate; set TrafficSpec.rate or pass "
            "a default_rate"
        )
    if spec.kind == "onoff":
        burst = spec.burst_rate if spec.burst_rate > 0 else (
            BURST_RATE_MULT * rate)
        n_on, n_off = _onoff_split(spec)
        return n_off / rate + n_on / burst
    return spec.n_requests / rate


def _onoff_split(spec: TrafficSpec) -> tuple[int, int]:
    """(n_on, n_off) request counts of an onoff spec's deterministic
    regime layout."""
    period = spec.on_len + spec.off_len
    full, rem = divmod(spec.n_requests, period)
    n_on = full * spec.on_len + max(0, rem - spec.off_len)
    return n_on, spec.n_requests - n_on


def nominal_duration_std(spec: TrafficSpec,
                         default_rate: float = 0.0) -> float:
    """Standard deviation of the realized wall-clock span around
    :func:`nominal_duration`: exponential gaps contribute ``1/rate**2``
    variance each (the span of ``n`` Poisson arrivals is Gamma(n, 1/rate)),
    deterministic checkpoint-burst gaps contribute none, phases add in
    quadrature. Lets callers pad a derived window grid so the sampled
    process almost never overflows it."""
    if spec.kind == "phased" and spec.phases:
        return math.sqrt(sum(
            nominal_duration_std(p, default_rate) ** 2 for p in spec.phases))
    rate = spec.rate if spec.rate > 0 else default_rate
    if rate <= 0:
        raise ValueError(
            "traffic spec has no arrival rate; set TrafficSpec.rate or pass "
            "a default_rate"
        )
    if spec.kind == "onoff":
        _, n_off = _onoff_split(spec)
        return math.sqrt(n_off) / rate
    return math.sqrt(spec.n_requests) / rate


def make_timed_stream(
    spec: TrafficSpec, *, default_rate: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build ``(pages, is_write, times)`` from a :class:`TrafficSpec`.

    ``pages``/``is_write`` are bit-identical to :func:`make_stream` (the
    timestamp process draws from its own decorrelated seed stream); ``times``
    is the wall-clock arrival process in seconds:

    - stationary kinds (``poisson``/``irm``/``strided``/``markov``/
      ``mixed``): homogeneous Poisson at the spec's ``rate``;
    - ``onoff``: MMPP-style modulation (:func:`onoff_arrival_times`);
    - ``phased``: each phase's own process, offset by the previous phase's
      realized end — the schedule composes in *seconds*, so a fast phase
      compresses its requests into a short wall-clock span and the measured
      per-window arrival rate genuinely bursts.

    ``default_rate`` fills in for specs whose ``rate`` is unset (0.0).
    """
    rate = spec.rate if spec.rate > 0 else default_rate
    if spec.kind == "tenant_mix":
        # The tenant merge *is* an arrival-time process (each tenant its
        # own Poisson stream); the timed view just keeps the merge times.
        pages, writes, times, _ = tenant_mix_stream(spec)
        return pages, writes, times
    if spec.kind == "phased":
        _validate_phased(spec)
        parts, t0 = [], 0.0
        for p in spec.phases:
            pg, wr, ts = make_timed_stream(p, default_rate=rate)
            parts.append((pg, wr, ts + t0))
            if ts.size:
                t0 += float(ts[-1])
        pages = np.concatenate([pg for pg, _, _ in parts]).astype(np.int32)
        writes = np.concatenate([wr for _, wr, _ in parts]).astype(bool)
        times = np.concatenate([ts for _, _, ts in parts])
        return pages, writes, times
    pages, writes = make_stream(spec)
    n = pages.shape[0]
    if spec.kind == "onoff":
        times = onoff_arrival_times(
            n, rate, on_len=spec.on_len, off_len=spec.off_len,
            burst_rate=spec.burst_rate, seed=spec.seed,
        )
    else:
        times = arrival_times(n, rate, seed=spec.seed)
    return pages, writes, times


# ---------------------------------------------------------------------------
# Multi-tenant chunked traffic (kind="tenant_mix").
# ---------------------------------------------------------------------------

# Seed tag decorrelating tenant draws from the page/time seed streams above.
_TENANT_SEED = 0x7E4A

# Per-tenant generation block (events per refill). A structural constant of
# the stream: every tenant always draws whole blocks in a fixed order
# (gaps, pages, writes), so the event sequence is a pure function of the
# tenant's seed — never of how consumers chunk their reads.
TENANT_BLOCK = 4096


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of a ``tenant_mix`` workload: an independent Poisson
    arrival process at ``rate`` req/s over the tenant's own *disjoint*
    Zipf(``zipf_s``)-popular key space of ``n_pages`` pages, with a
    ``write_fraction`` share of writes. Tenants are merged by arrival time
    (:class:`TenantStream`); page ids are offset so key ranges never
    collide across tenants."""

    name: str
    rate: float
    n_pages: int
    zipf_s: float = 1.1
    write_fraction: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not self.name:
            raise ValueError("TenantSpec.name must be non-empty")
        if self.rate <= 0.0:
            raise ValueError(
                f"TenantSpec.rate must be positive, got {self.rate}")
        if self.n_pages <= 0:
            raise ValueError(
                f"TenantSpec.n_pages must be positive, got {self.n_pages}")
        if not 0.0 <= self.write_fraction <= 1.0:
            raise ValueError(
                f"TenantSpec.write_fraction must be in [0, 1], got "
                f"{self.write_fraction}")


def tenant_mix(*tenants: TenantSpec, n_requests: int,
               seed: int = 0) -> TrafficSpec:
    """Compose tenants into one ``kind="tenant_mix"`` :class:`TrafficSpec`.

    The mix's ``rate`` is the sum of tenant rates (the superposition of
    independent Poisson processes is Poisson at the summed rate, so the
    generic duration formulas hold) and its ``n_pages`` the sum of tenant
    page spaces (disjoint key ranges, offset in declaration order)."""
    if not tenants:
        raise ValueError("tenant_mix needs at least one TenantSpec")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"tenant names must be unique, got {names}")
    return TrafficSpec(
        kind="tenant_mix",
        n_requests=n_requests,
        n_pages=sum(t.n_pages for t in tenants),
        seed=seed,
        rate=sum(t.rate for t in tenants),
        tenants=tuple(tenants),
    )


@dataclasses.dataclass
class _TenantState:
    """Mutable per-tenant generator state inside a :class:`TenantStream`."""

    spec: TenantSpec
    rng: np.random.Generator
    cum: np.ndarray        # Zipf popularity CDF over the tenant's pages
    offset: int            # first page id of the tenant's key range
    t_last: float          # last *generated* arrival time
    buf_t: np.ndarray      # buffered (generated, unconsumed) arrival times
    buf_p: np.ndarray      # ... page ids (already offset)
    buf_w: np.ndarray      # ... write flags


class TenantStream:
    """Chunk-by-chunk generator of a ``tenant_mix`` stream.

    Each tenant is a *deterministic* event sequence: its own seeded
    generator, drawn in fixed :data:`TENANT_BLOCK`-event blocks with a
    fixed draw order (inter-arrival gaps, then pages, then write flags) —
    the sequence depends only on the tenant's seed, never on how many
    events a consumer asked for. The mix is the k-way merge of those
    sequences by arrival time (ties broken by tenant index), so any
    ``take()`` chunking emits the *bit-identical* merged prefix: chunked
    streaming replay equals one-shot replay by construction, and
    ``make_stream`` / ``make_timed_stream`` on the same spec are simply
    the full drain.

    ``take(m)`` returns up to ``m`` merged events as
    ``(pages, is_write, times, tenant_ids)`` (capped by the spec's
    ``n_requests``; empty arrays once exhausted). ``state()`` /
    ``restore()`` snapshot and restore the generator mid-stream for
    checkpoint/resume (bit-exact continuation)."""

    def __init__(self, spec: TrafficSpec):
        if spec.kind != "tenant_mix":
            raise ValueError(
                f"TenantStream needs kind='tenant_mix', got {spec.kind!r}")
        self.spec = spec
        self.total = spec.n_requests
        self.emitted = 0
        self._tenants = []
        offset = 0
        for i, t in enumerate(spec.tenants):
            ranks = np.arange(1, t.n_pages + 1, dtype=np.float64)
            pop = ranks ** (-t.zipf_s)
            self._tenants.append(_TenantState(
                spec=t,
                rng=np.random.default_rng(
                    [spec.seed, i, t.seed, _TENANT_SEED]),
                cum=np.cumsum(pop / pop.sum()),
                offset=offset,
                t_last=0.0,
                buf_t=np.zeros(0, np.float64),
                buf_p=np.zeros(0, np.int32),
                buf_w=np.zeros(0, bool),
            ))
            offset += t.n_pages

    @property
    def n_tenants(self) -> int:
        return len(self._tenants)

    @property
    def remaining(self) -> int:
        return self.total - self.emitted

    def _refill(self, st: _TenantState) -> None:
        """Generate one more block of events for one tenant (fixed draw
        order — the invariant behind chunk-size invariance)."""
        b = TENANT_BLOCK
        # Inverse-CDF exponential gaps (not rng.exponential: an explicit
        # uniform draw keeps the consumed bit-stream count per block
        # obvious and fixed).
        gaps = -np.log1p(-st.rng.random(b)) / st.spec.rate
        times = st.t_last + np.cumsum(gaps)
        st.t_last = float(times[-1])
        pages = st.offset + np.searchsorted(
            st.cum, st.rng.random(b), side="right")
        writes = st.rng.random(b) < st.spec.write_fraction
        st.buf_t = np.concatenate([st.buf_t, times])
        st.buf_p = np.concatenate([st.buf_p, pages.astype(np.int32)])
        st.buf_w = np.concatenate([st.buf_w, writes])

    def take(self, m: int):
        """The next ``min(m, remaining)`` merged events:
        ``(pages, is_write, times, tenant_ids)``."""
        m = min(int(m), self.remaining)
        if m <= 0:
            return (np.zeros(0, np.int32), np.zeros(0, bool),
                    np.zeros(0, np.float64), np.zeros(0, np.int32))
        # Only events at or before the *frontier* — the minimum over
        # tenants of the last generated time — are final in the merge (a
        # tenant's future events all arrive after its t_last). Refill the
        # laggard tenant until the frontier covers m events.
        while True:
            frontier = min(st.t_last for st in self._tenants)
            avail = sum(
                int(np.searchsorted(st.buf_t, frontier, side="right"))
                for st in self._tenants)
            if avail >= m:
                break
            self._refill(min(self._tenants, key=lambda s: s.t_last))
        parts = []
        for i, st in enumerate(self._tenants):
            k = int(np.searchsorted(st.buf_t, frontier, side="right"))
            parts.append((st.buf_t[:k], st.buf_p[:k], st.buf_w[:k],
                          np.full(k, i, np.int32)))
        times = np.concatenate([p[0] for p in parts])
        pages = np.concatenate([p[1] for p in parts])
        writes = np.concatenate([p[2] for p in parts])
        tids = np.concatenate([p[3] for p in parts])
        # Stable merge order: time, then tenant index (a deterministic
        # tie-break keeps the sequence well-defined even on equal times).
        order = np.lexsort((tids, times))[:m]
        # The taken events are a time-prefix of the merge, hence a prefix
        # of each tenant's buffer — consume by per-tenant count.
        taken = np.bincount(tids[order], minlength=self.n_tenants)
        for st, k in zip(self._tenants, taken):
            st.buf_t = st.buf_t[k:]
            st.buf_p = st.buf_p[k:]
            st.buf_w = st.buf_w[k:]
        self.emitted += m
        return pages[order], writes[order], times[order], tids[order]

    def state(self) -> dict:
        """Snapshot for bit-exact resume (host data only: generator
        states, per-tenant time cursors and unconsumed buffers)."""
        return dict(
            emitted=self.emitted,
            tenants=[dict(
                rng=st.rng.bit_generator.state,
                t_last=st.t_last,
                buf_t=st.buf_t.copy(),
                buf_p=st.buf_p.copy(),
                buf_w=st.buf_w.copy(),
            ) for st in self._tenants],
        )

    def restore(self, state: dict) -> None:
        if len(state["tenants"]) != self.n_tenants:
            raise ValueError(
                "TenantStream.restore: snapshot has "
                f"{len(state['tenants'])} tenants, stream has "
                f"{self.n_tenants}")
        self.emitted = int(state["emitted"])
        for st, s in zip(self._tenants, state["tenants"]):
            st.rng.bit_generator.state = s["rng"]
            st.t_last = float(s["t_last"])
            st.buf_t = np.asarray(s["buf_t"], np.float64).copy()
            st.buf_p = np.asarray(s["buf_p"], np.int32).copy()
            st.buf_w = np.asarray(s["buf_w"], bool).copy()


def tenant_mix_stream(spec: TrafficSpec):
    """Whole-stream drain of a ``tenant_mix`` spec:
    ``(pages, is_write, times, tenant_ids)``. The canonical one-shot view —
    definitionally equal to any :class:`TenantStream` chunking."""
    return TenantStream(spec).take(spec.n_requests)
