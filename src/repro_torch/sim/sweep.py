"""Sweep engine: evaluate a grid of scenarios with shared work batched.

``sweep(base, axes)`` expands a cartesian grid of dotted-path overrides
over a base :class:`SimSpec` (e.g. ``{"store.n_lines": [16, 64, 256],
"n_shards": [2, 4], "store.policy": ["ws", "lru"]}``) and returns one
:class:`SimReport` per point.

Three levels of work sharing make wide sweeps cheap:

1. **Cache-run dedup** — points that differ only in queuing-side knobs
   (λ, k, flow, rates, p12_override) share a
   :meth:`SimSpec.cache_signature`; the tier-1 counter simulation runs
   once per signature.
2. **Megabatch launch** — signatures whose *structural* engine is
   identical (same ``StoreConfig.static_config()``, shard count, mapping,
   window count) stack into one ``[point × shard, len]`` batch of rows run
   by **one launch** of the cache-scan kernel
   (:func:`repro_torch.kernels.cache_scan.fused_cache_scan`). The scalar
   learning knobs (``alpha``, ``beta``, ``threshold`` and the policy
   selector) ride along per row, so a whole hyperparameter/policy grid
   shares one launch.
3. **Bucketed padding** — each point is padded to the next power-of-two
   length bucket of *its own* max shard load (floor :data:`MIN_BUCKET`),
   exactly as the reference pads it (the final expert weights depend on
   the pad length); buckets launch separately. Launches are asynchronous:
   host-side traffic generation and padding for later groups overlap the
   card's work on earlier ones, and the gather waits.

Windowed telemetry (``SimSpec.n_windows``) rides the same batch: window
ids are a data operand next to the stream (pads carry the dropped id
``n_windows``). Wall-clock windows (``SimSpec.window_dt``) are binned
host-side in float64 (:func:`timestamp_window_ids`) into the same operand.

:func:`engine_compile_count` counts the distinct structural configs
launched, the counterpart of the reference's XLA compiles of its batched
engine.

**Miss-rate-curve routing** (``mrc=`` keyword): when a grid axis varies
only the cache size and the spec sits inside the exact stack-distance
domain (LRU, no prefetch — see
:func:`repro_torch.sim.mrc.mrc_unsupported_reason`), the whole size axis
is served by :func:`repro_torch.sim.mrc.mrc_tier1_counters` instead: one
reuse-distance pass (a CUDA kernel on the card), no cache-scan launch,
counters bit-identical to the engine. ``mrc="auto"`` (default) routes
eligible multi-size groups and falls back to the engine with a logged
reason otherwise; ``"off"`` disables the path; ``"require"`` raises
``ValueError`` if any group cannot be routed.

**Streaming routing** (``stream=`` keyword): the megabatch stacks whole
traces on the card, so a grid point with a multi-million-request stream
(or a ``tenant_mix`` workload, whose per-tenant attribution only the
streaming path produces) is served by the chunked replay
(:mod:`repro_torch.sim.stream`): bounded device memory, at most two
buffer sets, counters bit-identical to the engine. ``stream="auto"``
(default) routes ``tenant_mix`` signatures and streams longer than
:data:`STREAM_THRESHOLD` requests; ``"off"`` forces everything through
the megabatch.

**Point split** (``devices=`` keyword): the megabatch's point axis is
split over a list of cards, as the reference splits it over its local
devices with ``shard_map``: each bucket's point count is padded up to a
multiple of the number of cards (with copies of its first point, dropped
after the gather), each card's rows are launched from one host thread
(launches are asynchronous, so the cards overlap), and the rows are
gathered back in point order. With one card (the default, ``device``)
nothing is padded or split. The reference's XLA knobs ``unroll`` and
``donate`` have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import logging
from time import perf_counter
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.queuing import (
    fluid_compile_count,
    reset_fluid_compile_count,
)
from repro_torch.core.traffic import make_stream, make_timed_stream
from repro_torch.device import resolve_device
from repro_torch.kernels.cache_scan import cold_keys, fused_cache_scan
from repro_torch.launch.compat import device_mesh
from repro_torch.sim.engine import (
    TenantCounters,
    Tier1Counters,
    batched_reports,
    counters_from_stats,
    fault_owner,
    sim_n_pages,
    tier1_counters,
)
from repro_torch.sim.mrc import mrc_tier1_counters, mrc_unsupported_reason
from repro_torch.sim.spec import SimSpec
from repro_torch.sim.stream import stream_tier1_counters
from repro_torch.storage.tiered_store import (
    StoreConfig,
    StoreHyper,
    StreamStats,
    _check_engine,
    _run_rows,
    partition_streams,
    timestamp_window_ids,
)

__all__ = [
    "expand_grid",
    "sweep",
    "SweepResult",
    "engine_compile_count",
    "reset_engine_compile_count",
    "fluid_compile_count",
    "reset_fluid_compile_count",
]

log = logging.getLogger(__name__)

# Smallest padded stream-length bucket; lengths round up to powers of two so
# ragged groups land in a handful of shapes instead of one shape per point.
MIN_BUCKET = 16
# Streams longer than this route through the chunked replay under
# stream="auto": stacking them whole on the card stops paying off before
# the megabatch's launch sharing does.
STREAM_THRESHOLD = 1 << 20

# Structural configs launched so far, and the count since the last reset.
_ENGINE_KEYS: set = set()
_ENGINE_COMPILES = [0]


def engine_compile_count() -> int:
    """Number of structural configs the batched sweep engine has launched
    for the first time since the last reset."""
    return _ENGINE_COMPILES[0]


def reset_engine_compile_count() -> None:
    _ENGINE_COMPILES[0] = 0


def expand_grid(axes: Mapping[str, Sequence]) -> list[dict]:
    """Cartesian product of ``{dotted.path: values}`` into override dicts."""
    if not axes:
        return [{}]
    keys = list(axes)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(axes[k] for k in keys))
    ]


@dataclasses.dataclass(frozen=True)
class SweepResult:
    base: SimSpec
    axes: dict
    points: tuple          # override dict per point
    reports: tuple         # SimReport per point
    # sweep(profile=True): per-stage wall-clock seconds — stream_gen
    # (host-side traffic generation + partitioning for the megabatch),
    # engine_dispatch (kernel launches + gather, plus the routed MRC and
    # unbatched paths), report_solve (queuing-network solves), assembly
    # (SimReport construction) and total.
    profile: Optional[dict] = None

    def rows(self) -> list[dict]:
        """One flat dict per point: the overrides + aggregate metrics."""
        out = []
        for pt, rep in zip(self.points, self.reports):
            d = rep.to_dict()
            d.pop("shards")
            d.pop("spec")
            out.append({**{str(k): v for k, v in pt.items()}, **d})
        return out

    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "axes": {k: list(v) for k, v in self.axes.items()},
            "n_points": len(self.points),
            "points": [
                {**{str(k): v for k, v in pt.items()}, **rep.to_dict()}
                for pt, rep in zip(self.points, self.reports)
            ],
        }
        if self.profile is not None:
            payload["profile"] = dict(self.profile)
        text = json.dumps(payload, indent=2, default=_jsonify)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def _jsonify(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):  # any numpy scalar, incl. np.bool_
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj)!r}")


def _batch_key(spec: SimSpec) -> tuple:
    """Signatures with equal batch keys share one kernel launch: only the
    *structural* store config splits groups — the scalar learning knobs
    (alpha/beta/threshold/policy) are per-row operands and stack instead.
    The window count sizes the counters, so it is structural too; window
    ids are data, so timed and request-index grids share a launch."""
    n_windows, _ = spec.window_grid()
    return (spec.store.static_config(), spec.n_shards, spec.mapping,
            n_windows)


def _mrc_group_key(spec: SimSpec) -> tuple:
    """Signatures equal after erasing ``store.n_lines`` form one MRC group:
    they share the stream, partition, faults and window layout and differ
    only in cache size — exactly the axis one stack-distance pass covers."""
    return spec.replace(**{"store.n_lines": 1}).cache_signature()


def _route_mrc(
    unique: Mapping[tuple, SimSpec], mrc: str, device: torch.device
) -> dict[tuple, Tier1Counters]:
    """Serve every eligible size-only signature group via the one-pass MRC
    engine. Returns ``{signature: counters}`` for the routed signatures
    (bit-identical to the engine); the caller runs the rest through the
    megabatch. ``mrc="require"`` raises if any group is ineligible;
    ``"auto"`` routes only groups with >= 2 sizes (a single size gains
    nothing over the engine)."""
    groups: dict[tuple, list[tuple]] = {}
    for sig, spec in unique.items():
        groups.setdefault(_mrc_group_key(spec), []).append(sig)

    counters: dict[tuple, Tier1Counters] = {}
    for sigs in groups.values():
        rep = unique[sigs[0]]
        reason = mrc_unsupported_reason(rep)
        if reason is not None:
            if mrc == "require":
                raise ValueError(
                    "mrc='require' but the MRC path cannot serve this "
                    f"grid: {reason}"
                )
            if len(sigs) >= 2:
                log.info(
                    "sweep: MRC fallback to scan engine for %d sizes (%s)",
                    len(sigs), reason,
                )
            continue
        if len(sigs) < 2 and mrc != "require":
            continue
        sizes = sorted(unique[s].store.n_lines for s in sigs)
        log.info(
            "sweep: MRC route — %d cache sizes from one distance pass "
            "(policy=lru, n_shards=%d)",
            len(sizes), rep.n_shards,
        )
        by_size = mrc_tier1_counters(rep, sizes, device=device)
        for s in sigs:
            counters[s] = by_size[int(unique[s].store.n_lines)]
    return counters


def _route_stream(
    unique: Mapping[tuple, SimSpec], stream: str, *, device: torch.device,
    engine: str = "fused", profile: Optional[dict] = None,
) -> tuple[dict[tuple, Tier1Counters], dict[tuple, TenantCounters]]:
    """Serve ``tenant_mix`` and oversized-stream signatures via the chunked
    replay (:mod:`repro_torch.sim.stream`): bounded device memory, at most
    two buffer sets, counters bit-identical to the engine. Returns
    ``({signature: counters}, {signature: tenant_counters})`` for the
    routed signatures; the caller runs the rest through the megabatch.
    ``profile`` threads per-chunk sub-timings through to
    :func:`repro_torch.sim.stream.stream_tier1_counters`."""
    counters: dict[tuple, Tier1Counters] = {}
    tenants: dict[tuple, TenantCounters] = {}
    if stream == "off":
        return counters, tenants
    for sig, spec in unique.items():
        mix = spec.traffic.kind == "tenant_mix"
        if not (mix or spec.traffic.n_requests > STREAM_THRESHOLD):
            continue
        log.info(
            "sweep: stream route — %s, %d requests (chunked replay)",
            "tenant_mix" if mix else "oversized stream",
            spec.traffic.n_requests,
        )
        ctr, tc, _ = stream_tier1_counters(spec, engine=engine,
                                           profile=profile, device=device)
        counters[sig] = ctr
        if tc is not None:
            tenants[sig] = tc
    return counters, tenants


def _bucket_cap(n: int) -> int:
    """Next power-of-two length bucket (floor MIN_BUCKET) for a shard load."""
    cap = MIN_BUCKET
    while cap < n:
        cap <<= 1
    return cap


def _stack_hypers(stores: Sequence[StoreConfig]) -> StoreHyper:
    """``[N]`` StoreHyper stack for a list of store configs."""
    hypers = [s.hyper() for s in stores]
    return StoreHyper(*(torch.stack(xs) for xs in zip(*hypers)))


def _launch_rows(store: StoreConfig, hyper: StoreHyper, sh_pages, sh_writes,
                 sh_win, n_windows: int, device: torch.device,
                 engine: str = "fused") -> StreamStats:
    """One launch of the cache-scan engine over ``[N, S, L]`` stacked
    points: rows are ``point × shard``, each point's knobs repeated over its
    shards, every row cold with the reference's seed-0 key. Returns
    un-corrected :class:`StreamStats` with a ``[N * S]`` row axis (the
    kernel's outputs, still in flight on the card). ``engine="scan"``
    runs the same rows through the per-step engine instead."""
    key = (store, n_windows, engine)
    if key not in _ENGINE_KEYS:
        _ENGINE_KEYS.add(key)
        _ENGINE_COMPILES[0] += 1
    N, S, L = sh_pages.shape
    B = N * S
    rows = StoreHyper(*(x.repeat_interleave(S).to(device) for x in hyper))
    if engine == "scan":
        return _run_rows(store, sh_pages.reshape(B, L),
                         sh_writes.reshape(B, L), sh_win.reshape(B, L),
                         seed=0, hyper=rows, n_windows=n_windows,
                         device=device, engine=engine)
    out = fused_cache_scan(
        store, rows, cold_keys(0, B, device),
        torch.as_tensor(sh_pages.reshape(B, L), device=device),
        torch.as_tensor(sh_writes.reshape(B, L), device=device),
        torch.as_tensor(sh_win.reshape(B, L), device=device),
        n_windows=n_windows)
    return StreamStats(
        requests=torch.full((B,), L, dtype=torch.int32, device=device),
        **out)


class _Member(NamedTuple):
    """One unique cache signature prepared for stacking."""

    bucket: int          # power-of-two padded length for this point
    sig: tuple           # cache signature
    spec: SimSpec
    sh_pages: np.ndarray  # [S, own_cap] partitioned stream
    sh_writes: np.ndarray
    sh_win: np.ndarray   # [S, own_cap] window ids (n_windows = pad/drop);
                         # timed specs pre-bin arrival times into these
    counts: np.ndarray   # per-shard real request counts
    shard_writes: np.ndarray  # per-shard write counts


@dataclasses.dataclass
class _PendingBucket:
    """One launched stacked engine call awaiting its gather."""

    sigs: list           # cache signature per point
    counts: list         # per-point per-shard real request counts
    writes: list         # per-point per-shard write counts
    cap: int             # padded stream length (bucket)
    stats: list          # StreamStats of [N_card * S] rows, a card each,
                         # in point order (in flight)

    def gather(self) -> dict:
        # Copying to the host waits for the kernels.
        stacked = StreamStats(*(torch.cat([x.cpu() for x in xs])
                                for xs in zip(*self.stats)))
        S = len(self.counts[0])
        out = {}
        for i, sig in enumerate(self.sigs):
            stats_i = StreamStats(*(x[i * S:(i + 1) * S] for x in stacked))
            out[sig] = counters_from_stats(
                stats_i, self.counts[i], self.writes[i], cap=self.cap
            )
        return out


def _dispatch_group(
    specs: list[SimSpec], sigs: list, *, devices: Sequence[torch.device],
    engine: str = "fused", _prof: Optional[dict] = None,
) -> list[_PendingBucket]:
    """Partition, bucket, pad and launch every unique cache signature of
    one batch-key group, each bucket's points split over ``devices``.
    Returns pending buckets; the cards compute while the caller prepares
    and launches later groups. ``_prof`` accumulates ``stream_gen`` /
    ``engine_dispatch`` seconds (submission side — see
    ``engine_dispatch_submit``)."""
    store_static = specs[0].store.static_config()
    n_shards = specs[0].n_shards
    n_windows, window_dt0 = specs[0].window_grid()
    timed = window_dt0 is not None

    t0 = perf_counter()
    members = []
    for spec, sig in zip(specs, sigs):
        n_windows_i, window_dt = spec.window_grid()
        assert n_windows_i == n_windows  # grouped by batch key
        if timed:
            pages, is_write, times = make_timed_stream(
                spec.traffic, default_rate=spec.agg_rate())
            n_pages_i = sim_n_pages(spec, pages)
            # Fault schedules ride the megabatch as *data*: the failover
            # remap happens host-side and only reshuffles the owner array.
            own = fault_owner(spec, pages, times, n_pages_i)
            gwin = timestamp_window_ids(times, n_windows, window_dt)
            sh_p, sh_w, counts, owner, sh_tw = partition_streams(
                pages, is_write, n_shards=n_shards, mapping=spec.mapping,
                n_pages=n_pages_i, n_windows=n_windows, window_ids=gwin,
                owner=own,
            )
        else:
            pages, is_write = make_stream(spec.traffic)
            sh_p, sh_w, counts, owner, sh_tw = partition_streams(
                pages, is_write, n_shards=n_shards, mapping=spec.mapping,
                n_pages=sim_n_pages(spec, pages), n_windows=n_windows,
            )
        members.append(_Member(
            bucket=_bucket_cap(sh_p.shape[1]),
            sig=sig,
            spec=spec,
            sh_pages=sh_p,
            sh_writes=sh_w,
            sh_win=sh_tw,
            counts=counts,
            shard_writes=np.bincount(owner[is_write], minlength=n_shards),
        ))

    t1 = perf_counter()
    if _prof is not None:
        _prof["stream_gen"] = _prof.get("stream_gen", 0.0) + (t1 - t0)

    buckets: dict[int, list[_Member]] = {}
    for m in members:
        buckets.setdefault(m.bucket, []).append(m)

    n_dev = len(devices)
    pending = []
    for cap, group in sorted(buckets.items()):
        n = len(group)
        n_pad = -(-n // n_dev) * n_dev  # the point axis splits evenly
        sh_pages = np.zeros((n_pad, n_shards, cap), np.int32)
        sh_writes = np.zeros((n_pad, n_shards, cap), bool)
        # Bucket-extension positions are padding: window id n_windows
        # drops them from the windowed counters.
        sh_win = np.full((n_pad, n_shards, cap), n_windows, np.int32)
        for i, m in enumerate(group):
            w = m.sh_pages.shape[1]
            # Rows come pre-padded with their shard's last page; extending
            # that edge-repeat keeps the padding a pure-hit stream.
            sh_pages[i, :, :w] = m.sh_pages
            sh_pages[i, :, w:] = m.sh_pages[:, -1:]
            sh_writes[i, :, :w] = m.sh_writes
            sh_win[i, :, :w] = m.sh_win
        # Padded points repeat the first: discarded after the gather.
        sh_pages[n:], sh_writes[n:], sh_win[n:] = (
            sh_pages[0], sh_writes[0], sh_win[0])
        stores = [m.spec.store for m in group]
        hyper = _stack_hypers(stores + [stores[0]] * (n_pad - n))

        log.info(
            "sweep: dispatch %d points x %d shards @ len %d "
            "(n_lines=%d, windows=%d, timed=%s, devices=%s)",
            n, n_shards, cap, store_static.n_lines, n_windows, timed,
            list(devices),
        )
        per = n_pad // n_dev
        stats = [_launch_rows(
            store_static, StoreHyper(*(x[c * per:(c + 1) * per]
                                       for x in hyper)),
            sh_pages[c * per:(c + 1) * per], sh_writes[c * per:(c + 1) * per],
            sh_win[c * per:(c + 1) * per], n_windows, dev, engine)
            for c, dev in enumerate(devices)]
        pending.append(_PendingBucket(
            sigs=[m.sig for m in group],
            counts=[m.counts for m in group],
            writes=[m.shard_writes for m in group],
            cap=cap,
            stats=stats,
        ))
    if _prof is not None:
        # Submission side of the engine stage: host→device copies of the
        # stacked operands and the launches (the kernel is still running
        # when this returns). The wait side lands on
        # ``engine_dispatch_wait``; ``engine_dispatch`` is their sum.
        dt = perf_counter() - t1
        _prof["engine_dispatch"] = _prof.get("engine_dispatch", 0.0) + dt
        _prof["engine_dispatch_submit"] = (
            _prof.get("engine_dispatch_submit", 0.0) + dt)
    return pending


def sweep(
    base: SimSpec,
    axes,
    *,
    batch: bool = True,
    mrc: str = "auto",
    stream: str = "auto",
    report: str = "auto",
    engine: str = "fused",
    profile: bool = False,
    verbose: bool = False,
    device=None,
    devices: Optional[Sequence] = None,
) -> SweepResult:
    """Evaluate ``base`` at every point of the ``axes`` grid on ``device``
    (``None`` = the card, raising when there is none), the megabatch's
    points split over ``devices`` (default: ``device`` alone; see the
    module docstring's point split).

    ``axes`` is either a ``{dotted.path: values}`` mapping (expanded to
    its cartesian grid) or an explicit sequence of override dicts.

    ``batch=True`` runs the megabatch (one cache-scan launch per
    structural group and length bucket, see the module docstring);
    ``batch=False`` simulates every signature independently
    (:func:`repro_torch.sim.engine.tier1_counters`, bit-identical
    counters).

    ``mrc`` controls miss-rate-curve routing of cache-size axes:
    ``"auto"`` serves eligible size-only groups from one reuse-distance
    pass, ``"off"`` always runs the engine, ``"require"`` raises
    ``ValueError`` when the MRC path cannot serve the grid (incompatible
    with ``batch=False``).

    ``stream`` controls routing to the chunked replay (see the module
    docstring): ``"auto"`` serves ``tenant_mix`` signatures (adding
    per-tenant attribution to their reports) and streams past
    :data:`STREAM_THRESHOLD` requests via :mod:`repro_torch.sim.stream`;
    ``"off"`` forces the megabatch.

    ``report`` picks the report-stage solver
    (:func:`repro_torch.sim.engine.batched_reports`): ``"batched"`` stacks
    every fluid-mode point's windowed rates into one ``[point, shard,
    window]`` float64 torch solve on ``device``; ``"scalar"`` solves per
    point with the numpy loop — ``SimReport`` JSON identical to the
    reference's scalar path; ``"auto"`` follows ``batch``.

    ``engine`` selects the tier-1 request loop
    (:func:`repro_torch.storage.tiered_store.run_stream`): ``"fused"``
    (default) is the cache-scan kernel, ``"scan"`` the per-step engine
    (plain PyTorch on ``device``) it is bit-exact against.

    ``profile=True`` attaches a per-stage wall-clock breakdown (seconds)
    to :attr:`SweepResult.profile` under the reference's keys:
    ``stream_gen``, ``engine_dispatch`` = ``engine_dispatch_submit``
    (copies and launches) + ``engine_dispatch_wait`` (the gather, which
    waits for the card), plus the routed stream, MRC and unbatched paths
    (the chunked replay adds its per-chunk ``stream_chunk_host`` /
    ``stream_chunk_dispatch`` / ``stream_chunk_wait`` timings),
    ``report_solve``, ``assembly`` and ``total``.

    The reference's ``unroll`` (a ``lax.scan`` unroll) and ``donate``
    (XLA buffer donation) have no meaning for a CUDA kernel and are not
    taken.
    """
    if mrc not in ("auto", "off", "require"):
        raise ValueError(
            f"mrc must be 'auto', 'off' or 'require', got {mrc!r}")
    if stream not in ("auto", "off"):
        raise ValueError(f"stream must be 'auto' or 'off', got {stream!r}")
    if report not in ("auto", "batched", "scalar"):
        raise ValueError(
            f"report must be 'auto', 'batched' or 'scalar', got {report!r}")
    if mrc == "require" and not batch:
        raise ValueError(
            "mrc='require' is incompatible with batch=False: the unbatched "
            "path exists as the scan-engine reference")
    _check_engine(engine)
    device = resolve_device(device)
    devices = ((device,) if devices is None
               else device_mesh("points", devices))
    if verbose:
        # Convenience for interactive use: make this module's INFO progress
        # lines visible regardless of how (or whether) the app configured
        # logging. verbose=False leaves logging config entirely to the app.
        log.setLevel(logging.INFO)
        if not (log.handlers or logging.getLogger().handlers):
            logging.basicConfig(level=logging.INFO)
    if isinstance(axes, Mapping):
        axes_dict = dict(axes)
        points = expand_grid(axes)
    else:
        axes_dict = {}
        points = [dict(pt) for pt in axes]
    specs = [base.replace(**pt) for pt in points]
    solver = ("batched" if batch else "scalar") if report == "auto" else report
    prof: Optional[dict] = (
        {"stream_gen": 0.0, "engine_dispatch": 0.0,
         "engine_dispatch_submit": 0.0, "engine_dispatch_wait": 0.0,
         "report_solve": 0.0, "assembly": 0.0}
        if profile else None
    )
    t_start = perf_counter()

    # One cache run per unique signature.
    sig_of = [spec.cache_signature() for spec in specs]
    unique: dict[tuple, SimSpec] = {}
    for spec, sig in zip(specs, sig_of):
        unique.setdefault(sig, spec)

    counters: dict[tuple, Tier1Counters] = {}
    tenant_ctrs: dict[tuple, TenantCounters] = {}
    t0 = perf_counter()
    if batch:
        counters, tenant_ctrs = _route_stream(
            unique, stream, device=device, engine=engine, profile=prof)
    if batch and mrc != "off":
        counters.update(_route_mrc(
            {s: sp for s, sp in unique.items() if s not in counters}, mrc,
            device))
    if prof is not None:
        # The routed paths generate their streams internally; their whole
        # cost lands on engine_dispatch.
        prof["engine_dispatch"] += perf_counter() - t0
    if batch:
        groups: dict[tuple, list[tuple]] = {}
        for sig, spec in unique.items():
            if sig in counters:  # already served by a routed path
                continue
            groups.setdefault(_batch_key(spec), []).append(sig)
        # Launch everything first, then gather: traffic generation and
        # padding for group k+1 overlap the card's work on group k.
        pending: list[_PendingBucket] = []
        for key, sigs in groups.items():
            log.info(
                "sweep: batch group n_shards=%d, %d signatures "
                "(n_lines=%d, mapping=%s)",
                key[1], len(sigs), key[0].n_lines, key[2],
            )
            pending.extend(
                _dispatch_group([unique[s] for s in sigs], sigs,
                                devices=devices, engine=engine, _prof=prof)
            )
        t0 = perf_counter()
        for bucket in pending:
            counters.update(bucket.gather())
        if prof is not None:
            # The gather waits for the card: the wait side of the engine
            # stage (kernel time + device→host copies).
            dt = perf_counter() - t0
            prof["engine_dispatch"] += dt
            prof["engine_dispatch_wait"] += dt
    else:
        t0 = perf_counter()
        for sig, spec in unique.items():
            log.info("sweep: run %s", sig)
            counters[sig] = tier1_counters(spec, engine=engine,
                                           device=device)
        if prof is not None:
            prof["engine_dispatch"] += perf_counter() - t0

    reports = batched_reports(
        [(spec, counters[sig], tenant_ctrs.get(sig))
         for spec, sig in zip(specs, sig_of)],
        solver=solver, _prof=prof, device=device,
    )
    if prof is not None:
        prof["total"] = perf_counter() - t_start
        prof["n_points"] = len(points)
        prof["report_solver"] = solver
    return SweepResult(
        base=base,
        axes=axes_dict,
        points=tuple(points),
        reports=tuple(reports),
        profile=prof,
    )
