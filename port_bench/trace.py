"""The traced stretch of a ``--trace 1`` run, after its window: one round's
prefill under ``torch.profiler``, then decode steps off the page edges, a
few of them profiled; each phase bracketed by the benchmark's own spans
(``record_function``: prefill, decode step, promotion, token read-back).

Every decode step and the prefill end in a read-back to the host, so the
device work a phase launches lies inside that phase's host interval.
"""
from __future__ import annotations

import torch

SPANS = {"pb.prefill": "prefill", "pb.decode": "decode_step",
         "pb.promote": "promotion", "pb.readback": "readback"}
COPY = ("Memcpy", "Memset")


def union(intervals, lo: int, hi: int) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _phase(prof) -> dict:
    """Device operations, the benchmark's spans and the host's ops of one
    profiler run, in ns on one clock."""
    device, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.duration_ns())
        if e.name() in SPANS:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append(item)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    lo = min(s for _, s, _ in spans)
    hi = max(s + d for _, s, d in spans)
    kernels = [k for k in device if not k[0].startswith(COPY)]
    busy = union([(s, s + d) for _, s, d in device], lo, hi)
    return dict(kernels=kernels, device=device, spans=spans, host=host,
                lo=lo, hi=hi, busy=busy,
                busy_s=sum(b - a for a, b in busy) / 1e9)


def profile(server, params, seed: int, skip: int, steps: int,
            on_card: bool) -> dict:
    """The profiled prefill and ``steps`` profiled decode steps after
    ``skip`` untraced ones, of a round of the cell's own shapes."""
    from port_bench.harness import PROFILE_ROUND, sync
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    rounds = server.round(params, server.prompts(seed, PROFILE_ROUND),
                          steps=skip + steps, spans=True)
    with torch.profiler.profile(activities=acts) as p1:
        next(rounds)
    prefill = _phase(p1)
    for _ in range(skip):
        next(rounds)
    with torch.profiler.profile(activities=acts) as p2:
        for _ in range(steps):
            next(rounds)
    decode = _phase(p2)
    rounds.close()
    sync(server.device)
    decode.update(steps=steps, live=[server.prompt + skip + t + 1
                                     for t in range(steps)])
    return dict(prefill=prefill, decode=decode,
                busy_s=prefill["busy_s"] + decode["busy_s"],
                window_s=(prefill["hi"] - prefill["lo"]
                          + decode["hi"] - decode["lo"]) / 1e9)


def _label(t: int, ph: dict) -> str:
    """What the host was doing at ``t``: the benchmark's span, and the
    innermost host op it was in."""
    def inner(items):
        best = None
        for name, s, d in items:
            if s <= t < s + d and (best is None or s >= best[1]):
                best = (name, s)
        return best and best[0]
    span = inner(ph["spans"])
    op = inner(ph["host"])
    return (SPANS.get(span, "between") + (f"/{op}" if op else ""))[:120]


def breakdown(prof: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device by what the host was doing, in seconds."""
    by_name: dict = {}
    gaps = []
    for ph in (prof["prefill"], prof["decode"]):
        for name, _, d in ph["device"]:
            by_name[name[:120]] = by_name.get(name[:120], 0) + d
        edges = [ph["lo"]] + [x for iv in ph["busy"] for x in iv] \
            + [ph["hi"]]
        gaps += [(b - a, a, ph) for a, b in zip(edges[0::2], edges[1::2])
                 if b > a]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda g: -g[0])[:top]
    return dict(device_ops=[[n, d / 1e9] for n, d in ops],
                idle_gaps=[[_label(a + g // 2, s), g / 1e9]
                           for g, a, s in gaps])
