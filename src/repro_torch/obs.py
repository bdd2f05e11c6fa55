"""Spans and counters inside the serving path, live only while
``torch.profiler`` runs.

``span(name)`` marks a stretch of host work as a CPU event on the
profiler's own clock (kineto stamps host and device events alike in Unix
nanoseconds, so a span lines up with the device trace as it is). It
records with function scope (``torch._C._profiler._RecordFunctionFast``),
not with the user scope of ``torch.profiler.record_function``: kineto
copies a user-scope range that encloses kernels onto the device timeline
as a ``gpu_user_annotation``, where a reader of the trace would take it
for device work. With no profiler running, ``span`` reads one flag and
returns one shared null context.

``add(name, value)`` accumulates a counter, also only while a profiler
runs, filed under the root span open at the time (the outermost:
``engine.prefill`` or ``engine.decode_step``; ``""`` outside any span).
``value`` is an ``int``, or a tensor of integers or booleans whose
elements are summed on its device with no host synchronization (only
while a profiler runs, so an untraced caller launches nothing).
``snapshot()`` returns the totals as ``{root: {name: int}}``, with one
copy back from each device; ``reset()`` clears them.

The spans of the serving path: ``engine.prefill`` (the whole prefill
step), ``engine.decode_step`` (the whole decode step), inside it
``kv.alloc`` (``kvpool.alloc_step``: tier metadata, allocation, OL
eviction and the learner, on the host) and ``model.layers`` (the layer
loop, which enqueues the model's kernels). The counters: ``moe.kept``
(the (token, k) slots that fit their expert's capacity) and
``moe.slots`` (the rows of the capacity-padded expert buffers), from
:func:`repro_torch.models.moe.moe_swiglu`.

An operator reads them by running ``torch.profiler`` around
``serve()``: the spans are among the profiler's events, the counters in
``snapshot()``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "add", "snapshot", "reset"]

_NULL = contextlib.nullcontext()
_root = None       # the name of the outermost open span
_ints: dict = {}   # (root, name) -> int
_sums: dict = {}   # (root, name, device) -> 0-dim int64 tensor


class _Span:
    __slots__ = ("name", "_rec", "_is_root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _root
        self._is_root = _root is None
        if self._is_root:
            _root = self.name
        self._rec = torch._C._profiler._RecordFunctionFast(self.name)
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        global _root
        self._rec.__exit__(*exc)
        if self._is_root:
            _root = None
        return False


def span(name: str):
    """A context that records ``name`` as a host event while a profiler
    runs; otherwise the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def add(name: str, value) -> None:
    """Adds ``value`` (an ``int``, or the sum of a tensor's elements, taken
    on its device) to counter ``name`` under the open root span, while a
    profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    root = _root or ""
    if isinstance(value, torch.Tensor):
        key = (root, name, value.device)
        total = value.detach().sum(dtype=torch.int64)
        acc = _sums.get(key)
        if acc is None:
            _sums[key] = total
        else:
            acc.add_(total)
    else:
        _ints[(root, name)] = _ints.get((root, name), 0) + int(value)


def snapshot() -> dict:
    """Every counter's total so far, ``{root: {name: int}}``."""
    out: dict = {}

    def put(root, name, v):
        group = out.setdefault(root, {})
        group[name] = group.get(name, 0) + v

    for (root, name), v in _ints.items():
        put(root, name, v)
    by_device: dict = {}
    for (root, name, dev), t in _sums.items():
        by_device.setdefault(dev, []).append((root, name, t))
    for items in by_device.values():
        values = torch.stack([t for *_, t in items]).tolist()
        for (root, name, _), v in zip(items, values):
            put(root, name, int(v))
    return out


def reset() -> None:
    """Clears every counter."""
    _ints.clear()
    _sums.clear()
