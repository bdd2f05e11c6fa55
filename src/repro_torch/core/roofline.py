"""Roofline terms of one rank's program on the H100 (the reference's
``core/roofline.py``).

Three terms per (arch × shape × mesh) cell, in seconds:

    compute    = FLOPs / (chips × peak FLOP/s)
    memory     = bytes / (chips × HBM bytes/s)
    collective = collective wire bytes / (chips × link bytes/s)

The reference reads FLOPs, bytes and collectives from XLA's optimized HLO
text. The port produces no HLO: :func:`program_cost` counts one rank's
program op by op as it is dispatched (on the ``meta`` device in the dry
run, :mod:`repro_torch.launch.dryrun`, so nothing is allocated and nothing
runs), and the collectives' wire bytes come from the records that
:mod:`repro_torch.distributed.axes` keeps of every collective, under the
ring factors of :func:`wire_bytes`. The reference's HLO parsers
(``collective_bytes``, ``module_collective_bytes``, ``hlo_cost``) have no
counterpart here: nothing in the port could feed them.

An eager loop dispatches its body once a trip, so a scanned layer stack is
counted once a layer: the trip-count multiplication that the reference
does over ``while`` bodies comes for free.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["HW", "CollectiveStats", "wire_bytes", "roofline_report",
           "program_cost", "storage_bytes", "transport", "MAJOR_OPS"]

# One NVIDIA H100 SXM ("NVIDIA H100 80GB HBM3, 700.00 W" as nvidia-smi
# reports the card this repository measures on), its published dense
# peaks: bf16 on the tensor cores, HBM3, and NVLink 4 (900 GB/s a card to
# the others of its host, 450 GB/s each way). A host holds 8 cards, so a
# mesh axis of 16 spans two hosts, whose links are slower than NVLink:
# over such an axis the collective term is a lower bound.
HW = dict(
    peak_flops=989e12,   # bf16 FLOP/s, dense
    hbm_bw=3.35e12,      # bytes/s
    link_bw=450e9,       # bytes/s each way
)

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: Optional[dict] = None
    count: int = 0

    def __post_init__(self):
        if self.by_kind is None:
            self.by_kind = {}


def wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """A collective's wire bytes a chip under ring schedules, from its
    output's bytes ``out_bytes`` and its group's size ``n``:

      all-gather:          S · (n-1)/n
      reduce-scatter:      S · (n-1)      (input = S·n, sends (n-1) shards)
      all-reduce:          2 · S · (n-1)/n (RS + AG)
      all-to-all:          S · (n-1)/n
      collective-permute:  S
    """
    if kind not in _COLL_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return float(out_bytes * (n - 1))
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / max(n, 1)
    return float(out_bytes)


def roofline_report(*, hlo_flops: float, hlo_bytes: float,
                    coll: CollectiveStats, chips: int, model_flops: float,
                    hw: dict = HW) -> dict:
    """The §Roofline record for one (arch × shape × mesh) cell, on the
    hardware ``hw`` (the H100's :data:`HW` by default)."""
    t_compute = hlo_flops / (chips * hw["peak_flops"])
    t_memory = hlo_bytes / (chips * hw["hbm_bw"])
    # wire_bytes already per-chip-ish (each chip sends/receives its share of
    # the ring); divide by link bandwidth per chip.
    t_coll = coll.wire_bytes / (chips * hw["link_bw"])
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = model_flops / hlo_flops if hlo_flops else 0.0
    # Roofline fraction: ideal model-compute time over the binding term.
    ideal = model_flops / (chips * hw["peak_flops"])
    frac = ideal / bound if bound > 0 else 0.0
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops": hlo_flops,
        "useful_flops_frac": useful,
        "roofline_frac": frac,
        "collective_by_kind": dict(coll.by_kind),
        "collective_ops": coll.count,
    }


# ---------------------------------------------------------------------------
# program_cost: the counterpart of the reference's ``hlo_cost``.
# ---------------------------------------------------------------------------

# The aten counterparts of the reference's ``_MAJOR_OPS`` (dots,
# convolutions, copies, gathers and scatters, dynamic slices,
# concatenations, pads, sorts, reductions, cumsums, collectives and random
# bits). The reference also counts every fusion's output, which holds its
# elementwise chains; eager dispatch has no fusions, so elementwise ops are
# left out here (``bytes_all`` has them). So the port's ``bytes`` is not
# the reference's: ``tests/test_torch_dryrun.py`` measures the two on the
# same cells and states why they differ.
MAJOR_OPS = frozenset({
    # products (the reference's dot and convolution)
    "mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    # gathers, scatters and the index ops (gather, scatter,
    # dynamic-slice, dynamic-update-slice)
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index", "index_select",
    "index_put", "index_put_", "_index_put_impl_", "index_add",
    "index_add_", "index_copy", "index_copy_", "take", "embedding",
    "embedding_dense_backward", "masked_scatter", "masked_scatter_",
    # copies
    "copy", "copy_", "_to_copy", "clone",
    # concatenate, pad, sort
    "cat", "constant_pad_nd", "sort", "topk",
    # reductions and scans
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "any", "all", "linalg_vector_norm", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "logsumexp",
    "cumsum", "cumprod",
    # random bits
    "normal", "normal_", "uniform", "uniform_", "bernoulli", "bernoulli_",
    "randn", "rand", "randint", "random_",
})

# Ops that write no bytes: the counterparts of the reference's _SKIP_BYTES
# (parameters, constants, tuples, bitcasts); views are found by their
# storage (:func:`_is_view`).
_SKIP_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense", "lift_fresh",
    "lift_fresh_copy", "detach", "alias", "set_", "resize_",
})

# In-place ops that write only part of their output: the elements written.
_PARTIAL_WRITES = frozenset({
    "index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
    "scatter_reduce_", "index_add_", "index_copy_",
})


_TRANSPORT = [0]


@contextlib.contextmanager
def transport():
    """Mark a call into ``torch.distributed``: :func:`program_cost` counts
    the collective it issues (its ``c10d`` op) and not the ops that a
    backend dispatches around it (gloo's reduce-scatter splits its input
    and copies a block out, NCCL's does not)."""
    _TRANSPORT[0] += 1
    try:
        yield
    finally:
        _TRANSPORT[0] -= 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out=None) -> list:
    """The tensors in nested tuples, lists and dicts of an op's arguments
    or results."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def storage_bytes(x) -> int:
    """The bytes of the distinct storages of the tensors in ``x`` (nested
    tuples, named tuples, lists and dicts): what a program's arguments
    hold, each storage once however many views of it there are."""
    seen = {}
    for t in _tensors(x):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _written_bytes(name: str, args, out: list) -> int:
    """The bytes an op writes: its outputs', or for an in-place op that
    writes a part of its output (an index put, a scatter) that part's."""
    if name not in _PARTIAL_WRITES:
        return sum(_nbytes(t) for t in out)
    self = args[0]
    item = self.element_size()
    if name in ("index_put_", "_index_put_impl_"):
        idx = list(args[1])
        live = [i for i in idx if i is not None]
        shape = torch.broadcast_shapes(*(i.shape for i in live))
        n = 1
        for s in shape:
            n *= s
        for d, size in enumerate(self.shape):
            if d >= len(idx) or idx[d] is None:
                n *= size
        return n * item
    if name in ("scatter_", "scatter_add_", "scatter_reduce_"):
        return args[2].numel() * item
    # index_add_ / index_copy_: the source's rows
    return args[3].numel() * item


def _is_view(func, inputs: list, out: list) -> bool:
    """An op whose every output shares storage with an input and that
    mutates nothing: a view (or ``_unsafe_view``), which moves no byte."""
    if func._schema.is_mutable or not out:
        return False
    seen = {t.untyped_storage()._cdata for t in inputs}
    return all(t.untyped_storage()._cdata in seen for t in out)


class _Cost(TorchDispatchMode):
    """One dispatch mode that counts FLOPs, bytes and live device bytes."""

    def __init__(self, device: torch.device, args: list):
        super().__init__()
        self.device = device
        self.apart = device.type != "cpu"  # host work counted apart
        self.c = dict(flops=0.0, bytes=0.0, bytes_all=0.0, host_flops=0.0,
                      host_bytes=0.0, host_bytes_all=0.0,
                      transfer_bytes=0.0)
        self.live: dict = {}
        self.now = 0
        self.peak = 0
        for t in args:
            self._track(t)
        self.arguments = self.now

    def _track(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        name = func._schema.name.split("::")[-1]
        c10d = func.namespace == "c10d"
        if _TRANSPORT[0] and not c10d:
            return out
        devs = {t.device.type for t in inputs + outs}
        pre = ""
        if self.apart and devs <= {"cpu"}:
            pre = "host_"
        elif self.apart and "cpu" in devs and name in ("_to_copy", "copy_"):
            self.c["transfer_bytes"] += sum(
                _nbytes(t) for t in outs if t.device == self.device)
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.c[pre + "flops"] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if name in _SKIP_BYTES or (not c10d and _is_view(func, inputs, outs)):
            return out
        if c10d:  # a collective: the tensors it fills, not its Work handle
            written = sum(_nbytes(t) for t in outs)
        else:
            written = _written_bytes(name, args, outs)
        self.c[pre + "bytes_all"] += 2.0 * written
        if c10d or name in MAJOR_OPS:
            self.c[pre + "bytes"] += 2.0 * written
        return out


def program_cost(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` under one dispatch mode and count its work:

    - ``flops``: what ``torch.utils.flop_counter`` counts (matrix
      products, convolutions, attention), the reference's dot FLOPs;
    - ``bytes``: 2× the bytes written by the ops of :data:`MAJOR_OPS` and
      by the collectives (each output written once and read about once),
      the counterpart of the reference's ``bytes`` but not equal to it
      (:data:`MAJOR_OPS` says why);
    - ``bytes_all``: 2× the bytes written by every op but the views and
      the ops that write nothing, the counterpart of the reference's
      ``bytes_all``.

    An in-place op that writes a part of its output (an index put, a
    scatter) counts that part. The program's device is that of its tensor
    arguments that are not on the CPU (the CPU when all are). Where it is
    not the CPU, ops on host tensors alone (the serving tiers' metadata)
    are counted apart as ``host_flops``, ``host_bytes`` and
    ``host_bytes_all``, and copies between the host and the device as
    ``transfer_bytes``. Also returned: ``argument_bytes`` (the distinct
    storages of the arguments on the device), ``peak_bytes`` (the largest
    total of live device storages seen, the arguments included) and
    ``result`` (what ``fn`` returned)."""
    inputs = _tensors((args, kw))
    dev = next((t.device for t in inputs if t.device.type != "cpu"),
               torch.device("cpu"))
    mode = _Cost(dev, inputs)
    with mode:
        result = fn(*args, **kw)
    return dict(mode.c, argument_bytes=mode.arguments,
                peak_bytes=mode.peak, result=result)
