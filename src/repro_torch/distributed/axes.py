"""Mesh-axis context and the collectives the model code calls.

The reference runs every step body under ``shard_map``: each device sees
its local shard, and every collective is explicit. The port runs one
process per rank of a mesh (:mod:`repro_torch.launch.mesh`); each rank
holds its local shard as a plain tensor, which is what the body of
``shard_map`` sees, and the collectives go through ``torch.distributed``
process groups, one for every set of mesh axes
(:class:`repro_torch.launch.mesh.Mesh`).

``Axes`` names the mesh axes a computation runs under; an axis that is
``None`` is absent, and every helper over it is the identity, so
:data:`SINGLE` runs the one-card code unchanged. A reduction over several
axes (``psum_many`` / ``pmax_many``) is one collective over the group that
spans them, as the reference reduces once: two reductions in sequence
would round in another order.

Gradients through the collectives. The reference differentiates its
step under ``shard_map(check_vma=True)``, where every value is typed by
the mesh axes it varies over, and autodiff places the gradient
reductions from those types. The port has no such types, so each
collective here carries the backward that those types give it:

- a sum whose output is replicated (:meth:`Axes.psum`, its alias
  :meth:`Axes.psum_rep`, :meth:`Axes.psum_many`, :meth:`Axes.pmean`) has
  the identity as its backward: every rank's partial gets the
  replicated output's gradient;
- a replicated value consumed by compute that differs from rank to rank
  passes through :meth:`Axes.enter` (the reference's ``pvary_entry``,
  and its implicit promotion under vma), whose backward sums the ranks'
  partial gradients over those axes;
- :meth:`Axes.all_gather` (the FSDP gather) has a reduce-scatter sum as
  its backward, so a gathered leaf's gradient comes out as this rank's
  block summed over the axis (ZeRO-3), and :meth:`Axes.psum_scatter` an
  all-gather.

``pmax`` and ``pmax_many`` have no backward: the reference takes them on
values held constant under differentiation, and they refuse inputs that
require grad. Every rank must issue its collectives in the same order,
the backward's included: the autograd engine runs one graph's backward
in one order, and the same graph on every rank. A mismatch hangs until
the process group's timeout.
:func:`collective_stats` counts the backward's collectives too, under
their own kinds (``"psum (backward)"``, ``"psum_scatter (backward)"``,
``"all_gather (backward)"``). Each kind's wire bytes a rank are kept
beside them (:func:`collective_wire_bytes`), from the output's bytes and
the group's size under the ring factors of
:func:`repro_torch.core.roofline.wire_bytes`, with the port's kinds mapped
onto the reference's (:data:`REF_KIND`: the sums and maxima are
all-reduces, the gathers all-gathers, the scatters reduce-scatters);
:func:`collective_wire_stats` sums them by the reference's kinds for the
roofline. The reference's ``pvary_like`` /
``vma_of`` type values for ``shard_map``'s check, which has no
counterpart here: they are not ported.

Transport. The mesh's backend is NCCL where each rank has a card of its
own, else gloo (ranks that share a card, or run on the CPU;
:func:`repro_torch.launch.mesh.backend_for`). Gloo takes CUDA tensors for
``all_reduce`` (sum and max; f32, bf16, int32, int64) and ``all_gather``
in torch 2.11 on an H100 (PERF.md §6) and stages them through
host memory itself, so the tensors go to the collective as they are; the
rank's compute stays on its card. The reduce-scatter goes to
``reduce_scatter_tensor`` as it is; a backend that refuses it raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.roofline import CollectiveStats, transport, wire_bytes

__all__ = ["Axes", "SINGLE", "REF_KIND", "collective_stats",
           "collective_wire_bytes", "collective_wire_stats",
           "reset_collective_stats", "time_collectives"]

# Each kind of collective as the reference's HLO names it.
REF_KIND = {
    "psum": "all-reduce", "pmax": "all-reduce",
    "psum (backward)": "all-reduce",
    "all_gather": "all-gather", "all_gather (backward)": "all-gather",
    "psum_scatter": "reduce-scatter",
    "psum_scatter (backward)": "reduce-scatter",
}

# Collectives issued, bytes each rank sent into them and (when timed)
# seconds spent in them, by kind; and their wire bytes a rank.
_STATS: dict = {}
_WIRE: dict = {}
_TIMED = [False]


def collective_stats() -> dict:
    """``{kind: (calls, bytes, seconds)}`` of this process's collectives
    since the last reset (``bytes``: the local tensors'; ``seconds``: 0
    unless :func:`time_collectives` is on)."""
    return dict(_STATS)


def collective_wire_bytes() -> dict:
    """``{kind: wire bytes}`` a rank of this process's collectives since
    the last reset (:func:`repro_torch.core.roofline.wire_bytes` of each
    call's output over its group)."""
    return dict(_WIRE)


def collective_wire_stats() -> CollectiveStats:
    """The collectives since the last reset as the roofline takes them:
    calls and wire bytes summed by the reference's kinds."""
    st = CollectiveStats()
    for kind, wire in _WIRE.items():
        ref = REF_KIND[kind]
        st.wire_bytes += wire
        st.by_kind[ref] = st.by_kind.get(ref, 0.0) + wire
        st.count += _STATS[kind][0]
    return st


def reset_collective_stats() -> None:
    _STATS.clear()
    _WIRE.clear()


def time_collectives(on: bool) -> None:
    """Time each collective on CUDA tensors, from a synchronized card to
    its result on the card (the card synchronizes before and after each,
    which the untimed path does not do)."""
    _TIMED[0] = on


def _collective(kind: str, x: torch.Tensor, run, group):
    """Run the collective ``run`` on ``x`` (returning the result) over
    ``group`` and count it."""
    timed = _TIMED[0] and x.is_cuda
    if timed:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out = run(x)
    if timed:
        torch.cuda.synchronize(x.device)
    n, b, sec = _STATS.get(kind, (0, 0, 0.0))
    _STATS[kind] = (n + 1, b + x.numel() * x.element_size(),
                    sec + (time.perf_counter() - t0 if timed else 0.0))
    _WIRE[kind] = _WIRE.get(kind, 0.0) + wire_bytes(
        REF_KIND[kind], out.numel() * out.element_size(),
        dist.get_world_size(group))
    return out


def _all_reduce(kind: str, x: torch.Tensor, group, op) -> torch.Tensor:
    def run(t):
        t = t.contiguous().clone()
        with transport():
            dist.all_reduce(t, op=op, group=group)
        return t
    return _collective(kind, x, run, group)


def _all_gather(kind: str, x: torch.Tensor, group, n: int, axis: int
                ) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` concatenated along ``axis`` in
    the order of their group rank (their coordinate on the axis)."""
    def run(t):
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(n)]
        with transport():
            dist.all_gather(out, t, group=group)
        return torch.cat(out, dim=axis)
    return _collective(kind, x, run, group)


def _reduce_scatter(kind: str, x: torch.Tensor, group, n: int, axis: int
                    ) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``x``, cut into ``n`` blocks along
    ``axis``: this rank's block (the one at its group rank)."""
    def run(t):
        t = t.movedim(axis, 0).contiguous()
        out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        with transport():
            dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM,
                                       group=group)
        return out.movedim(0, axis)
    return _collective(kind, x, run, group)


class _Sum(torch.autograd.Function):
    """All-reduce sum whose output is replicated: the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce("psum", x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity, whose backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce("psum (backward)", g, ctx.group,
                            dist.ReduceOp.SUM), None)


class _Gather(torch.autograd.Function):
    """Tiled all-gather; its backward a reduce-scatter sum."""

    @staticmethod
    def forward(ctx, x, group, n, axis):
        ctx.group, ctx.n, ctx.axis = group, n, axis
        return _all_gather("all_gather", x, group, n, axis)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter("psum_scatter (backward)", g, ctx.group,
                                ctx.n, ctx.axis), None, None, None)


class _Scatter(torch.autograd.Function):
    """Reduce-scatter sum; its backward a tiled all-gather."""

    @staticmethod
    def forward(ctx, x, group, n, axis):
        ctx.group, ctx.n, ctx.axis = group, n, axis
        return _reduce_scatter("psum_scatter", x, group, n, axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather("all_gather (backward)", g, ctx.group, ctx.n,
                            ctx.axis), None, None, None)


def _real(names: Sequence[Optional[str]]) -> tuple:
    return tuple(n for n in names if n is not None)


@dataclasses.dataclass(frozen=True)
class Axes:
    data: Optional[str] = None   # FSDP + batch axis
    model: Optional[str] = None  # TP axis
    pod: Optional[str] = None    # pure-DP axis
    # The rank's mesh (coordinates and process groups); None outside one.
    mesh: object = dataclasses.field(default=None, compare=False, repr=False)

    # -- sizes / indices -------------------------------------------------
    def size(self, name: Optional[str]) -> int:
        return 1 if name is None else self.mesh.size(name)

    def index(self, name: Optional[str]) -> int:
        return 0 if name is None else self.mesh.coord(name)

    @property
    def model_size(self) -> int:
        return self.size(self.model)

    @property
    def data_size(self) -> int:
        return self.size(self.data)

    @property
    def pod_size(self) -> int:
        return self.size(self.pod)

    def batch_shards(self) -> int:
        """How many ways the global batch is split (pod x data)."""
        return self.pod_size * self.data_size

    def tp_degree(self, n: int) -> int:
        """TP degree for an n-way-splittable dimension: the model axis
        when it divides n, else 1 (compute replicated across the axis)."""
        m = self.model_size
        return m if n % m == 0 else 1

    # -- collectives (identity when every axis is absent) ----------------
    def psum_many(self, x: torch.Tensor, names: Sequence[Optional[str]]
                  ) -> torch.Tensor:
        """Sum over the axes ``names`` in one collective; the output is
        replicated over them, so the backward is the identity."""
        real = _real(names)
        if not real:
            return x
        return _Sum.apply(x, self.mesh.group(real))

    def psum(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return self.psum_many(x, (name,))

    psum_rep = psum  # the reference's name where the sum feeds the loss

    def pmean(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        """Mean over ``name``, replicated (loss and metric averaging)."""
        if name is None:
            return x
        return self.psum(x, name) / self.size(name)

    def pmax_many(self, x: torch.Tensor, names: Sequence[Optional[str]]
                  ) -> torch.Tensor:
        real = _real(names)
        if not real:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                "Axes.pmax has no backward: take it on a value held "
                "constant under differentiation (detached), as the "
                "reference does")
        return _all_reduce("pmax", x, self.mesh.group(real),
                           dist.ReduceOp.MAX)

    def pmax(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return self.pmax_many(x, (name,))

    def enter(self, x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
        """``x``, replicated over ``names``, as consumed by compute that
        differs from rank to rank over them: the identity, whose backward
        sums the ranks' partial gradients over ``names`` (the reference's
        ``pvary_entry``)."""
        real = _real(names)
        if not real:
            return x
        return _Enter.apply(x, self.mesh.group(real))

    def all_gather(self, x: torch.Tensor, name: Optional[str], *,
                   axis: int = 0) -> torch.Tensor:
        """Tiled all-gather: the ranks' blocks concatenated along ``axis``
        in the order of their coordinate on ``name``. Backward: the
        gradient summed over ``name`` and cut to this rank's block."""
        if name is None:
            return x
        return _Gather.apply(x, self.mesh.group((name,)), self.size(name),
                             axis)

    def psum_scatter(self, x: torch.Tensor, name: Optional[str], *,
                     axis: int = 0) -> torch.Tensor:
        """The sum over ``name``, cut along ``axis`` into the ranks'
        blocks in coordinate order: this rank's block (tiled). Backward:
        the tiled all-gather."""
        if name is None:
            return x
        return _Scatter.apply(x, self.mesh.group((name,)), self.size(name),
                              axis)

    # -- framework conventions -------------------------------------------
    def fsdp_gather(self, w: torch.Tensor, dim: Optional[int]
                    ) -> torch.Tensor:
        """Gather a parameter's FSDP-sharded ``dim`` (ZeRO-3 unshard);
        the identity for a leaf that is not FSDP-sharded."""
        return w if dim is None else self.all_gather(w, self.data, axis=dim)

    def dp_mean_grads(self, grads):
        """The gradients' mean over the pod axis (pure data parallelism;
        ``grads`` a list of tensors)."""
        if self.pod is None:
            return grads
        return [self.pmean(g, self.pod) for g in grads]


SINGLE = Axes()  # un-sharded execution: every collective is the identity
