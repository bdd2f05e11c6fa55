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

No collective here has a backward. Each refuses inputs that require
grad, as the kernels' dispatchers do: ``all_reduce`` under autograd would
give the transpose semantics of pre-vma JAX without a word (the
reference's ``psum`` against ``psum_rep`` against ``pvary_entry``). Those
semantics are the sharded training slice's work. The reference's
``pvary_*`` helpers and ``vma_of`` type values for ``shard_map``'s
replication check, which has no counterpart here: they are not ported.

Transport. The mesh's backend is NCCL where each rank has a card of its
own, else gloo (ranks that share a card, or run on the CPU;
:func:`repro_torch.launch.mesh.backend_for`). Gloo takes CUDA tensors for
``all_reduce`` (sum and max; f32, bf16, int32, int64) and ``all_gather``
in torch 2.11 on an H100 (PERF.md §6) and stages them through
host memory itself, so the tensors go to the collective as they are; the
rank's compute stays on its card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import refuse_autograd

__all__ = ["Axes", "SINGLE", "collective_stats", "reset_collective_stats",
           "time_collectives"]

# Collectives issued, bytes each rank sent into them and (when timed)
# seconds spent in them, by kind.
_STATS: dict = {}
_TIMED = [False]


def collective_stats() -> dict:
    """``{kind: (calls, bytes, seconds)}`` of this process's collectives
    since the last reset (``bytes``: the local tensors'; ``seconds``: 0
    unless :func:`time_collectives` is on)."""
    return dict(_STATS)


def reset_collective_stats() -> None:
    _STATS.clear()


def time_collectives(on: bool) -> None:
    """Time each collective on CUDA tensors, from a synchronized card to
    its result on the card (the card synchronizes before and after each,
    which the untimed path does not do)."""
    _TIMED[0] = on


def _collective(kind: str, x: torch.Tensor, run):
    """Run the collective ``run`` on ``x`` (returning the result) and count
    it."""
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
    return out


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
    def _reduce(self, x: torch.Tensor, names: Sequence[Optional[str]], op,
                kind: str) -> torch.Tensor:
        real = tuple(n for n in names if n is not None)
        if not real:
            return x
        refuse_autograd(f"Axes.{kind}", x)
        group = self.mesh.group(real)

        def run(t):
            t = t.contiguous().clone()
            dist.all_reduce(t, op=op, group=group)
            return t
        return _collective(kind, x, run)

    def psum(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return self._reduce(x, (name,), dist.ReduceOp.SUM, "psum")

    def pmax(self, x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return self._reduce(x, (name,), dist.ReduceOp.MAX, "pmax")

    def psum_many(self, x: torch.Tensor, names: Sequence[Optional[str]]
                  ) -> torch.Tensor:
        return self._reduce(x, names, dist.ReduceOp.SUM, "psum")

    def pmax_many(self, x: torch.Tensor, names: Sequence[Optional[str]]
                  ) -> torch.Tensor:
        return self._reduce(x, names, dist.ReduceOp.MAX, "pmax")

    def all_gather(self, x: torch.Tensor, name: Optional[str], *,
                   axis: int = 0) -> torch.Tensor:
        """Tiled all-gather: the ranks' blocks concatenated along ``axis``
        in the order of their coordinate on ``name``."""
        if name is None:
            return x
        refuse_autograd("Axes.all_gather", x)
        group = self.mesh.group((name,))
        n = self.size(name)

        def run(t):
            t = t.contiguous()
            out = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(out, t, group=group)
            return torch.cat(out, dim=axis)
        return _collective("all_gather", x, run)

    def fsdp_gather(self, w: torch.Tensor, dim: Optional[int]
                    ) -> torch.Tensor:
        """Gather a parameter's FSDP-sharded ``dim`` (ZeRO-3 unshard);
        the identity for a leaf that is not FSDP-sharded."""
        return w if dim is None else self.all_gather(w, self.data, axis=dim)


SINGLE = Axes()  # un-sharded execution: every collective is the identity
