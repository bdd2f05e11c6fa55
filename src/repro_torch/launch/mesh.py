"""Meshes of ranks, and the runner that starts a rank per process.

The reference builds a ``jax.sharding.Mesh`` over devices and runs each
step body under ``shard_map``. The port runs one process per rank
(:func:`spawn_ranks`), and :func:`make_mesh`, called on every rank, lays
the ranks out row-major over the mesh's shape and creates one process
group for every non-empty set of its axes, in the same order on every
rank: a collective over several axes is then one collective over the
group that spans them. :func:`axes_for_mesh` is the reference's: the
:class:`~repro_torch.distributed.axes.Axes` whose axis names are those of
the mesh.

:func:`spawn_ranks` is the counterpart of XLA's forced host devices: it
starts N ranks with ``torch.multiprocessing`` (spawn), meeting through a
``file://`` store in a fresh temporary directory, so no TCP port is
chosen and concurrent runs cannot collide. Gloo's own connections between
the ranks stay on the loopback device. Each rank resolves its device
through :func:`repro_torch.device.resolve_device`: ``cuda:(rank %
device_count)`` unless the caller asks for the CPU. One rule chooses the
backend (:func:`backend_for`): NCCL where every rank has a card of its
own, gloo where ranks share a card or run on the CPU. Nothing retries
another backend after a failure.

:func:`make_production_mesh` is the reference's production topology: 16
× 16 ranks over ``("data", "model")``, or 2 × 16 × 16 over ``("pod",
"data", "model")``, through :func:`make_mesh` in an initialized group of
256 or 512 ranks. The dry run (:mod:`repro_torch.launch.dryrun`) builds
it in one process over a fake process group, whose collectives move
nothing.
"""
from __future__ import annotations

import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.axes import Axes

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "axes_for_mesh",
           "backend_for", "rank_device", "spawn_ranks"]

# A rank that waits longer than this in a collective fails.
TIMEOUT_S = 600


class Mesh:
    """This rank's place in a mesh of ranks: the shape over the axis
    names, its coordinate on each axis, and a process group for every
    non-empty set of axes (a set spanning every axis uses the world
    group)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, groups: dict, backend: str):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.backend = backend
        self._sizes = dict(zip(self.axis_names, self.shape))
        self._coords = dict(zip(self.axis_names,
                                (int(c) for c in np.unravel_index(
                                    rank, self.shape))))
        self._groups = groups

    def sizes(self) -> dict:
        return dict(self._sizes)

    def size(self, name: str) -> int:
        return self._sizes[name]

    def coord(self, name: str) -> int:
        return self._coords[name]

    def coords(self) -> dict:
        return dict(self._coords)

    def group(self, names: Sequence[str]):
        """The process group spanning ``names`` that holds this rank."""
        key = tuple(n for n in self.axis_names if n in names)
        if len(key) != len(set(names)):
            raise ValueError(f"axes {names!r} not all in {self.axis_names}")
        return self._groups[key]


def _subsets(axis_names: Sequence[str]):
    for r in range(1, len(axis_names) + 1):
        yield from itertools.combinations(axis_names, r)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh of ``shape`` over ``axes`` for this rank, in an initialized
    process group of ``prod(shape)`` ranks. Every rank must call it, in
    the same order as its other group creations."""
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, "
                         f"the process group has {world}")
    ranks = np.arange(world).reshape(shape)
    groups = {}
    for sub in _subsets(axes):
        if len(sub) == len(axes):
            groups[sub] = dist.group.WORLD
            continue
        keep = [axes.index(a) for a in sub]
        rest = [i for i in range(len(axes)) if i not in keep]
        lists = np.transpose(ranks, rest + keep).reshape(
            -1, int(np.prod([shape[i] for i in keep]))).tolist()
        groups[sub], _ = dist.new_subgroups_by_enumeration(lists)
    return Mesh(shape, axes, dist.get_rank(), groups, dist.get_backend())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh for this rank: 16 × 16 over ``("data",
    "model")``, or 2 × 16 × 16 over ``("pod", "data", "model")`` (the
    ``"pod"`` axis pure data parallelism), in an initialized group of 256
    or 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def axes_for_mesh(mesh: Mesh) -> Axes:
    """The Axes context matching a mesh's axis names."""
    names = mesh.axis_names
    return Axes(data="data" if "data" in names else None,
                model="model" if "model" in names else None,
                pod="pod" if "pod" in names else None, mesh=mesh)


def backend_for(device: torch.device, n_ranks: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """The rank's device: ``cuda:(rank % device_count)`` for ``None`` or
    ``"cuda"``, else ``device`` as given (``"cpu"``)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, fn: Callable, n: int, store: str, out_dir: str,
               device, threads: Optional[int], args: tuple) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, n)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **({"device_id": dev} if backend == "nccl" else {}))
    try:
        out = fn(rank, dev, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, args: tuple = (), *, device=None,
                threads: Optional[int] = None) -> list:
    """Run ``fn(rank, device, *args)`` on ``n`` ranks, one process each,
    in an initialized process group, and return their results in rank
    order (each must pickle; tensors are best returned on the CPU).
    ``device`` is as :func:`rank_device` takes it; ``threads`` caps each
    rank's CPU threads. ``fn`` must be importable by name (a module's
    top-level function). A rank that raises stops the run: the others
    are terminated and the first traceback is raised here."""
    tmp = tempfile.mkdtemp(prefix="ranks-")
    try:
        store = os.path.join(tmp, "store")
        try:
            mp.start_processes(_rank_main, nprocs=n, join=True,
                               start_method="spawn",
                               args=(fn, n, store, tmp, device, threads,
                                     tuple(args)))
        except Exception as e:
            errs = sorted(f for f in os.listdir(tmp) if f.endswith(".err"))
            if errs:
                with open(os.path.join(tmp, errs[0])) as f:
                    raise RuntimeError(
                        f"{errs[0][:-4]} failed:\n{f.read()}") from e
            raise
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
