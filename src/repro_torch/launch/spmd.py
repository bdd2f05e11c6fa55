"""Per-rank serving steps over a mesh of ranks (the serving half of the
reference's ``launch/spmd.py``).

The reference wraps the serving step bodies in ``shard_map`` over a mesh
and ``jit``: every device sees its shards, and ``PartitionSpec`` s say
how each global array is cut. The port runs one process per rank
(:func:`repro_torch.launch.mesh.spawn_ranks`), and :func:`build_serve`
returns this rank's prefill and decode callables, which take this rank's
shards as plain tensors: its parameter block (:func:`shard_for_rank`),
its rows of the batch (:func:`local_batch`) and its decode state.

- The batch is split over ``("pod", "data")`` minus the page axes; a rank
  serves ``sc.batch_local`` sequences, the same on every rank of a batch
  shard.
- The pages are split over ``sc.page_axes``
  (:mod:`repro_torch.serving.engine`).
- The reference settles the token outputs, equal across the non-batch
  axes, with a ``pvary`` and a ``pmax`` for ``shard_map``'s type check.
  Here they are returned as each rank computed them: they are equal, as
  the tests check, and no collective is spent on them.

``build_train_step``, ``state_pspecs`` and ``batch_pspec`` belong to
sharded training, which waits (ROADMAP.md module item 4):
:func:`build_train_step` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, axes_for_mesh
from repro_torch.models import params as pm
from repro_torch.serving.engine import (ServeConfig, make_decode_step,
                                        make_kv_spec, make_prefill_step,
                                        page_shard_index, page_shards)

__all__ = ["mesh_sizes", "batch_axes", "ServeSpecs", "build_serve",
           "shard_for_rank", "local_batch", "build_train_step"]


def mesh_sizes(mesh: Mesh) -> pm.MeshSizes:
    sizes = mesh.sizes()
    return pm.MeshSizes(data=sizes.get("data", 1),
                        model=sizes.get("model", 1))


def batch_axes(mesh: Mesh, sc: ServeConfig) -> tuple:
    """The mesh axes the batch is split over: pod and data, less the page
    axes."""
    return tuple(n for n in ("pod", "data")
                 if n in mesh.axis_names and n not in sc.page_axes)


class ServeSpecs(NamedTuple):
    batch_axes: tuple
    batch_shard: int        # this rank's index among the batch shards
    n_batch_shards: int
    n_page_shards: int
    page_shard: int         # this rank's index among the page shards
    kv_spec: object         # KVSpec of this rank's pools (None: no pools)


def _batch_shard(mesh: Mesh, names: tuple) -> tuple[int, int]:
    idx, n = 0, 1
    for name in names:
        idx = idx * mesh.size(name) + mesh.coord(name)
        n *= mesh.size(name)
    return idx, n


def build_serve(cfg: ModelConfig, mesh: Mesh, sc: ServeConfig):
    """This rank's ``(prefill, decode, specs)``: ``prefill(params, tokens,
    extras)`` and ``decode(params, state, tokens)`` as
    :mod:`repro_torch.serving.engine` builds them under the mesh's axes,
    and :class:`ServeSpecs`. ``sc.batch_local`` is the global batch over
    the batch shards."""
    ax = axes_for_mesh(mesh)
    ms = mesh_sizes(mesh)
    names = batch_axes(mesh, sc)
    b_idx, b_n = _batch_shard(mesh, names)
    n_pages = page_shards(ax, sc.page_axes)
    needs_kv = any(k.startswith("attn") for k in cfg.layer_kinds())
    specs = ServeSpecs(
        batch_axes=names, batch_shard=b_idx,
        n_batch_shards=b_n, n_page_shards=n_pages,
        page_shard=page_shard_index(ax, sc.page_axes),
        kv_spec=make_kv_spec(cfg, sc, n_pages) if needs_kv else None)
    return (make_prefill_step(cfg, sc, ax, ms),
            make_decode_step(cfg, sc, ax, ms), specs)


def shard_for_rank(params: dict, cfg: ModelConfig, mesh: Mesh) -> dict:
    """This rank's block of a full parameter tree (the reference's
    addressable shard under ``param_pspecs``)."""
    names = mesh.axis_names
    return pm.shard_params(
        params, cfg, mesh_sizes(mesh), mesh.coords(),
        data_axis="data" if "data" in names else None,
        model_axis="model" if "model" in names else None)


def local_batch(x, specs: ServeSpecs):
    """This rank's rows of a global batch ``x [B_global, ...]`` (a tensor
    or a dict of them)."""
    if isinstance(x, dict):
        return {k: local_batch(v, specs) for k, v in x.items()}
    n = x.shape[0] // specs.n_batch_shards
    return x[specs.batch_shard * n:(specs.batch_shard + 1) * n]


def build_train_step(cfg: ModelConfig, mesh: Mesh, hyper=None):
    """Sharded training is not ported yet."""
    raise NotImplementedError(
        "training sharded over several cards is not ported yet (ROADMAP.md "
        "module item 4): the backward semantics of Axes, build_train_step "
        "and the pod axis's compressed_psum wait; train on one card")
