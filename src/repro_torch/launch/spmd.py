"""Per-rank training and serving steps over a mesh of ranks (the
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

Training: :func:`build_train_step` returns this rank's step
(:func:`repro_torch.training.train_step.make_train_step` under the
mesh's axes), which takes this rank's block of a ``TrainState``
(:func:`shard_state`: every leaf cut as :func:`state_pspecs` says, the
moments and the error feedback as their parameters, ``step`` whole) and
its rows of the batch (:func:`train_batch_for_rank`, split over ``("pod",
"data")`` as :func:`batch_pspec` says). :func:`gather_state` puts the
blocks back together. :func:`state_structs` and :func:`batch_structs`
are the dry run's stand-ins for a rank's block of the state and for a
batch: empty tensors on ``meta``, no allocation
(:mod:`repro_torch.launch.dryrun`). A checkpoint of a sharded state is written in the
global view, the one-card format (:func:`save_sharded_checkpoint`: each
leaf gathered, rank 0 writes it), so it restores onto any mesh or onto
one card: :func:`restore_sharded_checkpoint` reads the global tree and
cuts this rank's block, as the reference's elastic restore re-shards.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, axes_for_mesh
from repro_torch.models import params as pm
from repro_torch.serving.engine import (ServeConfig, make_decode_step,
                                        make_kv_spec, make_prefill_step,
                                        page_shard_index, page_shards)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import (TrainHyper, TrainState,
                                             make_train_step)

__all__ = ["mesh_sizes", "batch_axes", "ServeSpecs", "build_serve",
           "shard_for_rank", "local_batch", "batch_pspec", "state_pspecs",
           "build_train_step", "shard_state", "gather_state",
           "batch_structs", "param_block_structs", "state_structs",
           "train_batch_for_rank", "save_sharded_checkpoint",
           "restore_sharded_checkpoint"]


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


def _train_batch_axes(mesh: Mesh) -> tuple:
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def batch_pspec(cfg: ModelConfig, mesh: Mesh) -> dict:
    """Each batch key's partition: the rows split over ``("pod",
    "data")``, everything else whole (a tuple a key, as
    :func:`~repro_torch.models.params.param_pspecs` spells them)."""
    b = _train_batch_axes(mesh) or None
    keys = ["tokens", "labels"]
    if cfg.vlm_prefix:
        keys.append("prefix_embeds")
    if cfg.enc_dec:
        keys.append("frames")
    return {k: (b,) for k in keys}


def state_pspecs(cfg: ModelConfig, mesh: Mesh) -> TrainState:
    """The partition of every leaf of a ``TrainState``: the moments and
    the error feedback as their parameters, ``step`` whole."""
    names = mesh.axis_names
    pspec = pm.param_pspecs(
        cfg, mesh_sizes(mesh),
        data_axis="data" if "data" in names else None,
        model_axis="model" if "model" in names else None)
    return TrainState(params=pspec,
                      opt=AdamWState(step=(), mu=pspec, nu=pspec),
                      err_fb=pspec)


def batch_structs(cfg: ModelConfig, *, global_batch: int, seq_len: int
                  ) -> dict:
    """Empty stand-ins on ``meta`` for a training batch of
    ``global_batch`` sequences of ``seq_len`` positions (the reference's
    ``ShapeDtypeStruct`` s): int32 tokens and labels of the text after a
    VLM's prefix, and bf16 ``prefix_embeds`` / whisper's ``frames``."""
    s_txt = seq_len - cfg.vlm_prefix

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = {"tokens": empty((global_batch, s_txt), torch.int32),
           "labels": empty((global_batch, s_txt), torch.int32)}
    if cfg.vlm_prefix:
        out["prefix_embeds"] = empty(
            (global_batch, cfg.vlm_prefix, cfg.d_model), torch.bfloat16)
    if cfg.enc_dec:
        out["frames"] = empty((global_batch, cfg.enc_seq, cfg.d_model),
                              torch.bfloat16)
    return out


def param_block_structs(cfg: ModelConfig, mesh: Mesh, dtype=None
                        ) -> dict:
    """Empty stand-ins on ``meta`` for this rank's block of the
    parameters (each leaf cut as :func:`state_pspecs` says), in ``dtype``
    (``cfg.param_dtype`` by default)."""
    sizes = mesh.sizes()
    dtype = dtype or getattr(torch, cfg.param_dtype)

    def block(w, spec):
        shape = [n // sizes[a] if a is not None else n
                 for n, a in zip(w.shape, spec)]
        return torch.empty(shape, dtype=dtype, device="meta")
    return pm.zip_map(block, pm.param_structs(cfg, mesh_sizes(mesh)),
                      state_pspecs(cfg, mesh).params)


def state_structs(cfg: ModelConfig, mesh: Mesh) -> TrainState:
    """Empty stand-ins on ``meta`` for this rank's block of a
    ``TrainState``: the parameters in ``cfg.param_dtype``, the moments in
    ``cfg.opt_state_dtype``, the error feedback in f32 and ``step`` an
    int32 scalar, as the reference's dry run types them."""
    opt = getattr(torch, cfg.opt_state_dtype)
    return TrainState(
        params=param_block_structs(cfg, mesh),
        opt=AdamWState(step=torch.empty((), dtype=torch.int32,
                                        device="meta"),
                       mu=param_block_structs(cfg, mesh, opt),
                       nu=param_block_structs(cfg, mesh, opt)),
        err_fb=param_block_structs(cfg, mesh, torch.float32))


def build_train_step(cfg: ModelConfig, mesh: Mesh,
                     hyper: TrainHyper = TrainHyper()):
    """This rank's ``(step, state_specs, batch_specs)``: ``step(state,
    batch) -> (state, metrics)`` takes this rank's block of the state
    (:func:`shard_state`) and its rows of the batch
    (:func:`train_batch_for_rank`), updates the block in place, and
    returns the reference's four metrics, equal on every rank."""
    if mesh is None:
        raise ValueError(
            "build_train_step builds a rank's step on a mesh of several "
            "cards (launch.mesh.make_mesh); on one card use "
            "training.train_step.make_train_step")
    step = make_train_step(cfg, axes_for_mesh(mesh), mesh_sizes(mesh),
                           hyper)
    return step, state_pspecs(cfg, mesh), batch_pspec(cfg, mesh)


def _map_state(fn: Callable, state: TrainState, specs: TrainState
               ) -> TrainState:
    """``fn(leaf, spec)`` over a ``TrainState`` and its specs."""
    def tree(a, b):
        return pm.zip_map(fn, a, b)
    return TrainState(
        params=tree(state.params, specs.params),
        opt=AdamWState(step=fn(state.opt.step, specs.opt.step),
                       mu=tree(state.opt.mu, specs.opt.mu),
                       nu=tree(state.opt.nu, specs.opt.nu)),
        err_fb=tree(state.err_fb, specs.err_fb))


def shard_state(state: TrainState, cfg: ModelConfig, mesh: Mesh
                ) -> TrainState:
    """This rank's block of a full ``TrainState``, each leaf a copy of its
    own (the step updates it in place)."""
    sizes, coords = mesh.sizes(), mesh.coords()
    return _map_state(
        lambda w, spec: pm.shard_leaf(w, spec, sizes, coords).clone(),
        state, state_pspecs(cfg, mesh))


def _gather_leaf(ax, w: torch.Tensor, spec: tuple) -> torch.Tensor:
    with torch.no_grad():
        for dim, name in enumerate(spec):
            if name is not None:
                w = ax.all_gather(w, name, axis=dim)
    return w


def gather_state(state: TrainState, cfg: ModelConfig, mesh: Mesh
                 ) -> TrainState:
    """The full ``TrainState`` from the ranks' blocks, on every rank (a
    collective: every rank calls it)."""
    ax = axes_for_mesh(mesh)
    return _map_state(lambda w, spec: _gather_leaf(ax, w, spec), state,
                      state_pspecs(cfg, mesh))


def train_batch_for_rank(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global training batch (every key split along
    its first dim over ``("pod", "data")``)."""
    idx, n = _batch_shard(mesh, _train_batch_axes(mesh))

    def rows(x):
        x = torch.as_tensor(x)
        k = x.shape[0] // n
        return x[idx * k:(idx + 1) * k]
    return {k: rows(v) for k, v in batch.items()}


def save_sharded_checkpoint(state: TrainState, step: int,
                            cc: "ckpt.CheckpointConfig", cfg: ModelConfig,
                            mesh: Mesh) -> list:
    """Save a sharded ``TrainState`` in the global view on the tiers'
    cadence: each leaf gathered from the ranks' blocks as it is written,
    rank 0 writing. Every rank calls it; it returns once the snapshot is
    published, with the paths written."""
    ax = axes_for_mesh(mesh)
    lazy = _map_state(lambda w, spec: (lambda: _gather_leaf(ax, w, spec)),
                      state, state_pspecs(cfg, mesh))
    out = ckpt.save_checkpoint(lazy, step, cc, write=mesh.rank == 0)
    dist.barrier()
    return out


def restore_sharded_checkpoint(like: TrainState, cc: "ckpt.CheckpointConfig",
                               cfg: ModelConfig, mesh: Mesh
                               ) -> tuple[Any, int]:
    """The newest valid checkpoint (global view, from any mesh or one
    card), cut to this rank's block: ``(state, step)``. ``like`` is a
    state of this rank's (its tree and its device)."""
    full, step = ckpt.restore_checkpoint(like, cc)
    return shard_state(full, cfg, mesh), step
