"""Carry reference state into the port: engine state and model parameters.

This system has no weights: its learned state is the tier-1
``StoreState`` — cache tags / valid / dirty / freq / ts, the online
learner's weights, prediction rings and counters, the prefetch buffer and
stream identifier, the step counter ``t`` and the PRNG key (two uint32
words). The reference keeps it as a JAX pytree; flattened to numpy
(``[np.asarray(x) for x in jax.tree_util.tree_leaves(state)]``), it comes
across here, on any device, as the port's :class:`StoreState` — so a run
can resume in the port where the reference left off.

A chunked replay begun in the reference resumes in the port through
:func:`stream_checkpoint_from_numpy`, which carries the reference's
``StreamCheckpoint`` (its carry a numpy ``(StoreState, _Accum)`` tree)
across as the port's.

A served model's parameters come across with :func:`params_from_numpy`,
so that the port and the reference compute the same model, and a
training run's whole ``TrainState`` (parameters, AdamW moments and step,
error feedback) with :func:`train_state_from_numpy`, so that a run begun
in the reference resumes in the port. A serve's paged KV state (the pools
and their int8 scales, the page tables, the §III metadata, the learner,
the key and the read counters) comes across with
:func:`paged_kv_from_numpy`, so that the port's decode can start from the
reference's prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.online_learning import OLState
from repro_torch.core.prefetch import PrefetchState
from repro_torch.core.traffic import TenantSpec, TrafficSpec
from repro_torch.storage.cache_state import CacheState
from repro_torch.storage.tiered_store import (
    Accum, StoreConfig, StoreHyper, StoreState, tree_map)

__all__ = ["store_state_from_numpy", "store_hyper_from_numpy",
           "stream_checkpoint_from_numpy", "params_from_numpy",
           "train_state_from_numpy", "paged_kv_from_numpy"]

_GROUPS = ((CacheState, (torch.int32, torch.bool, torch.bool, torch.int32,
                         torch.int32)),
           (OLState, (torch.float32,) + (torch.int32,) * 5),
           (PrefetchState, (torch.int32, torch.bool) + (torch.int32,) * 5))
_N_LEAVES = sum(len(d) for _, d in _GROUPS) + 2


def store_state_from_numpy(leaves: Sequence[np.ndarray], *,
                           device=None) -> StoreState:
    """A :class:`StoreState` from the reference state's leaves in pytree
    order: cache (tags, valid, dirty, freq, ts), learner (weights, pred,
    pred_n, mispred, epoch_misses, chosen), prefetcher (ptags, pvalid,
    last_miss, stride, conf, issued, useful), ``t``, ``key``. Leading
    (row) axes carry over. The key's uint32 words become int64."""
    leaves = list(leaves)
    if len(leaves) != _N_LEAVES:
        raise ValueError(f"expected {_N_LEAVES} StoreState leaves, got "
                         f"{len(leaves)}")
    parts, i = [], 0
    for cls, dtypes in _GROUPS:
        parts.append(cls(*(
            torch.tensor(np.asarray(x)).to(device=device, dtype=d)
            for x, d in zip(leaves[i:i + len(dtypes)], dtypes))))
        i += len(dtypes)
    t = torch.tensor(np.asarray(leaves[i], np.int32), device=device)
    key = np.asarray(leaves[i + 1])
    if key.dtype != np.uint32 or key.shape[-1] != 2:
        raise ValueError("the PRNG key must be uint32[..., 2] (a raw "
                         f"threefry key), got {key.dtype}{list(key.shape)}")
    key = torch.as_tensor(key.astype(np.int64), device=device)
    return StoreState(cache=parts[0], ols=parts[1], pf=parts[2], t=t,
                      key=key)


def store_hyper_from_numpy(alpha, beta, threshold, policy_idx, *,
                           device=None) -> StoreHyper:
    """A :class:`StoreHyper` from the reference's four knob arrays."""
    f32 = dict(dtype=torch.float32, device=device)
    return StoreHyper(
        alpha=torch.tensor(np.asarray(alpha, np.float32), **f32),
        beta=torch.tensor(np.asarray(beta, np.float32), **f32),
        threshold=torch.tensor(np.asarray(threshold, np.float32), **f32),
        policy_idx=torch.tensor(np.asarray(policy_idx, np.int32),
                                   dtype=torch.int32, device=device),
    )


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# The spec classes a reference cache signature holds, by name.
_SPEC_CLASSES = {c.__name__: c for c in (TrafficSpec, TenantSpec,
                                          StoreConfig)}


def _port_value(x):
    """A reference signature value with its spec dataclasses rebuilt as the
    port's classes of the same name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = _SPEC_CLASSES[type(x).__name__]
        return cls(**{f.name: _port_value(getattr(x, f.name))
                      for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_port_value(v) for v in x)
    return x


def stream_checkpoint_from_numpy(ck, *, device=None):
    """The port's :class:`~repro_torch.sim.stream.StreamCheckpoint` from
    the reference's (``repro.sim.stream.StreamCheckpoint``): its carry (a
    numpy ``(StoreState, _Accum)`` tree) becomes the port's ``(StoreState,
    Accum)`` — host numpy leaves, as the port's checkpoints hold them, or
    tensors on ``device`` when one is given — and its cache signature the
    port spec's (the reference's spec classes rebuilt as the port's), so
    ``stream_tier1_counters(spec, checkpoint=...)`` resumes the replay in
    the port where the reference stopped."""
    from repro_torch.sim.stream import StreamCheckpoint
    state_np, acc_np = ck.carry
    state = store_state_from_numpy(_leaves(state_np), device=device)
    acc_leaves = _leaves(acc_np)
    if len(acc_leaves) != len(Accum._fields):
        raise ValueError(f"expected {len(Accum._fields)} accumulator "
                         f"leaves, got {len(acc_leaves)}")
    acc = Accum(*(torch.tensor(np.asarray(x), device=device)
                  for x in acc_leaves))
    carry = (state, acc)
    if device is None:
        carry = tree_map(torch.Tensor.numpy, carry)
    return StreamCheckpoint(
        signature=_port_value(ck.signature),
        offset=int(ck.offset),
        total=int(ck.total),
        counts=np.array(ck.counts, copy=True),
        shard_writes=np.array(ck.shard_writes, copy=True),
        carry=carry,
        n_pages=int(ck.n_pages),
        n_windows=int(ck.n_windows),
        n_tenants=int(ck.n_tenants),
        tenant_state=ck.tenant_state,
        last_tenant=(None if ck.last_tenant is None
                     else np.array(ck.last_tenant, copy=True)),
        fluid_q0=ck.fluid_q0,
    )


def params_from_numpy(tree, *, device=None):
    """The port's parameters from the reference's parameter pytree with
    numpy leaves (``jax.tree.map(np.asarray, params)``): the same nested
    dicts and lists (``blocks`` stacked ``[reps, ...]`` per pattern
    position, ``tail`` unstacked), each leaf a tensor of the leaf's dtype
    on ``device``, holding its own copy of the leaf's bytes."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    # A copy: the port updates parameters in place, and the reference's
    # arrays may be read-only views of its own buffers.
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def train_state_from_numpy(tree, *, device=None):
    """The port's :class:`~repro_torch.training.train_step.TrainState`
    from the reference's with numpy leaves (``jax.tree.map(np.asarray,
    state)``): its parameters, its ``AdamWState`` (the int32 step and the
    moments ``mu`` / ``nu``) and its error feedback, each leaf a tensor of
    the leaf's dtype on ``device``."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import TrainState
    opt = tree.opt
    return TrainState(
        params=params_from_numpy(tree.params, device=device),
        opt=AdamWState(
            step=torch.tensor(np.asarray(opt.step, np.int32), device=device),
            mu=params_from_numpy(opt.mu, device=device),
            nu=params_from_numpy(opt.nu, device=device)),
        err_fb=params_from_numpy(tree.err_fb, device=device))


def paged_kv_from_numpy(kv, *, device=None):
    """The port's :class:`~repro_torch.serving.kvpool.PagedKV` from the
    reference's with numpy leaves (``jax.tree.map(np.asarray, kv)``): the
    pools (int8, bf16 or f32) and the scale pools on ``device`` (``None`` =
    the card), the rest on the host, where the port keeps it. The counters
    the reference does not keep (evictions, write-backs) start at 0."""
    from repro_torch.device import resolve_device
    from repro_torch.serving.kvpool import PagedKV
    device = resolve_device(device)

    def ints(x, dtype=torch.int32):
        return torch.tensor(np.asarray(x)).to(dtype)
    m = kv.meta
    key = np.asarray(kv.key)
    if key.dtype != np.uint32 or key.shape != (2,):
        raise ValueError("the PRNG key must be uint32[2] (a raw threefry "
                         f"key), got {key.dtype}{list(key.shape)}")
    zero = torch.zeros(1, dtype=torch.int32)
    return PagedKV(
        pool1=params_from_numpy(kv.pool1, device=device),
        pool2=params_from_numpy(kv.pool2, device=device),
        scale1=params_from_numpy(kv.scale1, device=device),
        scale2=params_from_numpy(kv.scale2, device=device),
        meta=CacheState(ints(m.tags), ints(m.valid, torch.bool),
                        ints(m.dirty, torch.bool), ints(m.freq),
                        ints(m.ts)),
        page_slot=ints(kv.page_slot), t2_slot=ints(kv.t2_slot),
        ols=OLState(*(torch.tensor(np.asarray(x)).to(d) for x, d in zip(
            kv.ols, _GROUPS[1][1]))),
        lengths=ints(kv.lengths), t=ints(kv.t),
        key=(int(key[0]), int(key[1])),
        t2_reads=ints(kv.t2_reads), t1_reads=ints(kv.t1_reads),
        evictions=zero.clone(), writebacks=zero.clone(),
    )
