"""Carry reference engine state into the port.

This system has no weights: its learned state is the tier-1
``StoreState`` — cache tags / valid / dirty / freq / ts, the online
learner's weights, prediction rings and counters, the prefetch buffer and
stream identifier, the step counter ``t`` and the PRNG key (two uint32
words). The reference keeps it as a JAX pytree; flattened to numpy
(``[np.asarray(x) for x in jax.tree_util.tree_leaves(state)]``), it comes
across here, on any device, as the port's :class:`StoreState` — so a run
can resume in the port where the reference left off.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.online_learning import OLState
from repro_torch.core.prefetch import PrefetchState
from repro_torch.storage.cache_state import CacheState
from repro_torch.storage.tiered_store import StoreHyper, StoreState

__all__ = ["store_state_from_numpy", "store_hyper_from_numpy"]

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
