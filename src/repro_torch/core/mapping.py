"""Page -> shard mapping policies (paper §III), host-side.

The paper distributes pages across MPI processes with round-robin, random,
block and block-cyclic policies; the policy is chosen from the correlation
structure of the workload ("random mapping will provide good load balance
... block mapping will minimize inter process communication for exclusively
accessed pages").

Mapping is data preparation for the tier-1 engine: the owner array is
computed on the host in numpy and the engine only ever sees per-shard
streams. Page ids are int32 (the engine's width); every policy returns the
same integers as the reference's int32/uint32 arithmetic, with the uint32
hash done in int64 and masked to 32 bits.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["page_to_shard", "MAPPING_POLICIES", "shard_load",
           "apply_failover"]

# Knuth multiplicative hash constant (fits in uint32).
_HASH_MULT = 2654435761
_MASK32 = 0xFFFFFFFF


def _as_int32(page) -> np.ndarray:
    return np.asarray(page).astype(np.int32).astype(np.int64)


def _round_robin(page, n_shards: int, n_pages: int) -> np.ndarray:
    del n_pages
    return (_as_int32(page) % n_shards).astype(np.int32)


def _random(page, n_shards: int, n_pages: int) -> np.ndarray:
    del n_pages
    h = (((_as_int32(page) & _MASK32) * _HASH_MULT) & _MASK32) >> 16
    return (h % n_shards).astype(np.int32)


def _block(page, n_shards: int, n_pages: int) -> np.ndarray:
    block = -(-n_pages // n_shards)  # ceil
    return np.clip(_as_int32(page) // block, 0, n_shards - 1).astype(np.int32)


def _block_cyclic(page, n_shards: int, n_pages: int,
                  block: int = 8) -> np.ndarray:
    del n_pages
    return ((_as_int32(page) // block) % n_shards).astype(np.int32)


MAPPING_POLICIES: dict[str, Callable[..., np.ndarray]] = {
    "round_robin": _round_robin,
    "random": _random,
    "block": _block,
    "block_cyclic": _block_cyclic,
}


def page_to_shard(
    page,
    n_shards: int,
    n_pages: int,
    policy: str = "block",
    **kw,
) -> np.ndarray:
    """Map page numbers to owning shard ids under ``policy``.

    ``page`` may be any int array; returns int32 of the same shape.
    """
    try:
        fn = MAPPING_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown mapping policy {policy!r}; options: {sorted(MAPPING_POLICIES)}"
        ) from None
    return fn(page, n_shards, n_pages, **kw)


def apply_failover(
    owner: np.ndarray,
    times: np.ndarray,
    down_intervals,
    n_shards: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Reroute requests owned by down shards to surviving shards.

    ``owner[i]`` is request i's home shard (from :func:`page_to_shard`),
    ``times[i]`` its wall-clock arrival, and ``down_intervals`` a sequence
    of ``(shard, t0, t1)`` outages (:meth:`FaultSpec.down_intervals`). A
    request whose home shard is down at its arrival time fails over to the
    nearest *alive* shard by cyclic rotation ``(home + offset) % n_shards``
    — deterministic, so the same key range lands on the same survivor
    (the survivor absorbs the failed shard's working set, evicting its
    own). If every shard is down at that instant the request keeps its
    home (it will queue against a dead device).

    Returns ``(new_owner, remapped)`` — int32 owners and the bool mask of
    rerouted requests.
    """
    owner = np.asarray(owner)
    times = np.asarray(times, float)
    if owner.shape != times.shape:
        raise ValueError("owner and times must have matching shapes")
    down = np.zeros((n_shards, owner.shape[0]), dtype=bool)
    for shard, t0, t1 in down_intervals:
        if not 0 <= shard < n_shards:
            raise ValueError(f"down shard {shard} out of range "
                             f"[0, {n_shards})")
        down[shard] |= (times >= t0) & (times < t1)
    new_owner = owner.astype(np.int32).copy()
    needy = down[owner, np.arange(owner.shape[0])]
    # Rotate each needy request through the ring until it finds an alive
    # shard; n_shards - 1 hops always suffice when any survivor exists.
    unresolved = needy.copy()
    for offset in range(1, n_shards):
        if not unresolved.any():
            break
        cand = (owner + offset) % n_shards
        take = unresolved & ~down[cand, np.arange(owner.shape[0])]
        new_owner[take] = cand[take]
        unresolved &= ~take
    # Fully-down instants keep their home shard (nothing alive to take
    # the traffic); they do not count as remapped.
    remapped = needy & ~unresolved
    return new_owner, remapped


def shard_load(pages, n_shards: int, n_pages: int, policy: str,
               **kw) -> np.ndarray:
    """Request count per shard for a page stream — the load-balance metric the
    paper uses to choose between policies (§III)."""
    owner = page_to_shard(pages, n_shards, n_pages, policy, **kw)
    return np.bincount(owner, minlength=n_shards)
