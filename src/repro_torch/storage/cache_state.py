"""Tier-1 cache state (paper §III).

Each cache line carries ``index, tag, valid and dirty bits`` plus the
``frequency counter and timestamp fields`` used by the eviction experts.
The cache is demand-driven, fully-associative, write-back, single-copy
(no replication => no coherency protocol), exactly as in the paper.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CacheState", "init_cache"]


class CacheState(NamedTuple):
    """Fully-associative tier-1 cache metadata (one shard, or ``[B, N]``
    for a batch of shards)."""

    tags: torch.Tensor   # int32[..., N] page number per line; -1 = empty
    valid: torch.Tensor  # bool[..., N]
    dirty: torch.Tensor  # bool[..., N]
    freq: torch.Tensor   # int32[..., N]  LFU frequency counter
    ts: torch.Tensor     # int32[..., N]  LRU last-access timestamp

    @property
    def n_lines(self) -> int:
        return self.tags.shape[-1]


def init_cache(n_lines: int, *, device=None) -> CacheState:
    i32 = dict(dtype=torch.int32, device=device)
    return CacheState(
        tags=torch.full((n_lines,), -1, **i32),
        valid=torch.zeros(n_lines, dtype=torch.bool, device=device),
        dirty=torch.zeros(n_lines, dtype=torch.bool, device=device),
        freq=torch.zeros(n_lines, **i32),
        ts=torch.zeros(n_lines, **i32),
    )
