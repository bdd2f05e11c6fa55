"""IO request prefetcher state (paper §III, §II).

The stream identifier (constant strides computed from differences between
miss addresses) feeds a prefetch buffer that misses probe before going to
tier 2. Its per-request logic lives in the fused request step
(:func:`repro_torch.kernels.ref.fused_cache_step` and the CUDA kernel);
this module holds its state. The Markov-chain prefetcher is not ported
yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PrefetchState", "init_prefetch"]


class PrefetchState(NamedTuple):
    """Prefetch buffer + stream-identifier state."""

    ptags: torch.Tensor      # int32[..., P] page ids in the buffer (-1 empty)
    pvalid: torch.Tensor     # bool[..., P]
    last_miss: torch.Tensor  # int32[...] previous miss page
    stride: torch.Tensor     # int32[...] current candidate stride
    conf: torch.Tensor       # int32[...] consecutive confirmations of stride
    issued: torch.Tensor     # int32[...] total prefetches issued (stat)
    useful: torch.Tensor     # int32[...] prefetch-buffer hits (stat)


def init_prefetch(buf_size: int, *, device=None) -> PrefetchState:
    i32 = dict(dtype=torch.int32, device=device)
    return PrefetchState(
        ptags=torch.full((buf_size,), -1, **i32),
        pvalid=torch.zeros(buf_size, dtype=torch.bool, device=device),
        last_miss=torch.full((), -1, **i32),
        stride=torch.zeros((), **i32),
        conf=torch.zeros((), **i32),
        issued=torch.zeros((), **i32),
        useful=torch.zeros((), **i32),
    )
