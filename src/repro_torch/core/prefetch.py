"""IO request prefetcher state (paper §III, §II).

The stream identifier (constant strides computed from differences between
miss addresses) feeds a prefetch buffer that misses probe before going to
tier 2. Its per-request logic lives in the fused request step
(:func:`repro_torch.kernels.ref.fused_cache_step` and the CUDA kernel);
this module holds its state.

The Markov-chain prefetcher (first order, hashed state table, §II [12],
[40]) is plain PyTorch on int32 tensors, as the reference is plain
``jnp``: :func:`markov_observe` records a transition, :func:`markov_predict`
ranks a state's successors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PrefetchState", "init_prefetch", "MarkovState", "init_markov",
           "markov_observe", "markov_predict"]


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


# ---------------------------------------------------------------------------
# Markov-chain prefetcher (first order, hashed state table) — §II [12], [40].
# ---------------------------------------------------------------------------


class MarkovState(NamedTuple):
    succ: torch.Tensor   # int32[S, K] successor pages per hashed state
    count: torch.Tensor  # int32[S, K] transition counts
    prev: torch.Tensor   # int32[] previous page (-1 at start)


_GOLDEN = 2654435761  # Knuth's multiplicative hash constant
_U32 = 0xFFFFFFFF


def _hash_state(page: torch.Tensor, n_states: int) -> int:
    """The reference's uint32 hash, in int64: the page as uint32 (so -1 is
    0xFFFFFFFF), times the constant modulo 2^32, then ``>> 8`` and
    ``% n_states``."""
    h = ((int(page) & _U32) * _GOLDEN) & _U32
    return (h >> 8) % n_states


def init_markov(n_states: int = 256, k: int = 4, *, device=None
                ) -> MarkovState:
    i32 = dict(dtype=torch.int32, device=device)
    return MarkovState(
        succ=torch.full((n_states, k), -1, **i32),
        count=torch.zeros((n_states, k), **i32),
        prev=torch.full((), -1, **i32),
    )


def markov_observe(mk: MarkovState, page) -> MarkovState:
    """Record transition prev -> page in the hashed table (LFU slot steal):
    the successor's slot if it is there, else the first slot of the least
    count. Nothing is recorded before the first page (``prev = -1``)."""
    page = torch.as_tensor(page, dtype=torch.int32, device=mk.succ.device)
    succ, count = mk.succ, mk.count
    if int(mk.prev) >= 0:
        s = _hash_state(mk.prev, succ.shape[0])
        match = succ[s] == page
        found = bool(match.any())
        slot = int(match.to(torch.int32).argmax() if found
                   else count[s].argmin())
        succ, count = succ.clone(), count.clone()
        succ[s, slot] = page
        count[s, slot] = count[s, slot] + 1 if found else 1
    return MarkovState(succ=succ, count=count, prev=page.reshape(()))


def markov_predict(mk: MarkovState, page, top: int = 2) -> torch.Tensor:
    """Most probable next pages from the current state (int32[top], -1
    pad); equal counts keep slot order (a stable sort)."""
    s = _hash_state(page, mk.succ.shape[0])
    row_succ, row_cnt = mk.succ[s], mk.count[s]
    order = torch.argsort(-row_cnt, stable=True)
    cand = row_succ[order][:top]
    cnt = row_cnt[order][:top]
    return torch.where(cnt > 0, cand, torch.full_like(cand, -1))
