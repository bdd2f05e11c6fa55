"""Paged decode attention as a hand-written CUDA kernel.

Single-token GQA queries attend over the pages of one KV pool reached
through a page table (``csrc/paged_attention.cu``); the result is the
online-softmax partial ``(acc, m, l)``, which the serving engine merges
across the two tiers with :func:`repro_torch.models.attention.
combine_partials`. Replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py:paged_attention``; the plain version is
:func:`repro_torch.kernels.ref.paged_attention_ref`.

Layouts: q ``[B, H, hd]``; pool ``[slots, page, 2, KV, hd]`` with any slot
stride, each slot's ``[page, 2, KV, hd]`` contiguous, so one layer of the
engine's ``[slots, layers, page, 2, KV, hd]`` pools is passed as
``pool[:, li]`` and read in place; ``page_slot [B, n_pages]`` int32
(``-1`` = skip the page); ``lengths [B]`` int32 (token ``t`` is live if
``t < lengths[b]`` and, with a sliding ``window`` > 0, ``t >= lengths[b] -
window``). Output f32 ``acc [B, H, hd]``, ``m [B, H]``, ``l [B,
H]``.

The kernel splits each (sequence, kv head)'s tokens across
``n_split`` blocks (:func:`split_plan`, from the shapes alone) and merges
their partials in the same launch, in split order: one launch a call, the
same result bit for bit from run to run.

Dispatch: :func:`paged_attention` runs the plain version for CPU pools
(and on the card inside :func:`repro_torch.kernels.plain_versions`), the
kernel for CUDA pools; there is no fallback between them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import plain_selected
from repro_torch.kernels.build import CSRC, build_library, check_launch, \
    load_library
from repro_torch.kernels.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_cuda", "split_plan",
           "build_paged_attention", "paged_attention_launch_count",
           "reset_paged_attention_launch_count"]

SOURCE = CSRC / "paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The split aims at TARGET_BLOCKS blocks: 4 of the kernel's 256-thread
# blocks on each of an H100 SXM's 132 SMs.
TARGET_BLOCKS = 4 * 132

_LAUNCHES = [0]
_LIB = [None]
_COUNTERS: dict = {}  # device -> int32 counters, zero between launches


def paged_attention_launch_count() -> int:
    return _LAUNCHES[0]


def reset_paged_attention_launch_count() -> None:
    _LAUNCHES[0] = 0


def build_paged_attention():
    return build_library(SOURCE)


def _library():
    if _LIB[0] is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _LIB[0] = load_library(SOURCE, "paged_attention_launch",
                               [p, p, i, ll, i, p, p, p, p, p, p, p]
                               + [i] * 9 + [p])
        _LIB[0].paged_attention_max_items.restype = i
    return _LIB[0]


def split_plan(B: int, KV: int, n_pages: int, page: int) -> tuple:
    """``(n_split, span)``: the kernel's grid is ``B x KV x n_split`` and
    block ``s`` of a (sequence, kv head) takes its tokens ``[s span, (s +
    1) span)``, a run of ``span / page`` whole pages. From the shapes alone
    (no read of the lengths, no sync with the card): enough splits for
    :data:`TARGET_BLOCKS` blocks, or one page a split where the pages are
    fewer. The splits cover the ``n_pages x page`` tokens exactly once."""
    want = -(-TARGET_BLOCKS // max(B * KV, 1))
    per = max(1, n_pages // max(want, 1))  # pages a split
    return max(1, -(-n_pages // per)), per * page


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _check(q, pool, page_slot, lengths) -> None:
    if q.dim() != 3 or pool.dim() != 5 or pool.shape[2] != 2:
        raise ValueError("q must be [B, H, hd] and pool [slots, page, 2, KV, "
                         f"hd]; got {tuple(q.shape)}, {tuple(pool.shape)}")
    B, H, hd = q.shape
    if pool.shape[4] != hd or H % pool.shape[3]:
        raise ValueError("q and the pool disagree in head dim, or the kv "
                         "heads do not divide the query heads")
    if page_slot.dim() != 2 or page_slot.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("page_slot must be [B, n_pages] and lengths [B]")


def paged_attention_cuda(q: torch.Tensor, pool: torch.Tensor,
                         page_slot: torch.Tensor, lengths: torch.Tensor,
                         window: int = 0):
    """Launch the kernel: pool on the card (f32 or bf16), its slots
    contiguous inside, 16-byte aligned, with a head dim of whole 16-byte
    vectors; q, page_slot and lengths are moved to the pool's device if
    they are not there. Slots at or past ``pool.shape[0]`` are skipped
    like ``-1``.

    The blocks of a (sequence, kv head) count themselves on one int32
    counter of a buffer kept per device (zeroed once; the last block
    resets it), so calls on one device are ordered on its current
    stream: two calls on two streams at once would share counters."""
    _check(q, pool, page_slot, lengths)
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs a CUDA pool, got {dev}")
    if pool.dtype not in _DTYPES:
        raise ValueError(f"pool dtype {pool.dtype} not supported (f32, bf16)")
    if not pool[0].is_contiguous():
        raise ValueError("each pool slot must be contiguous")
    vec = 16 // pool.element_size()  # the kernel's 16-byte loads
    if pool.shape[4] % vec or pool.stride(0) % vec or pool.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte vectors: the head dim and "
                         f"the slot stride must be multiples of {vec} and "
                         f"the pool 16-byte aligned")
    B, H, hd = q.shape
    slots, page, _, KV, _ = pool.shape
    G = H // KV
    lib = _library()
    group = 4 if G >= 8 and G % 4 == 0 else 1  # query heads a warp item
    if G // group * hd // 4 > lib.paged_attention_max_items():
        raise ValueError(f"{G} query heads a kv head at head dim {hd} are "
                         f"more than the kernel's registers hold")
    n_pages = page_slot.shape[1]
    n_split, span = split_plan(B, KV, n_pages, page)
    qf = q.to(device=dev, dtype=torch.float32).contiguous()
    ps = page_slot.to(device=dev, dtype=torch.int32).contiguous()
    ln = lengths.to(device=dev, dtype=torch.int32).contiguous()
    acc = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    part = torch.empty((B, KV, n_split, G, hd + 2) if n_split > 1 else (0,),
                       dtype=torch.float32, device=dev)
    counters = _counters(dev, B * KV)
    err = lib.paged_attention_launch(
        qf.data_ptr(), pool.data_ptr(), _DTYPES[pool.dtype], pool.stride(0),
        slots, ps.data_ptr(), ln.data_ptr(), part.data_ptr(),
        counters.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), B,
        H, KV, hd, page, n_pages, n_split, span, int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, SOURCE, err)
    _LAUNCHES[0] += 1
    return acc, m, l


def paged_attention(q: torch.Tensor, pool: torch.Tensor,
                    page_slot: torch.Tensor, lengths: torch.Tensor,
                    window: int = 0):
    """The partial ``(acc, m, l)`` over the pool's pages (the last
    ``window`` tokens of each sequence only, with a ``window`` > 0): the
    plain version for a CPU pool, the kernel for a CUDA pool."""
    _check(q, pool, page_slot, lengths)
    dev = pool.device
    if dev.type == "cpu" or (dev.type == "cuda" and plain_selected()):
        return paged_attention_ref(q.to(dev), pool, page_slot, lengths,
                                   window)
    if dev.type != "cuda":
        raise ValueError(f"no paged-attention path for device {dev}")
    return paged_attention_cuda(q, pool, page_slot, lengths, window)
