"""The benchmark's operation and byte counts against hand counts at a tiny
shape, and against the figures ``PERF.md`` gives at phase 10's shape
(8 sequences of 3,072 tokens through mistral-nemo-12b's attention)."""
from __future__ import annotations

import pytest

from port_bench import arith

M = dict(d=8, layers=2, heads=4, kv_heads=2, head_dim=2, d_ff=16, vocab=32)
MOE = dict(M, experts=4, top_k=2)


@pytest.mark.parametrize("args,pairs", [
    ((4, 4), 10),                       # causal: 1 + 2 + 3 + 4
    ((4, 4, False), 16),                # full
    ((4, 4, True, 2), 7),               # window 2: 1 + 2 + 2 + 2
    ((4, 4, True, None, 2), 11),        # prefix 2: 2 + 2 + 3 + 4
])
def test_visible_pairs_by_hand(args, pairs):
    assert arith.visible_pairs(*args) == pairs


def test_flash_bound_at_phase_10():
    fb = arith.flash_bound(8, 32, 8, 3072, 128)
    assert fb["flops"] == 4 * 8 * 32 * (3072 * 3073 // 2) * 128
    assert round(fb["flops"] / 1e11, 2) == 6.19
    assert fb["bound_by"] == "operations"
    assert fb["bound_ms"] == pytest.approx(1e3 * fb["flops"] / 989e12)


def test_paged_bound_at_phase_10():
    # Both tiers of one layer at the last of 257 decode steps: 3,329 live
    # tokens a sequence.
    pb = arith.paged_bound(8, 32, 8, 128, 8 * 3329)
    assert pb["bytes"] == 8 * 3329 * 2 * 8 * 128 * 2 + 2 * (
        4 * 8 * 32 * 128 + 4 * (8 * 32 * 128 + 2 * 8 * 32))
    assert round(pb["bytes"] / 1e6, 1) == 109.6
    assert pb["bound_by"] == "bytes"


def test_model_counts_by_hand():
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8          # q, k, v, o
    dense = 3 * 8 * 16
    assert arith.attn_params(M) == attn
    assert arith.ffn_params(M, 1) == dense
    assert arith.ffn_params(MOE, 2) == 2 * dense + 8 * 4
    # Decode: 3 sequences over 5, 6 and 7 live tokens.
    assert arith.decode_step_flops(M, [5, 6, 7]) == (
        2 * 3 * 2 * (attn + dense) + 4 * 18 * 2 * 4 * 2 + 2 * 3 * 32 * 8)
    # Prefill: 2 prompts of 3 tokens, 6 visible pairs each.
    assert arith.prefill_flops(MOE, 2, 3) == (
        2 * 2 * 3 * 2 * (attn + 2 * dense + 32) + 4 * 2 * 4 * 2 * 6 * 2
        + 2 * 2 * 32 * 8)
    # Bytes: 1 sequence reaches 2 of 4 experts with top-2; 2 reach all 4.
    kv_row = 2 * 2 * 2 * 2
    for live, experts in (([5], 2), ([5, 6], 4)):
        weights = 2 * (attn + experts * dense + 32 + 16) + 32 * 8 + 8
        assert arith.decode_step_bytes(MOE, live) == 2 * (
            weights + sum(live) * kv_row + len(live) * kv_row
            + len(live) * 8)
