"""A whole run on the CPU, its look for a card skipped, with the timed path
broken underneath: ``correct`` must come out false for each fault a
serving cell can have. (One card: no exchange between chips to leave
out.)"""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness


def _unchanged(step):
    """A decode step that returns the state it was given."""
    def broken(params, state, tokens):
        _, out = step(params, state, tokens)
        return state, out
    return broken


def _half(step):
    """A decode step that serves the first half of the batch and hands
    the second half the first half's answers."""
    def broken(params, state, tokens):
        state, (tok, lp) = step(params, state, tokens)
        half = tok.shape[0] // 2
        tok = torch.cat([tok[:half], tok[:tok.shape[0] - half]])
        return state, (tok, lp)
    return broken


def _altered(step):
    """A decode step that alters the tokens it produces at every fifth
    call."""
    calls = [0]

    def broken(params, state, tokens):
        state, (tok, lp) = step(params, state, tokens)
        calls[0] += 1
        return state, ((tok + 1) if calls[0] % 5 == 0 else tok, lp)
    return broken


@pytest.mark.parametrize("cell", ["tiny-dense", "tiny-moe"])
@pytest.mark.parametrize("fault", [None, _unchanged, _half, _altered])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, cell, fault):
    from repro_torch.serving import engine
    if fault is not None:
        make = engine.make_decode_step
        monkeypatch.setattr(engine, "make_decode_step",
                            lambda *a, **k: fault(make(*a, **k)))
    out = harness.run(tiny_root, harness.load_cell(tiny_root, cell),
                      2**31 + 21, 0.2, False, "cpu", time.perf_counter())
    assert out["correct"] is (fault is None)
    assert (out["failed"] > 0) is (fault is not None)
