"""The port's Markov-chain prefetcher on the CPU against
``repro.core.prefetch``.

``markov_observe`` / ``markov_predict`` step by step over a seeded
``markov_stream`` (the port's copy of ``core/traffic.py``): ``succ``,
``count`` and ``prev`` equal after every step, and every prediction
equal. The cases cover the first step (``prev = -1``, which the
reference's uint32 hash wraps to 0xFFFFFFFF), a table small enough that
pages collide in one hashed state (so slots are stolen by least count,
the first of equal counts), and count ties in ``markov_predict`` (a
stable order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prefetch as jpf
from repro.core.traffic import markov_stream as j_markov_stream
from repro_torch.core import prefetch as tpf
from repro_torch.core.traffic import markov_stream


def _assert_same(jm, tm, ctx):
    for f in ("succ", "count", "prev"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)),
                                      err_msg=f"{ctx}: {f}")


def test_stream_copy_matches_reference():
    for a, b in zip(markov_stream(500, 256, seed=3),
                    j_markov_stream(500, 256, seed=3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_states,k,top", [(256, 4, 2), (8, 2, 2),
                                            (16, 4, 4)])
def test_markov_steps_match_reference(n_states, k, top):
    """200 steps of a hot ring with jumps; predictions from the page just
    seen and from a page never seen."""
    pages, _ = markov_stream(200, 256, n_hot_states=24, hot_self_p=0.8,
                             seed=n_states + k)
    jm = jpf.init_markov(n_states, k)
    tm = tpf.init_markov(n_states, k, device="cpu")
    _assert_same(jm, tm, "init")
    for t, page in enumerate(pages.tolist()):
        jm = jpf.markov_observe(jm, jnp.int32(page))
        tm = tpf.markov_observe(tm, torch.tensor(page, dtype=torch.int32))
        _assert_same(jm, tm, f"step {t}")
        for q in (page, 1000 + t):
            np.testing.assert_array_equal(
                tpf.markov_predict(tm, q, top).numpy(),
                np.asarray(jpf.markov_predict(jm, jnp.int32(q), top)),
                err_msg=f"step {t} predict {q}")
    assert int((tm.count > 1).sum()) > 0  # transitions seen again


def test_hash_wraps_and_collides():
    """The hash of -1 (the first step's ``prev``) as the reference's
    uint32 arithmetic gives it, and pages that share one state of a small
    table."""
    for n_states in (8, 256):
        for page in (-1, 0, 1, 255, 2**31 - 1, 123456):
            assert tpf._hash_state(torch.tensor(page, dtype=torch.int32),
                                   n_states) == int(jpf._hash_state(
                                       jnp.int32(page), n_states)), (
                n_states, page)
    states = [tpf._hash_state(torch.tensor(p), 8) for p in range(64)]
    assert len(set(states)) < 64  # collisions in an 8-state table


def test_count_ties_and_steals_match_reference():
    """One state fed successors in a pattern that fills its two slots,
    ties their counts, and steals the first of the least counts."""
    seq = [5, 7, 5, 9, 5, 7, 5, 9, 5, 11, 5, 11, 5, 11, 5, 7, 5, 13]
    jm = jpf.init_markov(4, 2)
    tm = tpf.init_markov(4, 2, device="cpu")
    for t, page in enumerate(seq):
        jm = jpf.markov_observe(jm, jnp.int32(page))
        tm = tpf.markov_observe(tm, torch.tensor(page, dtype=torch.int32))
        _assert_same(jm, tm, f"step {t}")
        for top in (1, 2):
            np.testing.assert_array_equal(
                tpf.markov_predict(tm, 5, top).numpy(),
                np.asarray(jpf.markov_predict(jm, jnp.int32(5), top)),
                err_msg=f"step {t} top {top}")
