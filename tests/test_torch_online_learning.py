"""The port's online learner against the reference: the f32 WeightAdjust
bit for bit over reachable states, the expert choice, and the pow table."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import online_learning as jol
from repro_torch.core import online_learning as tol

EW = 4  # the paper's epoch width


def _reachable_states(n, seed, ring=EW):
    """Random learner states a ws run can reach at an epoch boundary:
    weights a probability vector, epoch misses in 0..EW, each expert's
    mispredictions at most the epoch's misses."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, 3)).astype(np.float32) + np.float32(1e-3)
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    em = rng.integers(0, EW + 1, (n, 1)).astype(np.int32)
    mis = (rng.random((n, 3)) * (em + 1)).astype(np.int32)
    pred = rng.integers(-1, 50, (n, 3, ring)).astype(np.int32)
    pred_n = rng.integers(0, EW + 1, (n, 3)).astype(np.int32)
    chosen = rng.integers(0, 3, (n, 1)).astype(np.int32)
    return w, pred, pred_n, mis, em, chosen


def _jax_adjust(alpha, beta, threshold):
    def f(w, pred, pred_n, mis, em, chosen):
        st = jol.OLState(w, pred, pred_n, mis, em, chosen)
        cfg = jol.OLConfig(epoch_width=EW, alpha=alpha, beta=beta,
                           threshold=threshold, pred_cap=EW)
        return jol.weight_adjust(st, cfg)
    # vmap over rows inside jit: the engine's compiled setting.
    return jax.jit(jax.vmap(f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weight_adjust_bit_exact_default_beta(seed):
    leaves = _reachable_states(4000, seed)
    cfg = jol.OLConfig()
    want = _jax_adjust(jnp.float32(cfg.alpha), jnp.float32(cfg.beta),
                       jnp.float32(cfg.threshold))(*leaves)
    got = tol.weight_adjust(
        tol.OLState(*(torch.from_numpy(x) for x in leaves)),
        tol.OLConfig(epoch_width=EW, pred_cap=EW))
    for f in tol.OLState._fields:
        x = np.asarray(getattr(want, f))
        y = getattr(got, f).numpy()
        bad = np.flatnonzero((x.view(np.int32) != y.view(np.int32))
                             .reshape(len(x), -1).any(1)
                             if x.dtype == np.float32 else
                             (x != y).reshape(len(x), -1).any(1))
        assert bad.size == 0, (
            f"first divergent field {f!r} at row {bad[0]}: "
            f"state={[leaf[bad[0]].tolist() for leaf in leaves]} "
            f"jax={x[bad[0]].tolist()} torch={y[bad[0]].tolist()}")


@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.9])
@pytest.mark.parametrize("beta", [0.3, 0.6, 0.95])
def test_weight_adjust_bit_exact_off_default_knobs(alpha, beta):
    """Away from the default knobs: XLA computes ``alpha * mean`` as
    ``(alpha * 1/3) * sum``, which differs from ``alpha * (sum * 1/3)``
    in the last ulp unless alpha is a power of two."""
    leaves = _reachable_states(3000, 11)
    want = _jax_adjust(jnp.float32(alpha), jnp.float32(beta),
                       jnp.float32(0.25))(*leaves)
    got = tol.weight_adjust(
        tol.OLState(*(torch.from_numpy(x) for x in leaves)),
        tol.OLConfig(epoch_width=EW, alpha=alpha, beta=beta,
                     threshold=0.25, pred_cap=EW))
    np.testing.assert_array_equal(got.weights.numpy().view(np.int32),
                                  np.asarray(want.weights).view(np.int32))


def test_weight_adjust_per_row_knobs():
    """Per-row alpha/threshold tensors give each row its own update."""
    leaves = _reachable_states(6, 7)
    alpha = np.array([0.5, 0.1, 0.9, 0.5, 0.3, 0.7], np.float32)
    thr = np.array([0.25, 0.0, 0.5, 1.0, 0.25, 0.1], np.float32)
    got = tol.weight_adjust(
        tol.OLState(*(torch.from_numpy(x) for x in leaves)),
        tol.OLConfig(epoch_width=EW, alpha=torch.from_numpy(alpha),
                     beta=0.7, threshold=torch.from_numpy(thr),
                     pred_cap=EW))
    for r in range(6):
        want = _jax_adjust(alpha[r], np.float32(0.7), thr[r])(
            *(x[r:r + 1] for x in leaves))
        np.testing.assert_array_equal(got.weights[r].numpy(),
                                      np.asarray(want.weights)[0])


def test_pow_table_matches_xla_power():
    """The table's single-element pow rounds like XLA's f32 power, at the
    default beta and at random ones (k = 0..8)."""
    rng = np.random.default_rng(0)
    betas = np.concatenate([[0.7, 0.5, 0.9],
                            rng.random(200)]).astype(np.float32)
    table = tol.pow_table(torch.from_numpy(betas), 8).numpy()
    ks = np.arange(9, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.power)(
        jnp.asarray(betas)[:, None], jnp.asarray(ks)[None, :]))
    np.testing.assert_array_equal(table.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("beta", [0.1, 0.3, 0.5, 0.7, 0.9, 0.95])
def test_pow_table_large_exponents_flush_like_xla(beta):
    """The serving learner's losses reach far past ``epoch_width``: up to
    k = 1,999, where ``beta ** k`` becomes subnormal, the table equals
    XLA's f32 power bit for bit (XLA-CPU flushes subnormals to zero)."""
    ks = np.arange(2000, dtype=np.float32)
    want = np.asarray(jax.jit(jnp.power)(jnp.float32(beta), jnp.asarray(ks)))
    table = tol.pow_table(beta, 1999)[0].numpy()
    np.testing.assert_array_equal(table.view(np.int32), want.view(np.int32))


def test_propose_victims_and_rings_match():
    """The serving learner's victim proposals (LRU / LFU / Random over the
    unpinned valid lines, with JAX's uniforms drawn from the same key),
    its prediction rings and ``note_miss``, against the reference."""
    from repro.storage.cache_state import CacheState as JCache
    from repro_torch.kernels import threefry
    from repro_torch.storage.cache_state import CacheState as TCache
    rng = np.random.default_rng(5)
    cfg = jol.OLConfig(pred_cap=4)
    jst, tst = jol.init_ol(cfg), tol.init_ol(tol.OLConfig(pred_cap=4))
    key = threefry.prng_key(3)
    for _ in range(20):
        n = 13
        arrs = dict(tags=rng.integers(-1, 50, n).astype(np.int32),
                    valid=rng.random(n) < 0.8, dirty=rng.random(n) < 0.5,
                    freq=rng.integers(0, 5, n).astype(np.int32),
                    ts=rng.integers(0, 5, n).astype(np.int32))
        pinned = rng.random(n) < 0.3
        key, vkey = threefry.split(key)
        jkey = jnp.asarray(np.array(vkey, np.uint32))
        want = jol.propose_victims(JCache(**{k: jnp.asarray(v) for k, v in
                                             arrs.items()}), jkey,
                                   jnp.asarray(pinned))
        got = tol.propose_victims(TCache(**{k: torch.as_tensor(v) for k, v in
                                            arrs.items()}), vkey,
                                  torch.as_tensor(pinned))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pages = arrs["tags"][np.asarray(want)]
        jst = jol.note_miss(jol.record_predictions(jst, cfg,
                                                   jnp.asarray(pages)),
                            jnp.int32(pages[0]))
        tst = tol.note_miss(tol.record_predictions(tst, tol.OLConfig(
            pred_cap=4), torch.as_tensor(pages)), int(pages[0]))
        for a, b in zip(jst, tst):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_choose_expert_and_probabilities_match():
    rng = np.random.default_rng(3)
    w = rng.random((500, 3)).astype(np.float32)
    w[:50, 1] = w[:50, 0]            # ties: the first index wins
    w[50:60] = 0.0                   # all-zero: uniform probabilities
    pol = rng.integers(-1, 4, 500).astype(np.int32)
    jst = jol.OLState(jnp.asarray(w), None, None, None, None, None)
    want_p = np.asarray(jax.vmap(jol.probabilities)(jnp.asarray(w)))
    want_c = np.asarray(jax.vmap(lambda ww, p: jol.choose_expert(
        jst._replace(weights=ww), p))(jnp.asarray(w), jnp.asarray(pol)))
    tst = tol.OLState(torch.from_numpy(w), None, None, None, None, None)
    np.testing.assert_array_equal(
        tol.probabilities(torch.from_numpy(w)).numpy(), want_p)
    np.testing.assert_array_equal(
        tol.choose_expert(tst, torch.from_numpy(pol)).numpy(), want_c)


def test_init_ol_matches():
    cfg = jol.OLConfig(pred_cap=16)
    want = jol.init_ol(cfg)
    got = tol.init_ol(tol.OLConfig(pred_cap=16))
    for f in tol.OLState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
