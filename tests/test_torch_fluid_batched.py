"""The port's batched fluid solver (float64 torch on the CPU) against the
reference's numpy ``fluid_two_tier`` on the cases of
``test_fluid_batched.py``: within 1e-10 on the analytic k = 1 path (both
are the same float64 formulas, op for op) and 1e-9 for k > 1 (a fixed
60-step bisection against numpy's early exit at ~1e-9 relative). Also:
a point's result does not depend on the batch around it, and solvers are
built once per structural config."""
import numpy as np
import pytest

from repro.core import queuing as J
from repro_torch.core import queuing as T

DT = 0.1
K1_TOL = 1e-10
BISECTION_TOL = 1e-9


def grids(n_points=6, n_shards=3, n_windows=12, seed=0):
    """A [P, S, W] stack of diverse healthy rate grids."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.0, 140.0, (n_points, n_shards, n_windows))
    p12 = rng.uniform(0.0, 0.6, (n_points, n_shards, n_windows))
    mu1 = rng.uniform(150.0, 450.0, (n_points, n_shards, n_windows))
    mu2 = rng.uniform(30.0, 90.0, (n_points, n_shards, n_windows))
    return lam, p12, mu1, mu2


def assert_reports_match(got, want, tol, what=""):
    """Field by field: identical None-ness and non-finite masks, finite
    entries within ``tol``."""
    assert got._fields == want._fields
    for name, vg, vw in zip(want._fields, got, want):
        if vg is None or vw is None:
            assert vg is None and vw is None, f"{what}{name} None mismatch"
            continue
        xg, xw = np.asarray(vg), np.asarray(vw)
        assert xg.shape == xw.shape, f"{what}{name} shape"
        if xw.dtype == bool:
            np.testing.assert_array_equal(xg, xw, err_msg=f"{what}{name}")
            continue
        fg, fw = np.isfinite(xg), np.isfinite(xw)
        np.testing.assert_array_equal(fg, fw,
                                      err_msg=f"{what}{name} finite mask")
        np.testing.assert_array_equal(xg[~fg], xw[~fw],
                                      err_msg=f"{what}{name} non-finite")
        if fw.any():
            np.testing.assert_allclose(xg[fg], xw[fw], rtol=0, atol=tol,
                                       err_msg=f"{what}{name}")


def reference_stack(lam, p12, mu1, mu2, per_point=(), **kw):
    """The reference's numpy solver per point, restacked to the batched
    layout; ``per_point`` names keyword arrays sliced per point, and a
    ``q0`` pair is sliced per point too."""
    reps = []
    for i in range(lam.shape[0]):
        kwi = {k: (v[i] if k in per_point else v) for k, v in kw.items()
               if k != "q0"}
        if "q0" in kw:
            kwi["q0"] = (kw["q0"][0][i], kw["q0"][1][i])
        reps.append(J.fluid_two_tier(lam[i], p12[i], mu1[i], mu2[i], **kwi))
    return type(reps[0])(*(
        None if reps[0][j] is None
        else np.stack([np.asarray(r[j]) for r in reps])
        for j in range(len(reps[0]))))


def _retry(mod, **kw):
    return mod.RetryPolicy(timeout=0.04, max_retries=3, backoff_init=0.2,
                           **kw)


def test_healthy():
    lam, p12, mu1, mu2 = grids()
    got = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu")
    assert_reports_match(got, reference_stack(lam, p12, mu1, mu2, dt=DT),
                         K1_TOL)


def test_faulted():
    """Retry storm + tier-1 spill + a dead-μ outage + idle windows."""
    lam, p12, mu1, mu2 = grids(seed=1)
    lam[:, :, 3] = 0.0
    mu1[:, 1, 5:7] = 0.0
    mu2[:, :, 6] = 0.0
    lam[:, :, 8] = 400.0
    got = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT,
                                   retry=_retry(T), tier1_spill=True,
                                   device="cpu")
    want = reference_stack(lam, p12, mu1, mu2, dt=DT, retry=_retry(J),
                           tier1_spill=True)
    assert got.retry_rate is not None and got.metastable is not None
    assert_reports_match(got, want, K1_TOL)


@pytest.mark.parametrize("kw", [dict(k=3), dict(k=2, var_s1=2e-5)],
                         ids=["mmk", "mgk"])
def test_multiserver_bisection(kw):
    lam, p12, mu1, mu2 = grids(n_points=4, seed=2)
    got = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu",
                                   **kw)
    assert_reports_match(got, reference_stack(lam, p12, mu1, mu2, dt=DT,
                                              **kw), BISECTION_TOL)


def test_kscale_q0_conserving():
    lam, p12, mu1, mu2 = grids(n_points=3, seed=3)
    k_scale = np.ones_like(lam)
    k_scale[:, :, 4:6] = 0.5
    q0 = (np.full(lam.shape[:-1], 3.0), np.full(lam.shape[:-1], 1.5))
    got = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT,
                                   flow="conserving", k_scale=k_scale, q0=q0,
                                   device="cpu")
    want = reference_stack(lam, p12, mu1, mu2, dt=DT, flow="conserving",
                           k_scale=k_scale, q0=q0,
                           per_point=("k_scale",))
    assert_reports_match(got, want, K1_TOL)


def test_mu_load():
    """Load-dependent μ(Q): slower under backlog, against the reference;
    all-zero coefficients are bitwise the fixed-rate solve."""
    lam = np.full((2, 1, 10), 90.0)
    p12 = np.full_like(lam, 0.3)
    mu1 = np.full_like(lam, 120.0)
    mu2 = np.full_like(lam, 45.0)
    slow = ((0.0, 0.8), (0.0, 0.8))
    got = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, mu_load=slow,
                                   device="cpu")
    assert_reports_match(got, reference_stack(lam, p12, mu1, mu2, dt=DT,
                                              mu_load=slow), K1_TOL)
    off = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu")
    zero = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu",
                                    mu_load=((0.0, 0.0), (0.0, 0.0)))
    for name, vo, vz in zip(off._fields, off, zero):
        if vo is None:
            assert vz is None
            continue
        np.testing.assert_array_equal(np.asarray(vo), np.asarray(vz),
                                      err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(k=2)], ids=["k1", "k2"])
def test_invariant_to_batch_composition(kw):
    """Solving a point alone is bitwise slicing it from any larger
    stack."""
    lam, p12, mu1, mu2 = grids(n_points=5, seed=7)
    whole = T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT,
                                     device="cpu", **kw)
    for sel in ([2], [4, 0], [1, 3, 2]):
        part = T.fluid_two_tier_batched(lam[sel], p12[sel], mu1[sel],
                                        mu2[sel], dt=DT, device="cpu", **kw)
        for name, vw, vp in zip(whole._fields, whole, part):
            if vw is None:
                assert vp is None
                continue
            np.testing.assert_array_equal(np.asarray(vp),
                                          np.asarray(vw)[sel], err_msg=name)


def test_compile_count_one_build_per_config():
    lam, p12, mu1, mu2 = grids(n_points=2, n_shards=2, n_windows=7, seed=4)
    T.reset_fluid_compile_count()
    T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu")
    first = T.fluid_compile_count()
    assert first <= 1
    T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu")
    assert T.fluid_compile_count() == first
    # A new shape through the same structural config builds nothing.
    T.fluid_two_tier_batched(lam[:, 0], p12[:, 0], mu1[:, 0], mu2[:, 0],
                             dt=DT, device="cpu")
    assert T.fluid_compile_count() == first
    # A new structural config (retry feedback) builds one solver at most.
    T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT, device="cpu",
                             retry=T.RetryPolicy(timeout=0.05,
                                                 max_retries=5,
                                                 backoff_init=0.1))
    assert T.fluid_compile_count() <= first + 1


def test_default_device_is_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lam, p12, mu1, mu2 = grids(n_points=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.fluid_two_tier_batched(lam, p12, mu1, mu2, dt=DT)
