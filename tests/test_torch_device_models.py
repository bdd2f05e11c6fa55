"""``repro_torch.core.device_models`` (a copy of the reference's numpy
module) against ``repro.core.device_models`` on the CPU: the simulated
measurement campaigns, the fitted NVMe and HDD behavioral models
(coefficients, their standard errors and p-values, AIC, R², the 20-fold
cross-validated RMSE), the load-factor fit ``fit_mu_load`` and its
``ValueError`` messages. Both are numpy, so every number is equal."""
import numpy as np
import pytest

from repro.core import device_models as jdm
from repro_torch.core import device_models as tdm


def _fits_equal(got, want):
    assert got.kind == want.kind
    assert got.cv_rmse == want.cv_rmse
    g, w = got.fit, want.fit
    assert g.terms == w.terms and g.n == w.n
    for f in ("coef", "stderr", "tvalues", "pvalues"):
        np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f)
    assert (g.aic, g.r2, g.sigma2) == (w.aic, w.r2, w.sigma2)
    assert g.table() == w.table()
    assert g.significant() == w.significant()


@pytest.mark.parametrize("read", [False, True])
@pytest.mark.parametrize("kind", ["nvme", "hdd"])
def test_fitted_device_models_match_reference(kind, read):
    fit = "fit_nvme_model" if kind == "nvme" else "fit_hdd_model"
    got = getattr(tdm, fit)(read=read, seed=3)
    want = getattr(jdm, fit)(read=read, seed=3)
    _fits_equal(got, want)
    xs = dict(x1=16.0, x2=2.0, x3=4096.0, x5=1e10)
    assert got.service_rate(1e5, **xs) == want.service_rate(1e5, **xs)


@pytest.mark.parametrize("kind", ["nvme", "hdd"])
def test_simulated_campaigns_match_reference(kind):
    sim = "simulate_nvme" if kind == "nvme" else "simulate_hdd"
    for read in (False, True):
        gd, gy = getattr(tdm, sim)(150, read=read, seed=5)
        wd, wy = getattr(jdm, sim)(150, read=read, seed=5)
        assert sorted(gd) == sorted(wd)
        for k in gd:
            np.testing.assert_array_equal(gd[k], wd[k])
        np.testing.assert_array_equal(gy, wy)


def test_fit_mu_load_matches_reference():
    q = np.array([0.0, 1.0, 2.0, 4.0, 8.0, 16.0])
    for ratio in (1.0 + 0.3 * q / (1.0 + 0.1 * q),      # improves with Q
                  1.0 / (1.0 + 0.05 * q),               # degrades
                  np.ones_like(q)):                     # load-independent
        assert tdm.fit_mu_load(q, ratio) == jdm.fit_mu_load(q, ratio)
    r1, r2 = 1.0 + 0.2 * q, 1.0 / (1.0 + 0.3 * q)
    assert tdm.mu_load_from_devices(q, r1, q, r2) \
        == jdm.mu_load_from_devices(q, r1, q, r2)


@pytest.mark.parametrize("q,ratio", [
    ([1.0], [1.0]),                       # fewer than two points
    ([1.0, 2.0], [1.0, 2.0, 3.0]),        # shapes differ
    ([[1.0, 2.0]], [[1.0, 2.0]]),         # not 1-d
    ([1.0, np.nan], [1.0, 1.0]),          # not finite
    ([1.0, 2.0], [1.0, 0.0]),             # ratio not positive
])
def test_fit_mu_load_errors_match_reference(q, ratio):
    with pytest.raises(ValueError) as want:
        jdm.fit_mu_load(q, ratio)
    with pytest.raises(ValueError) as got:
        tdm.fit_mu_load(q, ratio)
    assert str(got.value) == str(want.value)
