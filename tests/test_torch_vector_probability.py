"""PyTorch port: ``VectorProbabilityTransform``, ``ivf_density_prior``
and ``knn_density_prior`` against the JAX package.

The same numpy-seeded float64 inputs go to both packages (JAX with x64,
the port in float64 on the CPU). Every route of
``_estimate_relevant_density`` is driven (each auto branch, kde and gmm
with each weight source, the empty sample, a bad method), and the route
the port took is read from its estimator calls. Tolerance: rtol 1e-9
for probabilities and densities (the JAX package pads the sample to a
power of two with zero weights, which changes only the order of its
float64 sums); the priors rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.models import vector_probability as J
from bayesian_bm25_tpu_torch.models import vector_probability as P

from torch_helpers import one_thread  # noqa: F401

CPU = dict(device="cpu")
RTOL = 1e-9


def _cluster(seed, n_rel, n_bg):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0.2, 0.03, n_rel),
                           rng.normal(0.8, 0.08, n_bg)])


GAP = _cluster(0, 60, 300)           # a gap, K >= 50
GAP_SMALL = _cluster(1, 8, 30)       # a gap, K < 50
NO_GAP = np.linspace(0.35, 0.95, 200)  # equal gaps: no gap found
EVAL = np.linspace(0.0, 1.3, 131)
BG = np.random.default_rng(2).normal(0.75, 0.12, 4000)


def _pair(base_rate=0.05):
    return (J.VectorProbabilityTransform.fit_background(BG,
                                                        base_rate=base_rate),
            P.VectorProbabilityTransform.fit_background(BG,
                                                        base_rate=base_rate,
                                                        **CPU))


def _weights(n, seed=3):
    return np.random.default_rng(seed).uniform(0.0, 1.0, n)


def _spy(monkeypatch, t):
    seen = []
    for name in ("_kde", "_gmm"):
        orig = getattr(t, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            seen.append(_name[1:])
            return _orig(*a, **kw)

        monkeypatch.setattr(t, name, rec)
    return seen


# (method, sample, weights, density prior, the estimator the route takes)
ROUTES = {
    "auto-gap-kde": ("auto", GAP, None, None, "kde"),
    "auto-gap-gmm": ("auto", GAP_SMALL, None, None, "gmm"),
    "auto-weights": ("auto", NO_GAP, "w", None, "kde"),
    "auto-prior": ("auto", NO_GAP, None, "w", "gmm"),
    "auto-fallback": ("auto", NO_GAP, None, None, "gmm"),
    "auto-zero-weights": ("auto", NO_GAP, "zero", None, "gmm"),
    "kde-weights": ("kde", GAP, "w", None, "kde"),
    "kde-prior": ("kde", GAP, None, "w", "kde"),
    "kde-gap": ("kde", GAP, None, None, "kde"),
    "kde-fallback": ("kde", NO_GAP, None, None, "kde"),
    "gmm-weights": ("gmm", GAP, "w", None, "gmm"),
    "gmm-prior": ("gmm", GAP, None, "w", "gmm"),
    "gmm-none": ("gmm", NO_GAP, None, None, "gmm"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_match_jax(monkeypatch, route):
    method, s, w, prior, estimator = ROUTES[route]

    def make(kind):
        if kind is None:
            return None
        return np.zeros(len(s)) if kind == "zero" else _weights(len(s))

    j, t = _pair()
    kw = dict(weights=make(w), density_prior=make(prior), method=method,
              bandwidth_factor=1.5)
    seen = _spy(monkeypatch, t)
    got = t.calibrate_with_sample(EVAL, s, **kw)
    assert seen == [estimator]
    np.testing.assert_allclose(got, j.calibrate_with_sample(EVAL, s, **kw),
                               rtol=RTOL)
    np.testing.assert_allclose(
        t._estimate_relevant_density(EVAL, s, **kw),
        j._estimate_relevant_density(EVAL, s, **kw), rtol=RTOL)


@pytest.mark.parametrize("method", ["auto", "kde", "gmm"])
def test_calibrate_and_scalars(method):
    j, t = _pair(base_rate=None)
    d = GAP[:120]
    np.testing.assert_allclose(t.calibrate(d, method=method),
                               j.calibrate(d, method=method), rtol=RTOL)
    got = t.calibrate_with_sample(0.21, GAP, method=method)
    assert isinstance(got, float)
    assert got == pytest.approx(j.calibrate_with_sample(0.21, GAP,
                                                        method=method),
                                rel=RTOL)
    one = t.calibrate(0.3, method=method)
    assert isinstance(one, float)
    assert one == pytest.approx(j.calibrate(0.3, method=method), rel=RTOL)


def test_estimators_and_ratio():
    j, t = _pair()
    w = _weights(len(GAP))
    for bf in (0.2, 2.0):
        np.testing.assert_allclose(
            t.estimate_kde(GAP, w, bf, eval_points=EVAL),
            j.estimate_kde(GAP, w, bf, eval_points=EVAL), rtol=RTOL)
    for weights in (None, w, np.zeros(len(GAP))):
        for max_iter in (3, 100):
            np.testing.assert_allclose(
                t.estimate_gmm(GAP, weights, max_iter=max_iter,
                               eval_points=EVAL),
                j.estimate_gmm(GAP, weights, max_iter=max_iter,
                               eval_points=EVAL), rtol=RTOL)
    f_r = np.abs(np.sin(EVAL)) + 1e-3
    np.testing.assert_allclose(t.log_density_ratio(EVAL, f_r),
                               j.log_density_ratio(EVAL, f_r), rtol=1e-12)
    r = t.log_density_ratio(0.4, 2.0)
    assert isinstance(r, float)
    assert r == pytest.approx(j.log_density_ratio(0.4, 2.0), rel=1e-12)


def test_weight_helpers():
    j, t = _pair()
    assert t._detect_gap(GAP) == j._detect_gap(GAP) is not None
    assert t._detect_gap(NO_GAP) is None and j._detect_gap(NO_GAP) is None
    assert t._detect_gap([0.1, 0.2]) is None
    np.testing.assert_array_equal(t._gap_weights(GAP), j._gap_weights(GAP))
    assert t._gap_weights(NO_GAP) is None
    w = _weights(50)
    # Static in the JAX package: on the class (device named) and on an
    # instance (its device).
    for got in (P.VectorProbabilityTransform._sharpen_weights(w, device="cpu"),
                t._sharpen_weights(w)):
        np.testing.assert_allclose(got, j._sharpen_weights(w), rtol=1e-12)
    for got in (P.VectorProbabilityTransform._distance_density_weights(
            GAP, device="cpu"), t._distance_density_weights(GAP)):
        np.testing.assert_allclose(got, j._distance_density_weights(GAP),
                                   rtol=1e-12)
    assert t._signal_mass(None) == 0.0 == t._signal_mass([])
    assert t._signal_mass([-1.0, 2.0]) == 2.0


def test_empty_sample_and_bad_method():
    j, t = _pair()
    out = t._estimate_relevant_density(EVAL, [])
    np.testing.assert_array_equal(out, np.full_like(EVAL, 1e-10))
    np.testing.assert_allclose(t.calibrate_with_sample(EVAL, []),
                               j.calibrate_with_sample(EVAL, []), rtol=RTOL)
    with pytest.raises(ValueError, match="method"):
        t.calibrate(GAP, method="mixture")


@pytest.mark.parametrize("kw, match", [
    (dict(mu_G=0.5, sigma_G=0.0), "sigma_G"),
    (dict(mu_G=0.5, sigma_G=0.1, base_rate=1.0), "base_rate"),
    (dict(mu_G=0.5, sigma_G=0.1, base_rate=0.0), "base_rate"),
])
def test_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        J.VectorProbabilityTransform(**kw)
    with pytest.raises(ValueError, match=match):
        P.VectorProbabilityTransform(**kw, **CPU)


def test_fit_background_and_default_device():
    j, t = _pair()
    assert (t.mu_G, t.sigma_G, t.base_rate) == (j.mu_G, j.sigma_G,
                                                j.base_rate)
    assert t._logit_base_rate == pytest.approx(j._logit_base_rate, rel=1e-15)
    flat = P.VectorProbabilityTransform.fit_background(np.ones(10), **CPU)
    assert flat.sigma_G == 1e-10 and flat.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert P.VectorProbabilityTransform(0.5, 0.1).device.type == "cuda"
    else:
        for call in (lambda: P.VectorProbabilityTransform(0.5, 0.1),
                     lambda: P.ivf_density_prior([1.0], 2.0),
                     lambda: P.knn_density_prior([1.0], 2.0)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


@pytest.mark.parametrize("gamma", [1.0, 2.5])
def test_priors(gamma):
    pops = np.array([0, 1, 5, 20, 80, 400], dtype=np.int64)
    np.testing.assert_allclose(
        P.ivf_density_prior(pops, 37.5, gamma=gamma, **CPU),
        J.ivf_density_prior(pops, 37.5, gamma=gamma), rtol=1e-12)
    kth = np.linspace(0.05, 1.5, 30)
    np.testing.assert_allclose(
        P.knn_density_prior(kth, 0.4, gamma=gamma, **CPU),
        J.knn_density_prior(kth, 0.4, gamma=gamma), rtol=1e-12)
    for got, ref in ((P.ivf_density_prior(7, 20.0, gamma=gamma, **CPU),
                      J.ivf_density_prior(7, 20.0, gamma=gamma)),
                     (P.knn_density_prior(0.3, 0.0, gamma=gamma, **CPU),
                      J.knn_density_prior(0.3, 0.0, gamma=gamma))):
        assert isinstance(got, float)
        assert got == pytest.approx(ref, rel=1e-12)
