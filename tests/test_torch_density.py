"""PyTorch port: ``ops/density.py`` against the JAX package's.

The same numpy-seeded float64 inputs go to both packages (JAX with x64,
the port in float64 on the CPU). Tolerance: rtol 1e-12 for the
closed-form functions (the same operations in the same order, sums
over up to a few hundred terms); rtol 1e-9 for the EM fit, whose
reductions run in another order in each package. Gap indices, found
flags and binary weights are exact. Subnormal values compare at atol
1e-300, since XLA flushes them to zero on the CPU and torch keeps
them. Tie order is pinned with planted equal gaps (the first maximum
wins in both), the median with an even-length input (the mean of the
two middle values, which ``torch.median`` does not give).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.ops import density as J
from bayesian_bm25_tpu_torch.ops import density as P

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _np(x):
    return np.asarray(x)


def _close(a, b, rtol=1e-12):
    # atol 1e-300: XLA on the CPU flushes subnormal results to zero.
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=1e-300)


def _sample(seed=0, n_rel=60, n_bg=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0.25, 0.04, n_rel),
                           rng.normal(0.8, 0.1, n_bg)])


@pytest.mark.parametrize("mu, sigma", [(0.0, 1.0), (0.7, 0.05), (-2.0, 3.5)])
def test_gaussian_pdf(mu, sigma):
    x = np.linspace(-4, 4, 81)
    _close(P.gaussian_pdf(_t(x), mu, sigma), J.gaussian_pdf(x, mu, sigma))


@pytest.mark.parametrize("case", ["unweighted", "weighted", "zero", "flat"])
def test_silverman_bandwidth(case):
    d = _sample(1)
    w = None
    if case == "weighted":
        w = np.random.default_rng(2).uniform(0, 1, len(d))
    elif case == "zero":
        w = np.zeros(len(d))
    elif case == "flat":
        d = np.full(50, 0.4)
    got = P.silverman_bandwidth(_t(d), None if w is None else _t(w))
    _close(got, J.silverman_bandwidth(d, w))
    if case in ("zero", "flat"):
        assert float(got) == 1e-10


@pytest.mark.parametrize("bandwidth, zero", [(0.05, False), (0.5, False),
                                             (0.1, True)])
def test_kernel_density(bandwidth, zero):
    s = _sample(3)
    e = np.linspace(0, 1.2, 97)
    w = (np.zeros(len(s)) if zero
         else np.random.default_rng(4).uniform(0, 2, len(s)))
    got = P.kernel_density(_t(e), _t(s), _t(w), bandwidth)
    _close(got, J.kernel_density(e, s, w, bandwidth))
    assert got.dtype == F64 and got.shape == (97,)


def _gmm_pair(d, max_iter, mask=None, init=(0.4, 0.2, 0.3)):
    j = J.gmm_fixed_background(d, 0.8, 0.1, *init, max_iter=max_iter,
                               mask=mask)
    t = P.gmm_fixed_background(_t(d), 0.8, 0.1, *init, max_iter=max_iter,
                               mask=None if mask is None else _t(mask))
    return [float(v) for v in j], [float(v) for v in t]


@pytest.mark.parametrize("max_iter", [1, 2, 5, 17, 100])
def test_gmm_stops_at_jax_iteration(max_iter):
    """Equal parameters under every cap: the fit takes JAX's steps and
    stops where JAX's loop stops (17 crosses a block of 16)."""
    j, t = _gmm_pair(_sample(5), max_iter)
    np.testing.assert_allclose(t, j, rtol=1e-9)


@pytest.mark.parametrize("block", [1, 3, 16, 64])
def test_gmm_block_size_is_invisible(monkeypatch, block):
    d = _t(_sample(6))
    ref = P.gmm_fixed_background(d, 0.8, 0.1, 0.4, 0.2, 0.3)
    monkeypatch.setattr(P, "GMM_BLOCK_STEPS", block)
    got = P.gmm_fixed_background(d, 0.8, 0.1, 0.4, 0.2, 0.3)
    assert [float(v) for v in got] == [float(v) for v in ref]


def test_gmm_mask_and_degenerate_start():
    d = _sample(7)
    mask = (np.arange(len(d)) % 3 != 0).astype(np.float64)
    j, t = _gmm_pair(d, 100, mask=mask)
    np.testing.assert_allclose(t, j, rtol=1e-9)
    # A start far from every point: responsibilities vanish on the
    # first step and the loop keeps the start.
    j, t = _gmm_pair(d, 100, init=(50.0, 0.01, 0.5))
    assert t == j == [50.0, 0.01, 0.5]


@pytest.mark.parametrize("case", ["primary", "tie", "zscore", "none",
                                  "short", "flat"])
def test_detect_gap_index(case):
    if case == "primary":
        d = _sample(8)
    elif case == "tie":
        # Gaps 1, 1, 1, 7, 7, 7: three equal largest gaps, the first wins.
        d = np.array([24.0, 3.0, 0.0, 17.0, 1.0, 10.0, 2.0])
    elif case == "zscore":
        # One gap of 10 among 99 gaps of 1: under the 0.15 ratio, z > 2.
        d = np.concatenate([np.arange(50.0), np.arange(59.0, 109.0)])
    elif case == "none":
        d = np.linspace(0.3, 0.9, 200)
    elif case == "short":
        d = np.array([0.1, 0.9])
    else:
        d = np.full(10, 0.5)
    ji, jf = J.detect_gap_index(d)
    ti, tf = P.detect_gap_index(_t(d))
    assert (int(ti), bool(tf)) == (int(ji), bool(jf))
    expect = {"tie": (4, True), "zscore": (50, True), "none": (False,),
              "short": (False,), "flat": (False,)}.get(case)
    if expect == (False,):
        assert not bool(tf)
    elif expect is not None:
        assert (int(ti), bool(tf)) == expect


@pytest.mark.parametrize("seed", [9, 10])
def test_gap_weights(seed):
    d = _sample(seed)
    jw, jf = J.gap_weights(d)
    tw, tf = P.gap_weights(_t(d))
    np.testing.assert_array_equal(tw.numpy(), _np(jw))
    assert bool(tf) == bool(jf)
    w2, f2 = P.gap_weights(_t([0.2, 0.4]))
    assert w2.tolist() == [1.0, 1.0] and not bool(f2)


@pytest.mark.parametrize("temperature, zero", [(0.05, False), (0.5, False),
                                               (0.05, True)])
def test_sharpen_weights(temperature, zero):
    w = (np.zeros(40) if zero
         else np.random.default_rng(11).uniform(0, 1, 40))
    got = P.sharpen_weights(_t(w), temperature)
    _close(got, J.sharpen_weights(w, temperature))
    assert float(got.sum()) == pytest.approx(w.sum())  # mass is kept


@pytest.mark.parametrize("n", [301, 300, 2])
def test_distance_density_weights_and_median(n):
    d = np.random.default_rng(12).uniform(0.05, 1.0, n)
    _close(P.distance_density_weights(_t(d)),
           J.distance_density_weights(d))
    assert float(P.median(_t(d))) == float(jnp.median(d))
    if n % 2 == 0:
        # torch.median returns the lower middle value, not the mean.
        assert float(torch.median(_t(d))) != float(P.median(_t(d)))


def test_population_std_and_mean():
    g = np.random.default_rng(13).gamma(2.0, 1.0, 1001)
    assert float(P.std(_t(g))) == pytest.approx(float(jnp.std(g)), rel=1e-14)
    assert float(P.mean(_t(g))) == pytest.approx(float(jnp.mean(g)),
                                                 rel=1e-14)
