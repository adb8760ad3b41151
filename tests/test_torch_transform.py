"""PyTorch port: math primitives and the Bayesian transform against JAX.

The JAX side runs in float64 here (tests/conftest.py enables x64, and
``mathx.as_float`` then promotes), so every comparison pins the port's
dtype: float64 against float64 at rtol 1e-12 (two libraries' sigmoid,
log and division, each correctly rounded or within an ulp), float32
against float64 at atol 2e-6 (a few float32 ulps through the posterior's
two odds updates). A small base rate is the exception: its odds update
multiplies the float32 rounding of a first posterior near 1 by up to
(1 - br) / br, so at br = 0.01 the bound is 2e-5; float64 is the dtype
for comparisons tighter than that.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
from bayesian_bm25_tpu.ops import mathx as jmathx
from bayesian_bm25_tpu.ops import transform as JT
from bayesian_bm25_tpu_torch import BayesianProbabilityTransform
from bayesian_bm25_tpu_torch.ops import mathx
from bayesian_bm25_tpu_torch.ops import transform as T

from torch_helpers import one_thread  # noqa: F401


def _inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    score = rng.gamma(2.0, 2.0, n)
    score[:16] = 0.0
    score[16:32] = 60.0                       # saturates the likelihood
    tf = rng.integers(0, 25, n).astype(np.float64)
    dlr = rng.uniform(0.0, 3.0, n)
    dlr[32:40] = 0.5                          # norm-prior peak
    return score, tf, dlr


PARAMS = [(1.2, 4.0, None), (0.7, 2.5, 0.01), (3.0, 0.5, 0.3)]
F32_ATOL = {None: 2e-6, 0.01: 2e-5, 0.3: 2e-6}


@pytest.mark.parametrize("alpha,beta,base_rate", PARAMS)
@pytest.mark.parametrize("prior_free", [False, True])
def test_score_to_probability_f64(alpha, beta, base_rate, prior_free):
    score, tf, dlr = _inputs()
    want = np.asarray(JT.score_to_probability(
        score, tf, dlr, alpha, beta, base_rate, prior_free=prior_free))
    got = T.score_to_probability(
        torch.from_numpy(score), torch.from_numpy(tf), torch.from_numpy(dlr),
        alpha, beta, base_rate, prior_free=prior_free, dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("alpha,beta,base_rate", PARAMS)
def test_score_to_probability_f32_vs_x64(alpha, beta, base_rate):
    """atol 2e-6 wherever the first posterior lies inside the float32
    clamp; where it saturates, the float32 result is the clamp's own
    (1e-6 instead of 1e-10, as the JAX package computes on a chip)."""
    score, tf, dlr = _inputs(1)
    want = np.asarray(JT.score_to_probability(
        score, tf, dlr, alpha, beta, base_rate))
    got = T.score_to_probability(
        torch.from_numpy(score.astype(np.float32)),
        torch.from_numpy(tf.astype(np.float32)),
        torch.from_numpy(dlr.astype(np.float32)),
        alpha, beta, base_rate, dtype=torch.float32)
    assert got.dtype == torch.float32
    first = np.asarray(JT.posterior(JT.likelihood(score, alpha, beta),
                                    JT.composite_prior(tf, dlr)))
    inside = (first > 1e-6) & (first < 1 - 1e-6)
    assert inside.sum() > 2000 and (~inside).sum() > 0
    np.testing.assert_allclose(got.numpy()[inside], want[inside], rtol=0,
                               atol=F32_ATOL[base_rate])
    sat = T.posterior(torch.full((), 1 - 1e-6, dtype=torch.float32),
                      torch.full((), 0.5), base_rate)
    top = ~inside & (first > 0.5)
    np.testing.assert_array_equal(got.numpy()[top], float(sat))


@pytest.mark.parametrize("fn", ["likelihood", "tf_prior", "norm_prior",
                                "composite_prior", "posterior"])
def test_pieces_f64(fn):
    score, tf, dlr = _inputs(2)
    if fn == "likelihood":
        args = (score, 1.3, 3.0)
    elif fn == "tf_prior":
        args = (tf,)
    elif fn == "norm_prior":
        args = (dlr,)
    elif fn == "composite_prior":
        args = (tf, dlr)
    else:
        args = (np.clip(score / 40.0, 0, 1), np.clip(dlr / 3.0, 0, 1), 0.05)
    want = np.asarray(getattr(JT, fn)(*args))
    got = getattr(T, fn)(*args, dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_mathx_parity_and_epsilon():
    assert mathx.epsilon(torch.float64) == jmathx.epsilon(np.float64) == 1e-10
    assert mathx.epsilon(torch.float32) == jmathx.epsilon(np.float32) == 1e-6
    x = np.linspace(-40, 40, 801)
    np.testing.assert_allclose(mathx.sigmoid(x, torch.float64).numpy(),
                               np.asarray(jmathx.sigmoid(x)), rtol=1e-12)
    p = np.array([0.0, 1e-12, 0.3, 1.0 - 1e-12, 1.0])
    np.testing.assert_array_equal(
        mathx.clamp_probability(p, torch.float64).numpy(),
        np.asarray(jmathx.clamp_probability(p)))
    np.testing.assert_allclose(mathx.logit(p, torch.float64).numpy(),
                               np.asarray(jmathx.logit(p)), rtol=1e-12)
    # float32 clamps at 1e-6: 1 - 1e-10 would round to 1.0
    c32 = mathx.clamp_probability(p, torch.float32)
    assert c32.dtype == torch.float32
    assert float(c32.max()) < 1.0 and float(c32.min()) > 0.0
    np.testing.assert_array_equal(
        c32.numpy(), np.clip(p, 1e-6, 1 - 1e-6).astype(np.float32))


def test_true_div_is_ieee_division():
    x = np.arange(0, 5000, dtype=np.float32)
    got = T.true_div(torch.from_numpy(x), 10.0).numpy()
    np.testing.assert_array_equal(got, x / np.float32(10.0))


@pytest.mark.parametrize("mode", ["balanced", "prior_free"])
def test_transform_object(mode):
    score, tf, dlr = _inputs(3, 64)
    jt = JaxTransform(alpha=0.9, beta=2.0, base_rate=0.02)
    tt = BayesianProbabilityTransform(alpha=0.9, beta=2.0, base_rate=0.02,
                                      device="cpu")
    jt._training_mode = tt._training_mode = mode
    assert (tt.alpha, tt.beta, tt.base_rate) == (jt.alpha, jt.beta,
                                                 jt.base_rate)
    np.testing.assert_allclose(tt.score_to_probability(score, tf, dlr),
                               jt.score_to_probability(score, tf, dlr),
                               rtol=1e-12)
    one = tt.score_to_probability(3.0, 2.0, 0.8)
    assert isinstance(one, float)
    assert one == pytest.approx(jt.score_to_probability(3.0, 2.0, 0.8),
                                rel=1e-12)


def test_transform_prior_fn_and_validation():
    def prior_fn(s, t, r):
        return np.full(np.shape(s), 0.6)

    score, tf, dlr = _inputs(4, 32)
    jt = JaxTransform(alpha=1.1, beta=1.0, prior_fn=prior_fn)
    tt = BayesianProbabilityTransform(alpha=1.1, beta=1.0, prior_fn=prior_fn,
                                      device="cpu")
    np.testing.assert_allclose(tt.score_to_probability(score, tf, dlr),
                               jt.score_to_probability(score, tf, dlr),
                               rtol=1e-12)
    with pytest.raises(ValueError):
        BayesianProbabilityTransform(base_rate=1.5, device="cpu")
