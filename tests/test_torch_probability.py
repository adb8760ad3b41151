"""PyTorch port: the transform's learning surface against JAX.

``fit`` (three modes, with and without sample weights), ``update``
sequences (mode switches, the alpha floor, gradient clipping), ``fit``
in float32 against JAX with x64 off,
``TemporalBayesianTransform``, the static priors, ``posterior``,
``wand_upper_bound`` and the module's ``sigmoid``/``logit``, on the same
numpy-seeded inputs. JAX runs with x64 (tests/conftest.py) and the port
in float64, so every value is held to rtol 1e-9: the two differ only in
summation order and in an ulp of a library sigmoid or power per step,
about 1e-16 relative (measured 0 to 2.2e-16 after 1,775 steps).

``fit_transform`` stops at the first step whose moves in alpha and beta
both fall below ``tolerance``. A stop within rounding of the tolerance
could flip between libraries and show as a gap far above 1e-9, so the
inputs are checked to keep every step at least 1e-6 (relative) away from
the tolerance, and the iteration counts of both packages must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
from bayesian_bm25_tpu.models.probability import (
    TemporalBayesianTransform as JaxTemporal)
from bayesian_bm25_tpu.models import probability as jprob
from bayesian_bm25_tpu.ops import transform as JT
from bayesian_bm25_tpu_torch import (BayesianProbabilityTransform,
                                     TemporalBayesianTransform)
from bayesian_bm25_tpu_torch.models import probability as tprob
from bayesian_bm25_tpu_torch.ops import mathx
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.utils import convert

RTOL = 1e-9
F64 = torch.float64
STATE = ("alpha", "beta", "_alpha_avg", "_beta_avg", "_grad_alpha_ema",
         "_grad_beta_ema")


def _data(seed=0, n=3000):
    rng = np.random.default_rng(seed)
    scores = rng.gamma(2.0, 2.0, n)
    labels = (rng.uniform(size=n)
              < 1.0 / (1.0 + np.exp(-1.2 * (scores - 4.0)))).astype(float)
    tfs = rng.integers(0, 14, n).astype(float)
    dlr = rng.uniform(0.1, 1.8, n)
    weights = rng.uniform(0.2, 2.0, n)
    return scores, labels, tfs, dlr, weights


def _assert_state(j, t, exact=("_training_mode", "_n_updates")):
    for name in STATE:
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=RTOL, atol=0, err_msg=name)
    for name in exact:
        assert getattr(t, name) == getattr(j, name), name


def _stop_margin(scores, labels, priors, weights, prior_aware, lr, n_max,
                 tol, dtype=F64):
    """Replays the port's loop and returns the smallest relative distance
    between ``tol`` and the larger of each step's two moves (the quantity
    the stop compares), over every step taken."""
    s = mathx.as_float(scores, dtype)
    y = mathx.as_float(labels, dtype)
    p = torch.zeros_like(s) if priors is None else mathx.as_float(priors, dtype)
    w = torch.ones_like(s) if weights is None else mathx.as_float(weights, dtype)
    a, b = torch.tensor(0.5, dtype=dtype), torch.tensor(1.0, dtype=dtype)
    margin = np.inf
    for _ in range(n_max):
        g_a, g_b = T._bce_grads(a, b, s, y, p, w, prior_aware, dtype)
        na, nb = a - lr * g_a, b - lr * g_b
        move = max(float(abs(na - a)), float(abs(nb - b)))
        margin = min(margin, abs(move - tol) / tol)
        a, b = na, nb
        if move < tol:
            break
    return margin


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["balanced", "prior_aware", "prior_free"])
def test_fit_matches_jax(mode, weighted):
    scores, labels, tfs, dlr, weights = _data(n=1000)
    w = weights if weighted else None
    lr, n_max, tol = 0.05, 2500, 1e-6
    priors = None
    kw = dict(mode=mode, learning_rate=lr, max_iterations=n_max,
              tolerance=tol, sample_weights=w)
    if mode == "prior_aware":
        kw.update(tfs=tfs, doc_len_ratios=dlr)
        priors = np.asarray(JT.composite_prior(tfs, dlr))
    fit_kw = dict(prior_aware=mode == "prior_aware", priors=priors,
                  sample_weights=w, learning_rate=lr, max_iterations=n_max,
                  tolerance=tol)
    ja, jb, jn = JT.fit_transform_jit(0.5, 1.0, scores, labels, **fit_kw)
    ta, tb, tn = T.fit_transform(0.5, 1.0, scores, labels, **fit_kw)
    assert tn == int(jn)
    assert _stop_margin(scores, labels, priors, w, mode == "prior_aware",
                        lr, n_max, tol) > 1e-6
    np.testing.assert_allclose([float(ta), float(tb)],
                               [float(ja), float(jb)], rtol=RTOL, atol=0)

    j = JaxTransform(alpha=0.5, beta=1.0, base_rate=0.05)
    t = BayesianProbabilityTransform(alpha=0.5, beta=1.0, base_rate=0.05,
                                     device="cpu")
    j.fit(scores, labels, **kw)
    t.fit(scores, labels, **kw)
    _assert_state(j, t)
    np.testing.assert_allclose(
        t.score_to_probability(scores, tfs, dlr),
        j.score_to_probability(scores, tfs, dlr), rtol=RTOL, atol=0)


@pytest.mark.parametrize("mode, n_max, want_n", [
    ("balanced", 2500, 965), ("prior_aware", 600, 600)])
def test_fit_float32_matches_jax(mode, n_max, want_n):
    """``fit(dtype=torch.float32)`` against JAX's ``fit_transform`` with
    x64 off, float32 throughout in both. They differ only in summation
    order, an ulp of a mean per step, so alpha and beta are held to rtol
    1e-6 (8 float32 ulps; measured at most 2.6e-7). One fit converges
    (tolerance 1e-4, every step 1e-3 from it) and one is capped; the
    iteration counts are equal."""
    scores, labels, tfs, dlr, weights = _data(n=1000)
    lr, tol = 0.05, 1e-4
    prior_aware = mode == "prior_aware"
    with jax.enable_x64(False):
        priors = (np.asarray(JT.composite_prior(tfs, dlr)) if prior_aware
                  else None)
        ja, jb, jn = JT.fit_transform_jit(
            0.5, 1.0, scores, labels, prior_aware=prior_aware,
            priors=priors, sample_weights=weights, learning_rate=lr,
            max_iterations=n_max, tolerance=tol)
    assert ja.dtype == np.float32 and int(jn) == want_n
    t = BayesianProbabilityTransform(alpha=0.5, beta=1.0, device="cpu")
    kw = dict(tfs=tfs, doc_len_ratios=dlr) if prior_aware else {}
    t.fit(scores, labels, mode=mode, learning_rate=lr, max_iterations=n_max,
          tolerance=tol, sample_weights=weights, dtype=torch.float32, **kw)
    _, _, tn = T.fit_transform(0.5, 1.0, scores, labels,
                               prior_aware=prior_aware, priors=priors,
                               sample_weights=weights, learning_rate=lr,
                               max_iterations=n_max, tolerance=tol,
                               dtype=torch.float32)
    assert tn == want_n
    assert _stop_margin(scores, labels, priors, weights, prior_aware, lr,
                        n_max, tol, torch.float32) > 1e-3
    np.testing.assert_allclose([t.alpha, t.beta], [float(ja), float(jb)],
                               rtol=1e-6, atol=0)


def test_fit_iteration_counts_when_converged_and_capped():
    """One input that converges (count below the cap) and one that hits
    the cap, with equal counts in both packages."""
    scores, labels, _, _, _ = _data(seed=1, n=800)
    counts = []
    for lr, n_max in ((0.05, 4000), (0.01, 150)):
        kw = dict(prior_aware=False, learning_rate=lr, max_iterations=n_max,
                  tolerance=1e-6)
        _, _, jn = JT.fit_transform_jit(0.5, 1.0, scores, labels, **kw)
        _, _, tn = T.fit_transform(0.5, 1.0, scores, labels, **kw)
        assert tn == int(jn)
        assert _stop_margin(scores, labels, None, None, False, lr, n_max,
                            1e-6) > 1e-6
        counts.append(tn)
    assert counts[0] < 4000 and counts[1] == 150


def _updates(kind):
    """(score, label, kwargs) for each step of an update sequence: every
    fourth step a single observation, the others mini-batches of 25."""
    scores, labels, tfs, dlr, _ = _data(seed=2, n=2000)
    steps = []
    for i in range(30):
        sl = slice(i * 25, i * 25 + (25 if i % 4 else 1))
        if kind == "modes":
            # Switch modes (None keeps the current one); tf and the
            # document length only enter under prior_aware.
            mode = (None, "prior_aware", "prior_free", "balanced",
                    "prior_aware", None)[i % 6]
            steps.append((scores[sl], labels[sl], dict(
                mode=mode, learning_rate=0.2, tf=tfs[sl],
                doc_len_ratio=dlr[sl])))
        elif kind == "floor":
            # Labels against the scores push alpha down onto its floor.
            steps.append((scores[sl], 1.0 - labels[sl],
                          dict(learning_rate=5.0, max_grad_norm=10.0)))
        else:
            # Far-off scores: gradients far above the clip norm.
            steps.append((scores[sl] * 20.0, labels[sl],
                          dict(learning_rate=0.5, max_grad_norm=0.05,
                               momentum=0.5, decay_tau=50.0)))
    # A scalar observation (tf and the length used only under prior_aware).
    steps.append((3.7, 1.0, dict(tf=4.0, doc_len_ratio=0.8)))
    return steps


@pytest.mark.parametrize("kind", ["modes", "floor", "clip"])
def test_update_sequence_matches_jax(kind):
    j = JaxTransform(alpha=0.8, beta=2.0, base_rate=0.05)
    t = BayesianProbabilityTransform(alpha=0.8, beta=2.0, base_rate=0.05,
                                     device="cpu")
    params = [(t.alpha, t.beta)]
    for score, label, kw in _updates(kind):
        j.update(score, label, **kw)
        t.update(score, label, **kw)
        _assert_state(j, t)
        params.append((t.alpha, t.beta))
    alphas = [a for a, _ in params]
    if kind == "floor":
        assert min(alphas) == mathx.ALPHA_MIN
    if kind == "clip":
        # A clipped step moves (alpha, beta) by at most lr * clip norm.
        steps = np.hypot(*np.diff(np.array(params), axis=0).T)
        assert steps.max() <= 0.5 * 0.05 * (1 + 1e-12)
        assert steps.max() >= 0.5 * 0.05 / (1 + 1 / 50.0) * 0.999


def test_temporal_matches_jax():
    scores, labels, tfs, dlr, _ = _data(seed=3, n=1500)
    ts = np.arange(1500, dtype=np.float64) * 3.0
    j = JaxTemporal(alpha=0.5, beta=1.0, base_rate=0.1, decay_half_life=400)
    t = TemporalBayesianTransform(alpha=0.5, beta=1.0, base_rate=0.1,
                                  decay_half_life=400, device="cpu")
    kw = dict(timestamps=ts, learning_rate=0.05, max_iterations=600)
    j.fit(scores, labels, **kw)
    t.fit(scores, labels, **kw)
    _assert_state(j, t)
    for i in range(20):
        sl = slice(i * 30, i * 30 + 30)
        j.update(scores[sl], labels[sl], learning_rate=0.1)
        t.update(scores[sl], labels[sl], learning_rate=0.1)
        _assert_state(j, t, exact=("_training_mode", "_n_updates",
                                   "_timestamp", "_decay_half_life"))
    assert t.timestamp == 20 and t.decay_half_life == 400.0
    # Without timestamps the temporal fit is the plain one.
    p = BayesianProbabilityTransform(alpha=0.5, beta=1.0, device="cpu")
    q = TemporalBayesianTransform(alpha=0.5, beta=1.0, device="cpu")
    p.fit(scores, labels, max_iterations=50)
    q.fit(scores, labels, max_iterations=50)
    assert (p.alpha, p.beta) == (q.alpha, q.beta)
    with pytest.raises(ValueError, match="decay_half_life"):
        TemporalBayesianTransform(decay_half_life=0.0, device="cpu")


@pytest.mark.parametrize("temporal", [False, True])
def test_state_carried_from_jax(temporal):
    """convert.transform_*: a JAX transform's whole state continues in
    the port exactly as in JAX."""
    scores, labels, tfs, dlr, _ = _data(seed=4, n=600)
    j = (JaxTemporal(0.7, 1.5, 0.02, decay_half_life=50.0) if temporal
         else JaxTransform(0.7, 1.5, 0.02))
    for i in range(5):
        j.update(scores[i * 10:i * 10 + 10], labels[i * 10:i * 10 + 10],
                 mode="prior_aware", tf=tfs[:10], doc_len_ratio=dlr[:10])
    t = convert.transform_from_numpy(convert.transform_to_numpy(j), "cpu")
    assert isinstance(t, TemporalBayesianTransform) == temporal
    exact = ("_training_mode", "_n_updates", "base_rate")
    if temporal:
        exact += ("_timestamp", "_decay_half_life", "_decay_rate")
    _assert_state(j, t, exact)
    for i in range(5, 10):
        sl = slice(i * 10, i * 10 + 10)
        j.update(scores[sl], labels[sl], tf=tfs[sl], doc_len_ratio=dlr[sl])
        t.update(scores[sl], labels[sl], tf=tfs[sl], doc_len_ratio=dlr[sl])
    _assert_state(j, t, exact)


def test_static_pieces_match_jax():
    scores, _, tfs, dlr, _ = _data(seed=5, n=512)
    dlr[:8] = 0.5
    p = np.linspace(0.0, 1.0, 512)
    j = JaxTransform(alpha=1.3, beta=3.0, base_rate=0.02)
    t = BayesianProbabilityTransform(alpha=1.3, beta=3.0, base_rate=0.02,
                                     device="cpu")
    pairs = [
        (t.likelihood(scores), j.likelihood(scores)),
        (t.tf_prior(tfs), j.tf_prior(tfs)),
        (t.norm_prior(dlr), j.norm_prior(dlr)),
        (t.composite_prior(tfs, dlr), j.composite_prior(tfs, dlr)),
        (t.posterior(p, p[::-1], 0.1), j.posterior(p, p[::-1], 0.1)),
        (t.posterior(p, 0.7), j.posterior(p, 0.7)),
        (t.wand_upper_bound(scores), j.wand_upper_bound(scores)),
        (t.wand_upper_bound(scores, p_max=0.6),
         j.wand_upper_bound(scores, p_max=0.6)),
        (tprob.sigmoid(scores - 4.0, "cpu"), jprob.sigmoid(scores - 4.0)),
        (tprob.logit(p, "cpu"), jprob.logit(p)),
    ]
    for got, want in pairs:
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    for got, want in ((t.likelihood(2.0), j.likelihood(2.0)),
                      (tprob.sigmoid(0.3, "cpu"), jprob.sigmoid(0.3)),
                      (t.wand_upper_bound(7.5), j.wand_upper_bound(7.5))):
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert (t.averaged_alpha, t.averaged_beta) == (1.3, 3.0)


def test_validation_matches_jax():
    t = BayesianProbabilityTransform(device="cpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        t.fit([1.0], [1.0], mode="bogus")
    with pytest.raises(ValueError, match="required when mode='prior_aware'"):
        t.fit([1.0], [1.0], mode="prior_aware")
    with pytest.raises(ValueError, match="required when mode='prior_aware'"):
        t.update(1.0, 1.0, mode="prior_aware")
    t.fit([1.0, 3.0], [0.0, 1.0], mode="prior_free", max_iterations=3)
    assert t._training_mode == "prior_free"
    # prior_free ignores tf and the document length, as in JAX.
    j = JaxTransform(t.alpha, t.beta)
    j._training_mode = "prior_free"
    assert t.score_to_probability(2.0, 9.0, 0.5) == pytest.approx(
        j.score_to_probability(2.0, 0.0, 3.0), rel=RTOL)
