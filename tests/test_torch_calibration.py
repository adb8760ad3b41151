"""PyTorch port: ``PlattCalibrator``, ``IsotonicCalibrator``, the
calibration metrics and ``BlockMaxIndex`` against the JAX package.

The same numpy-seeded inputs go to both packages; JAX runs with x64 and
the port in float64 on the CPU. Tolerances:
  * Platt's gradient-descent fit: rtol 1e-9, with equal step counts;
  * calibrated values, ECE, Brier, log loss and the reliability
    diagram: rtol 1e-12 (the bin sums are sequential on the CPU in both
    packages; log loss is numpy's mean in JAX, torch's here);
  * block maxima and prune masks: bit-equal (maxima are exact, and the
    query bound adds the rows in the same order).
The summary text must equal JAX's character for character.
"""

import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine.block_max import BlockMaxIndex as JaxBMI
from bayesian_bm25_tpu.models.calibration import (
    IsotonicCalibrator as JaxIso, PlattCalibrator as JaxPlatt)
from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu_torch.engine import index as tidx

from torch_helpers import one_thread  # noqa: F401

CPU = dict(device="cpu")


def _judged(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    scores = rng.normal(0, 2, n)
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-(1.5 * scores - 0.5)))
              ).astype(float)
    return scores, labels


@pytest.mark.parametrize("lr, n_max", [(0.5, 3000), (0.05, 200)])
def test_platt_matches_jax(lr, n_max):
    """One fit that converges below its cap and one that stops at it."""
    scores, labels = _judged()
    j, t = JaxPlatt(0.5, -0.2), tbb.PlattCalibrator(0.5, -0.2, **CPU)
    for m in (j, t):
        m.fit(scores, labels, learning_rate=lr, max_iterations=n_max)
    np.testing.assert_allclose([t.a, t.b], [j.a, j.b], rtol=1e-9)
    assert (t._fit_iterations < n_max) == (n_max == 3000)
    s = np.linspace(-6, 6, 61)
    np.testing.assert_allclose(t.calibrate(s), j.calibrate(s), rtol=1e-12)
    assert isinstance(t(0.7), float)
    assert t(0.7) == pytest.approx(j(0.7), rel=1e-12)


def test_isotonic_matches_jax():
    scores, labels = _judged(seed=1, n=1500)
    scores = np.round(scores, 1)                 # ties in the scores
    j, t = JaxIso(), tbb.IsotonicCalibrator(**CPU)
    with pytest.raises(RuntimeError, match="fit"):
        t.calibrate(0.5)
    for m in (j, t):
        m.fit(scores, labels)
    np.testing.assert_array_equal(t._x.numpy(), j._x)
    np.testing.assert_array_equal(t._y.numpy(), j._y)
    s = np.concatenate([np.linspace(-9, 9, 181), j._x[:5], [np.inf]])
    np.testing.assert_allclose(t.calibrate(s), j.calibrate(s), rtol=1e-12)
    assert t(0.33) == pytest.approx(j(0.33), rel=1e-12)
    # Tied breakpoints (the midpoint rule) and a single block.
    for xs, ys in (([1.0, 1.0, 2.0, 3.0], [0.0, 1.0, 0.0, 1.0]),
                   ([1.0, 2.0, 3.0], [1.0, 1.0, 1.0])):
        j.fit(xs, ys)
        t.fit(xs, ys)
        for q in (0.0, 1.0, 1.5, 2.0, 5.0, [1.0, 2.5]):
            np.testing.assert_allclose(t.calibrate(q), j.calibrate(q),
                                       rtol=1e-12)


def _metric_inputs(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, 3000)
    p[:12] = [0.0, 0.1, 0.2, 0.3, 0.5, 0.9, 1.0, 1.0, 1e-16, 0.7, 0.4, 0.8]
    y = (rng.uniform(size=3000) < p ** 1.3).astype(float)
    return p, y


@pytest.mark.parametrize("n_bins", [10, 7])
def test_metrics_match_jax(n_bins):
    p, y = _metric_inputs(n_bins)
    for name in ("expected_calibration_error", "reliability_diagram"):
        got = getattr(tbb, name)(p, y, n_bins=n_bins, **CPU)
        want = getattr(jbb, name)(p, y, n_bins=n_bins)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(tbb.brier_score(p, y, **CPU),
                               jbb.brier_score(p, y), rtol=1e-12)
    np.testing.assert_allclose(tbb.log_loss(p, y, **CPU),
                               jbb.log_loss(p, y), rtol=1e-12)
    tr = tbb.calibration_report(p, y, n_bins=n_bins, **CPU)
    jr = jbb.calibration_report(p, y, n_bins=n_bins)
    assert isinstance(tr, tbb.CalibrationReport)
    assert (tr.n_samples, tr.n_bins) == (jr.n_samples, jr.n_bins)
    assert tr.summary() == jr.summary()
    # The bin rule: the first bin is closed, the rest (lo, hi].
    edges = np.array([0.0, 0.1, 0.2, 0.10000001])
    assert (tbb.reliability_diagram(edges, np.ones(4), **CPU)
            == jbb.reliability_diagram(edges, np.ones(4)))


def _matrix(seed, n_terms=7, n_docs=300):
    rng = np.random.default_rng(seed)
    m = rng.gamma(1.0, 2.0, (n_terms, n_docs))
    m[rng.uniform(size=m.shape) < 0.8] = 0.0
    return m


@pytest.mark.parametrize("block", [64, 128, 300, 7])
def test_block_max_build_matches_jax(block):
    m = _matrix(block)
    j, t = JaxBMI(block), tbb.BlockMaxIndex(block, **CPU)
    j.build(m)
    t.build(m)
    assert t.n_blocks == j.n_blocks and t.block_size == block
    np.testing.assert_array_equal(t.block_maxes, j.block_maxes)
    tr = tbb.BayesianProbabilityTransform(1.0, 1.0, 0.05, **CPU)
    jt = JaxTransform(1.0, 1.0, 0.05)
    last = t.n_blocks - 1
    assert t.block_upper_bound(3, last) == j.block_upper_bound(3, last)
    assert t.bayesian_block_upper_bound(3, last, tr) == pytest.approx(
        j.bayesian_block_upper_bound(3, last, jt), rel=1e-12)


def _corpus(seed=0, D=900, V=400, L=40):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.2, size=L) % V] for _ in range(D)]


def test_block_max_from_index_and_pruning_match_jax():
    """``from_bm25_index`` on the same corpus built by both packages,
    blocks of 64 (the last one partial); prune masks for 30 queries of
    2 to 9 terms (repeated terms counted twice) at four thresholds."""
    corpus = _corpus()
    jix = jidx.build_index(corpus)
    tix = tidx.build_index(corpus, device="cpu")
    j = JaxBMI.from_bm25_index(jix, block_size=64)
    t = tbb.BlockMaxIndex.from_bm25_index(tix, block_size=64, **CPU)
    assert t.block_maxes.dtype == np.float64
    np.testing.assert_array_equal(t.block_maxes, j.block_maxes)
    tr = tbb.BayesianProbabilityTransform(0.9, 2.0, 0.02, **CPU)
    jt = JaxTransform(0.9, 2.0, 0.02)
    rng = np.random.default_rng(3)
    for _ in range(30):
        terms = rng.integers(0, jix.n_terms, rng.integers(2, 10))
        terms[-1] = terms[0]
        np.testing.assert_array_equal(
            t.query_block_upper_bounds(terms, tr),
            j.query_block_upper_bounds(terms, jt))
        for thr in (0.1, 0.3, 0.5, 0.8):
            np.testing.assert_array_equal(t.prune_mask(terms, tr, thr),
                                          j.prune_mask(terms, jt, thr))


def test_validation_and_default_device():
    with pytest.raises(ValueError):
        tbb.BlockMaxIndex(block_size=0, **CPU)
    bmi = tbb.BlockMaxIndex(**CPU)
    with pytest.raises(ValueError):
        bmi.build(np.zeros(5))
    with pytest.raises(RuntimeError):
        bmi.block_upper_bound(0, 0)
    if not torch.cuda.is_available():
        # device="cuda" is the default of every numpy-facing class.
        for make in (tbb.BlockMaxIndex, tbb.PlattCalibrator,
                     tbb.IsotonicCalibrator, tbb.BayesianProbabilityTransform,
                     tbb.TemporalBayesianTransform,
                     lambda: tbb.brier_score([0.5], [1.0])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
