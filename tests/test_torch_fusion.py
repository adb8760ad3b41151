"""PyTorch port: the fusion algebra (``ops/fusion``, ``api_fusion``, the
gates and the ``ops/mathx`` normalizations) against the JAX package.

Each case draws its inputs from a numpy seed and feeds the same arrays
to both packages. JAX runs with x64 (tests/conftest.py) and the port in
float64 on the CPU, so values are held to rtol 1e-12: the two differ
only where a library's exp, log or sigmoid rounds its last bit
differently, or where XLA contracts a multiply-add. Validation raises
the same ``ValueError`` in both, and the default device (the card) raises
without CUDA.
"""

import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
from bayesian_bm25_tpu.ops import fusion as JF
from bayesian_bm25_tpu.ops import mathx as JM
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu_torch.ops import fusion as TF
from bayesian_bm25_tpu_torch.ops import mathx as TM

RTOL = 1e-12
CPU = dict(device="cpu")


def _close(got, want):
    if np.ndim(want) == 0:
        assert isinstance(got, float)
    else:
        assert isinstance(got, np.ndarray) and got.shape == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _probs(seed, shape, lo=0.02, hi=0.98):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


@pytest.mark.parametrize("name, args", [
    ("cosine_to_probability", (np.linspace(-1.0, 1.0, 41),)),
    ("cosine_to_probability", (0.25,)),
    ("prob_not", (np.array([0.0, 1e-12, 0.1, 0.5, 0.9, 1.0]),)),
    ("prob_not", (0.3,)),
    ("prob_and", (_probs(0, (6, 3)),)),
    ("prob_and", (np.array([0.5, 0.4, 0.9]),)),
    ("prob_or", (_probs(1, (5, 4)),)),
    ("prob_or", (np.array([0.5, 1.0]),)),
    ("balanced_log_odds_fusion", (_probs(2, 100),
                                  np.random.default_rng(3).uniform(-1, 1, 100),
                                  0.3)),
    ("balanced_log_odds_fusion", (np.full(10, 0.7), np.linspace(-.5, .5, 10))),
])
def test_api_functions_match_jax(name, args):
    _close(getattr(tbb, name)(*args, **CPU), getattr(jbb, name)(*args))


@pytest.mark.parametrize("gating", ["none", "relu", "swish", "gelu",
                                    "softplus"])
@pytest.mark.parametrize("weighted", [False, True])
def test_log_odds_conjunction_matches_jax(gating, weighted):
    p = _probs(4, (64, 3), 1e-12, 1.0 - 1e-12)
    p[0] = [1.0, 0.0, 0.5]
    kw = dict(gating=gating, gating_beta=0.7)
    if weighted:
        kw.update(weights=np.array([0.2, 0.5, 0.3]), alpha="auto")
    _close(tbb.log_odds_conjunction(p, **kw, **CPU),
           jbb.log_odds_conjunction(p, **kw))
    _close(tbb.log_odds_conjunction(p[5], max_logit=2.0, **kw, **CPU),
           jbb.log_odds_conjunction(p[5], max_logit=2.0, **kw))


def test_gates_on_tensors_match_jax():
    """``ops/fusion.apply_gating`` on logits wide enough that softplus
    leaves F.softplus's identity range (beta * x > 20)."""
    x = np.linspace(-60.0, 60.0, 481)
    t = torch.from_numpy(x)
    for gating in TF.VALID_GATES:
        for beta in (0.5, 1.0, 3.0):
            got = TF.apply_gating(t, gating, beta)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(
                got.numpy(), np.asarray(JF.apply_gating(x, gating, beta)),
                rtol=RTOL, atol=1e-300)
    # The tensor functions keep the input's dtype.
    t32 = torch.tensor([0.2, 0.9], dtype=torch.float32)
    assert TF.prob_and(t32).dtype == torch.float32
    assert TF.log_odds_conjunction(t32).dtype == torch.float32


def test_normalizations_match_jax():
    rng = np.random.default_rng(5)
    z = rng.normal(0, 3, (7, 4))
    z[2] = 1.5                                   # a flat row
    x = torch.from_numpy(z)
    np.testing.assert_allclose(TM.stable_softmax(x, -1).numpy(),
                               np.asarray(JM.stable_softmax(z, -1)),
                               rtol=RTOL)
    np.testing.assert_array_equal(TM.min_max_normalize(x).numpy(),
                                  np.asarray(JM.min_max_normalize(z)))
    for dim in (0, 1):
        np.testing.assert_array_equal(
            TM.min_max_normalize(x, dim).numpy(),
            np.asarray(JM.min_max_normalize(z, dim)))
    seg = np.array([2, 0, 2, 1, 0, 2, 1])
    z[[3, 6]] = 4.0                             # segment 1 has a zero span
    np.testing.assert_array_equal(
        TM.segment_min_max_normalize(torch.from_numpy(z),
                                     torch.from_numpy(seg), 3).numpy(),
        np.asarray(JM.segment_min_max_normalize(z, seg, 3)))


def test_validation_matches_jax():
    p = np.array([0.8, 0.6])
    for kw in (dict(weights=np.array([-0.1, 1.1])),
               dict(weights=np.array([0.3, 0.3])), dict(alpha="bad"),
               dict(gating="tanh")):
        with pytest.raises(ValueError) as j:
            jbb.log_odds_conjunction(p, **kw)
        with pytest.raises(ValueError) as t:
            tbb.log_odds_conjunction(p, **kw, **CPU)
        assert str(t.value) == str(j.value)
    assert TF.resolve_alpha("auto", 0.0) == JF.resolve_alpha("auto", 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbb.prob_and(p)                      # device="cuda" by default


def test_package_surface_matches_jax():
    """The port exports every name of the JAX package's __all__, and
    each resolves (the heavier ones lazily)."""
    assert len(tbb.__all__) == 29
    assert set(tbb.__all__) == set(jbb.__all__)
    for name in tbb.__all__:
        assert getattr(tbb, name) is not None, name
    assert tbb.__version__ == jbb.__version__
    from bayesian_bm25_tpu_torch.parallel.sharded_scorer import (
        ShardedBayesianBM25Scorer)

    assert tbb.ShardedBayesianBM25Scorer is ShardedBayesianBM25Scorer
    with pytest.raises(AttributeError):
        tbb.NoSuchName
