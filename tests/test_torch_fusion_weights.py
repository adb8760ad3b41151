"""PyTorch port: the fusion weight models (``LearnableLogOddsWeights``,
``AttentionLogOddsWeights``, ``MultiHeadAttentionLogOddsWeights``) and
``ops/gd`` against the JAX package.

Both packages start from the same state (zeros, or the attention
init's numpy stream, which is the same in both), take the same
numpy-seeded inputs and run the same hand-written gradients. JAX runs
with x64 and the port in float64 on the CPU. Each fit must take the
same number of steps in both, and every parameter, gradient EMA and
Polyak average is held to rtol 1e-9 (atol 1e-15 for entries that
start at zero): the two differ only in summation order and in the last
bit of a library exp or sigmoid per step.
"""

import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
from bayesian_bm25_tpu.ops import fusion_learn as JFL
from bayesian_bm25_tpu.ops.mathx import logit as jlogit
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu_torch.ops import fusion_learn as TFL
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401

RTOL, ATOL = 1e-9, 1e-15
CPU = dict(device="cpu")


def _data(seed=0, n=240, n_signals=3, n_qf=4, n_queries=12):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(float)
    good = np.clip(np.where(labels == 1, 0.85, 0.15)
                   + rng.normal(0, 0.08, n), 0.01, 0.99)
    probs = np.column_stack([good, rng.uniform(0.05, 0.95,
                                               (n, n_signals - 1))])
    qids = rng.integers(0, n_queries, n)
    qf = rng.normal(0, 1, (n_queries, n_qf))[qids]
    return probs, labels, qf, qids


def _state(model):
    return convert.weights_to_numpy(model)


def _assert_same(t, j):
    ts, js = _state(t), _state(j)
    assert ts.keys() == js.keys()
    for name, want in js.items():
        got = ts[name]
        if name == "heads":
            for a, b in zip(got, want):
                _assert_same_state(a, b)
        else:
            _assert_value(name, got, want)


def _assert_same_state(ts, js):
    for name, want in js.items():
        _assert_value(name, ts[name], want)


def _assert_value(name, got, want):
    if isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12), name
    else:
        assert got == want, name


# (learning rate, step cap, tolerance): a fit that stops at the cap and
# one that converges below it.
CAPPED = (0.5, 300, 1e-6)
CONVERGED = (2.0, 1000, 1e-3)


@pytest.mark.parametrize("alpha, base_rate, fit", [
    (0.0, None, CAPPED), ("auto", 0.2, CONVERGED)])
def test_learnable_matches_jax(alpha, base_rate, fit):
    probs, labels, _, _ = _data()
    j = jbb.LearnableLogOddsWeights(3, alpha=alpha, base_rate=base_rate)
    t = tbb.LearnableLogOddsWeights(3, alpha=alpha, base_rate=base_rate,
                                    **CPU)
    kw = dict(zip(("learning_rate", "max_iterations", "tolerance"), fit))
    j.fit(probs[:160], labels[:160], **kw)
    t.fit(probs[:160], labels[:160], **kw)
    _, jn = JFL.learnable_fit(np.zeros(3), probs[:160], labels[:160],
                              3 ** j.alpha, j._logit_base_rate, **kw)
    assert t._fit_iterations == int(jn)
    assert (int(jn) < kw["max_iterations"]) == (fit is CONVERGED)
    _assert_same(t, j)
    for i in range(160, 240, 10):
        # single observations and mini-batches of 9
        sl = slice(i, i + (1 if i % 20 else 9))
        for m in (j, t):
            m.update(probs[sl][0] if i % 20 else probs[sl],
                     labels[sl][0] if i % 20 else labels[sl],
                     learning_rate=0.3, momentum=0.8, decay_tau=20.0,
                     max_grad_norm=0.5)
        _assert_same(t, j)
    np.testing.assert_allclose(t.weights, j.weights, rtol=RTOL)
    np.testing.assert_allclose(t.averaged_weights, j.averaged_weights,
                               rtol=RTOL)
    for use_avg in (False, True):
        np.testing.assert_allclose(t(probs, use_avg), j(probs, use_avg),
                                   rtol=RTOL)
        got = t(probs[0], use_avg)
        assert isinstance(got, float)
        assert got == pytest.approx(j(probs[0], use_avg), rel=RTOL)
    with pytest.raises(ValueError, match="n_signals"):
        t(probs[:, :2])


@pytest.mark.parametrize("normalize, by_query, fit", [
    (False, False, CAPPED), (True, False, CONVERGED), (True, True, CAPPED)])
def test_attention_matches_jax(normalize, by_query, fit):
    probs, labels, qf, qids = _data(seed=1)
    j = jbb.AttentionLogOddsWeights(3, 4, normalize=normalize, seed=3,
                                    base_rate=0.1)
    t = tbb.AttentionLogOddsWeights(3, 4, normalize=normalize, seed=3,
                                    base_rate=0.1, **CPU)
    np.testing.assert_array_equal(t.weights_matrix, j.weights_matrix)
    kw = dict(zip(("learning_rate", "max_iterations", "tolerance"), fit))
    q = dict(query_ids=qids[:200] if by_query else None)
    j.fit(probs[:200], labels[:200], qf[:200], **q, **kw)
    t.fit(probs[:200], labels[:200], qf[:200], **q, **kw)
    seg = np.unique(qids[:200], return_inverse=True)[1] if by_query else None
    _, jn = JFL.attention_fit(
        JFL.attention_init(3, 4, 3), probs[:200], labels[:200], qf[:200],
        3 ** 0.5, j._logit_base_rate, normalize=normalize, segment_ids=seg,
        num_segments=None if seg is None else int(seg.max()) + 1, **kw)
    assert t._fit_iterations == int(jn)
    assert (int(jn) < kw["max_iterations"]) == (fit is CONVERGED)
    _assert_same(t, j)
    for i in range(200, 240, 8):
        for m in (j, t):
            m.update(probs[i:i + 8], labels[i:i + 8], qf[i:i + 8],
                     learning_rate=0.2, decay_tau=30.0)
        _assert_same(t, j)
    for use_avg in (False, True):
        np.testing.assert_allclose(t(probs[:50], qf[:50], use_avg),
                                   j(probs[:50], qf[:50], use_avg),
                                   rtol=RTOL)
        one = t(probs[7], qf[7], use_avg)
        assert isinstance(one, float)
        assert one == pytest.approx(j(probs[7], qf[7], use_avg), rel=RTOL)
        np.testing.assert_allclose(
            t._compute_weights(qf[:9], use_avg),
            j._compute_weights(qf[:9], use_avg), rtol=RTOL)
    ub = np.clip(probs[:60] + 0.05, 0, 0.99)
    np.testing.assert_allclose(t.compute_upper_bounds(ub, qf[:60]),
                               j.compute_upper_bounds(ub, qf[:60]),
                               rtol=RTOL)
    for thr in (0.4, 0.7, 1.0):
        (ti, tp), (ji, jp) = (m.prune(probs[:60], qf[:60], thr, ub)
                              for m in (t, j))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tp, jp, rtol=RTOL)


def test_multi_head_matches_jax():
    probs, labels, qf, qids = _data(seed=2)
    j = jbb.MultiHeadAttentionLogOddsWeights(4, 3, 4, normalize=True)
    t = tbb.MultiHeadAttentionLogOddsWeights(4, 3, 4, normalize=True, **CPU)
    _assert_same(t, j)
    kw = dict(query_ids=qids[:200], learning_rate=0.5, max_iterations=150)
    j.fit(probs[:200], labels[:200], qf[:200], **kw)
    t.fit(probs[:200], labels[:200], qf[:200], **kw)
    _assert_same(t, j)
    for m in (j, t):
        m.update(probs[200:220], labels[200:220], qf[200:220],
                 learning_rate=0.1)
    _assert_same(t, j)
    for use_avg in (False, True):
        np.testing.assert_allclose(t(probs[:40], qf[:40], use_avg),
                                   j(probs[:40], qf[:40], use_avg),
                                   rtol=RTOL)
    assert t(probs[3], qf[3]) == pytest.approx(j(probs[3], qf[3]), rel=RTOL)
    ub = np.clip(probs[:40] + 0.1, 0, 0.99)
    np.testing.assert_allclose(t.compute_upper_bounds(ub, qf[:40]),
                               j.compute_upper_bounds(ub, qf[:40]),
                               rtol=RTOL)
    (ti, tp), (ji, jp) = (m.prune(probs[:40], qf[:40], 0.6, ub)
                          for m in (t, j))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=RTOL)


def test_attention_gradients_match_jax():
    """``_attention_grads`` and ``_learnable_grads`` on the same
    parameters (the mirror of test_gradients_extra's finite-difference
    check, which holds the JAX gradients to the BCE)."""
    rng = np.random.default_rng(0)
    m, n_sig, n_qf = 30, 3, 2
    probs = rng.uniform(0.1, 0.9, (m, n_sig))
    labels = rng.integers(0, 2, m).astype(float)
    qf = rng.normal(0, 1, (m, n_qf))
    W, b = rng.normal(0, 0.5, (n_sig, n_qf)), rng.normal(0, 0.2, n_sig)
    x = np.array(jlogit(probs))
    jg = JFL._attention_grads(JFL.AttentionParams(W, b), x, labels, qf,
                              n_sig ** 0.5, -1.3)
    tg = TFL._attention_grads(
        TFL.AttentionParams(torch.from_numpy(W), torch.from_numpy(b)),
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(qf),
        n_sig ** 0.5, -1.3)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(
        TFL._learnable_grads(torch.from_numpy(b), torch.from_numpy(x),
                             torch.from_numpy(labels), 1.7, None).numpy(),
        np.asarray(JFL._learnable_grads(b, x, labels, 1.7, None)),
        rtol=RTOL)


@pytest.mark.parametrize("kind", ["learnable", "attention", "multi_head"])
def test_state_carried_from_jax(kind):
    """convert.weights_*: a JAX model's whole state continues in the
    port exactly as in JAX."""
    probs, labels, qf, _ = _data(seed=4)
    j = {"learnable": lambda: jbb.LearnableLogOddsWeights(3, base_rate=0.3),
         "attention": lambda: jbb.AttentionLogOddsWeights(3, 4, seed=9),
         "multi_head": lambda: jbb.MultiHeadAttentionLogOddsWeights(2, 3, 4),
         }[kind]()
    args = (lambda i: (probs[i:i + 5], labels[i:i + 5])
            if kind == "learnable"
            else (probs[i:i + 5], labels[i:i + 5], qf[i:i + 5]))
    for i in range(0, 25, 5):
        j.update(*args(i), learning_rate=0.2)
    t = convert.weights_from_numpy(convert.weights_to_numpy(j), "cpu")
    assert type(t).__name__ == type(j).__name__
    _assert_same(t, j)
    for i in range(25, 50, 5):
        j.update(*args(i), learning_rate=0.2)
        t.update(*args(i), learning_rate=0.2)
    _assert_same(t, j)


def test_validation_and_default_device():
    for cls, args in ((tbb.LearnableLogOddsWeights, (0,)),
                      (tbb.AttentionLogOddsWeights, (2, 0)),
                      (tbb.MultiHeadAttentionLogOddsWeights, (0, 2, 2))):
        with pytest.raises(ValueError, match=">= 1"):
            cls(*args, **CPU)
    with pytest.raises(ValueError, match="base_rate"):
        tbb.LearnableLogOddsWeights(2, base_rate=1.0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbb.AttentionLogOddsWeights(2, 3)   # device="cuda" by default
