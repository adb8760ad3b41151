"""PyTorch port: the dense entry points of BayesianBM25Scorer(device="cpu")
against the JAX scorer: get_scores(_batch), get_probabilities(_batch),
retrieve_thresholded, and retrieve on the doc-major path and on a split
index whose rare postings exceed their budget.

Both scorers index the same corpus with alpha, beta and base_rate pinned
(auto calibration is checked on its own, alpha and beta within rtol
1e-5). Scores are bit-equal: the doc-major compare and the int8 split
scores are the same fused multiply-adds in the same order. Ids and
passing counts are equal; probabilities are within 1e-6, the port's
transform running in float64 as the JAX package's does under x64.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import scoring as tscoring
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401

ALPHA, BETA, BASE_RATE = 0.8, 1.0, 0.01
PROB_TOL = 1e-6


def _tokens(seed, n, V, L, a, prefix):
    rng = np.random.default_rng(seed)
    return [[f"{prefix}{t}" for t in rng.zipf(a, size=L) % V]
            for _ in range(n)]


# A 150-term vocabulary (doc-major) and a 900-term one (split index).
SMALL = _tokens(0, 400, 150, 50, 1.3, "w")
SMALL_Q = _tokens(1, 40, 150, 6, 1.3, "w") + [["w3"] * 3 + ["w90"] * 5,
                                              [], ["zzz-oov"]]
WIDE = _tokens(0, 800, 900, 80, 1.25, "t")
WIDE_Q = _tokens(1, 40, 900, 6, 1.3, "t") + [["t1"] * 3 + ["t800"] * 7,
                                             [], ["zzz-oov"]]


def _pinned(corpus, **kw):
    args = dict(alpha=ALPHA, beta=BETA, base_rate=BASE_RATE, **kw)
    j = JaxScorer(**args)
    j.index(corpus, show_progress=False)
    t = BayesianBM25Scorer(**args, device="cpu", prob_dtype=torch.float64)
    t.index(corpus, show_progress=False)
    return j, t


@pytest.fixture(scope="module")
def doc_major():
    j, t = _pinned(SMALL, method="bm25l")
    assert j._split is None and t._split is None
    return j, t


@pytest.fixture(scope="module")
def split_int8():
    """K = 128 frequent terms, so the 800-doc corpus has a rare tail."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JaxScorer, BayesianBM25Scorer):
            mp.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
        j, t = _pinned(WIDE, method="bm25l", impact_storage="int8")
    assert t._split.n_frequent == 128 and t._split.post_doc_ids is not None
    return j, t


def _assert_dense_equal(j, t, queries):
    js, ts = j.get_scores_batch(queries), t.get_scores_batch(queries)
    assert ts.dtype == np.float64 and ts.shape == (len(queries), t.num_docs)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(t.get_scores(queries[0]),
                                  j.get_scores(queries[0]))
    # bm25l: the nonoccurrence shift is in the public scores only
    internal = t._scores_internal(queries)
    np.testing.assert_array_equal(internal, j._scores_internal(queries))
    assert ((ts - internal)[0] > 0).all() and (ts[-2] == internal[-2]).all()
    jp = j.get_probabilities_batch(queries)
    tp = t.get_probabilities_batch(queries)
    assert tp.dtype == np.float64 and tp.shape == ts.shape
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(t.get_probabilities(queries[1]),
                               j.get_probabilities(queries[1]), rtol=0,
                               atol=PROB_TOL)
    assert (tp[:, :] >= 0).all() and (tp < 1).all() and (tp > 0).any()


def test_doc_major_dense_entry_points(doc_major):
    _assert_dense_equal(*doc_major, SMALL_Q)


def test_split_dense_entry_points(split_int8):
    _assert_dense_equal(*split_int8, WIDE_Q)


def test_doc_major_retrieve(doc_major):
    j, t = doc_major
    ji, jp = j.retrieve(SMALL_Q, k=10)
    ti, tp = t.retrieve(SMALL_Q, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    # approx has no effect on the doc-major path, as in the JAX package
    ai, _ = t.retrieve(SMALL_Q, k=10, approx=True)
    np.testing.assert_array_equal(ai, ji)
    mask = np.ones(t.num_docs, bool)
    mask[::3] = False
    ji, jp = j.retrieve(SMALL_Q, k=10, doc_mask=mask)
    ti, tp = t.retrieve(SMALL_Q, k=10, doc_mask=mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    assert mask[ti[ti >= 0]].all()
    (mi, mp), = t.retrieve_many([SMALL_Q], k=10)
    np.testing.assert_array_equal(mi, t.retrieve(SMALL_Q, k=10)[0])


@pytest.mark.parametrize("base_rate_method", ["percentile", "mixture"])
def test_doc_major_auto_calibration(base_rate_method):
    kw = dict(base_rate="auto", base_rate_method=base_rate_method)
    j = JaxScorer(**kw)
    j.index(SMALL, show_progress=False)
    t = BayesianBM25Scorer(**kw, device="cpu")
    t.index(SMALL, show_progress=False)
    assert t._split is None
    for got, want in ((t.transform.alpha, j.transform.alpha),
                      (t.transform.beta, j.transform.beta),
                      (t.base_rate, j.base_rate)):
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _spy(monkeypatch):
    """Record which of the port's thresholded finishes runs."""
    calls = []
    for name in ("thresholded_topk_pruned", "thresholded_topk_from_scores",
                 "thresholded_topk"):
        orig = getattr(tscoring, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(tscoring, name, wrapped)
    return calls


# (index, threshold, doc_mask?, the branch the port takes): WAND-pruned
# candidates, the dense finish of the score pass, the dense fallback
# (a threshold of 0 prunes nothing).
THRESHOLD_CASES = [
    ("doc_major", 0.0, False, "thresholded_topk"),
    ("doc_major", 0.2, False, "thresholded_topk_from_scores"),
    ("doc_major", 0.3, True, "thresholded_topk_pruned"),
    ("split_int8", 0.0, True, "thresholded_topk"),
    ("split_int8", 0.2, False, "thresholded_topk_from_scores"),
    ("split_int8", 0.5, False, "thresholded_topk_pruned"),
    ("split_int8", 0.5, True, "thresholded_topk_pruned"),
]


@pytest.mark.parametrize("index,threshold,masked,branch", THRESHOLD_CASES)
def test_retrieve_thresholded(request, monkeypatch, index, threshold, masked,
                              branch):
    j, t = request.getfixturevalue(index)
    queries = SMALL_Q if index == "doc_major" else WIDE_Q
    calls = _spy(monkeypatch)
    doc_mask = None
    if masked:
        doc_mask = np.ones(t.num_docs, bool)
        doc_mask[1::4] = False
    ji, jp, jn = j.retrieve_thresholded(queries, threshold, k=10,
                                        doc_mask=doc_mask)
    ti, tp, tn = t.retrieve_thresholded(queries, threshold, k=10,
                                        doc_mask=doc_mask)
    assert calls[0] == branch
    assert ti.dtype == np.int32 and tp.dtype == np.float64
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    assert (tn > 0).any() and (ti == -1).any()
    if masked:
        assert doc_mask[ti[ti >= 0]].all()


def test_retrieve_thresholded_chunks(monkeypatch, doc_major):
    """Batches past a quarter of the retrieve chunk run in chunks."""
    j, t = doc_major
    monkeypatch.setattr(t, "_auto_batch_size", lambda: 512)
    qs = (SMALL_Q * 4)[:150]
    ti, tp, tn = t.retrieve_thresholded(qs, 0.2, k=5)
    ji, jp, jn = j.retrieve_thresholded(qs, 0.2, k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    ei, ep, en = t.retrieve_thresholded([], 0.2, k=5)
    assert ei.shape == ep.shape == (0, 5) and en.shape == (0,)


def _over_budget_pair(enable_overflow):
    """Both packages on one split index whose postings were refused
    (budget 0): retrieval takes the dense compare tail."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsidx, tsidx):
            mp.setattr(mod, "_POSTINGS_MAX_ENTRIES", 0)
        split = jsidx.build_split_index(jidx.build_index(WIDE), 128,
                                        storage="int8",
                                        enable_overflow=enable_overflow)
    assert split.post_doc_ids is None
    assert (split.over_term_ids is not None) == enable_overflow
    j = JaxScorer(base_rate=BASE_RATE)
    j._index, j._split = split.base, split
    j._transform = JaxTransform(ALPHA, BETA, BASE_RATE)
    t = convert.scorer_from_numpy(
        convert.split_index_to_numpy(split), ALPHA, BETA, BASE_RATE,
        device="cpu", prob_dtype=torch.float64)
    return j, t


@pytest.mark.parametrize("enable_overflow", [False, True])
def test_over_budget_postings(enable_overflow):
    """The lean path (tf at the winners only) and the overflow path."""
    j, t = _over_budget_pair(enable_overflow)
    mask = np.ones(t.num_docs, bool)
    mask[::5] = False
    for doc_mask in (None, mask):
        nq, ji, jp, js, jt = j._retrieve_launch(WIDE_Q, 10, False, doc_mask)
        _, ti, tp, ts, tt = t._retrieve_launch(WIDE_Q, 10, False, doc_mask)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:nq])
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:nq])
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt)[:nq])
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp)[:nq], rtol=0,
                                   atol=PROB_TOL)
    ti, tp = t.retrieve(WIDE_Q, k=10)
    np.testing.assert_array_equal(ti, j.retrieve(WIDE_Q, k=10)[0])
    np.testing.assert_array_equal(t.get_scores_batch(WIDE_Q[:8]),
                                  j.get_scores_batch(WIDE_Q[:8]))
    # approx=True selects exactly, as lax.approx_max_k does on the CPU.
    np.testing.assert_array_equal(t.retrieve(WIDE_Q[:2], approx=True)[0],
                                  ti[:2])


def test_over_budget_through_the_constructor(monkeypatch):
    """A budget of 0 through the public constructor and index()."""
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 0)
    for cls in (JaxScorer, BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
    j, t = _pinned(WIDE, impact_storage="int8")
    assert t._split.post_doc_ids is None
    ji, jp = j.retrieve(WIDE_Q, k=10)
    ti, tp = t.retrieve(WIDE_Q, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
