"""PyTorch port: BayesianBM25Scorer(device="cpu") against the JAX scorer
through the public entry points: index, retrieve, retrieve_many.

With alpha, beta and base_rate pinned, both scorers build their own
index from the same corpus: ids equal, probabilities within 1e-6 (the
port's transform in float64, as the JAX package computes under x64;
float32 separately at the 2e-5 that a 0.01 base rate allows, see
test_torch_transform.py). Auto calibration: alpha and beta within rtol
1e-5 and the pseudo-query scores within rtol 1e-6 (both are exact in
practice: the same int8 products and fused epilogue).
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu_torch import BayesianBM25Scorer

from torch_helpers import one_thread  # noqa: F401


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=60, V=900):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    return qs + [["t1", "t1", "t2"], ["zzz-oov"], [], [f"t{V - 1}"]]


CORPUS = _corpus()
QUERIES = _queries()


@pytest.fixture
def small_budget(monkeypatch):
    """A small split budget (K = 128 frequent terms) so the 800-doc
    corpus has a real rare tail, in both packages."""
    for cls in (JaxScorer, BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)


def _pinned(storage="int8", prob_dtype=torch.float64, corpus=CORPUS):
    kw = dict(alpha=0.8, beta=1.0, base_rate=0.01, impact_storage=storage)
    j = JaxScorer(**kw)
    j.index(corpus, show_progress=False)
    t = BayesianBM25Scorer(**kw, device="cpu", prob_dtype=prob_dtype)
    t.index(corpus, show_progress=False)
    return j, t


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_pinned_retrieve(small_budget, storage):
    j, t = _pinned(storage)
    assert t._split.n_frequent == j._split.n_frequent == 128
    ji, jp = j.retrieve(QUERIES, k=10)
    ti, tp = t.retrieve(QUERIES, k=10)
    assert ti.dtype == np.int32 and tp.dtype == np.float64
    assert ti.shape == tp.shape == (len(QUERIES), 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def test_pinned_retrieve_float32(small_budget):
    j, t = _pinned(prob_dtype=torch.float32)
    ji, jp = j.retrieve(QUERIES, k=10)
    ti, tp = t.retrieve(QUERIES, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-5)
    assert ((tp >= 0) & (tp < 1)).all()


def test_retrieve_many_and_edges(small_budget):
    j, t = _pinned()
    batches = [QUERIES[:7], QUERIES[7:40], [QUERIES[3]], [[]], [["zzz-oov"]]]
    outs_t = t.retrieve_many(batches, k=10)
    outs_j = j.retrieve_many(batches, k=10)
    assert len(outs_t) == len(batches)
    for (ti, tp), (ji, jp), qb in zip(outs_t, outs_j, batches):
        assert ti.shape == (len(qb), 10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    # retrieve_many equals per-batch retrieve (batch of 1 included: the
    # int8 product pads its rows)
    for (ti, tp), qb in zip(outs_t, batches):
        ri, rp = t.retrieve(qb, k=10)
        np.testing.assert_array_equal(ri, ti)
        np.testing.assert_array_equal(rp, tp)
    # empty / OOV queries score 0 everywhere: probability 0
    assert (outs_t[3][1] == 0).all() and (outs_t[4][1] == 0).all()
    assert t.retrieve_many([], k=10) == []
    ei, ep = t.retrieve([], k=10)
    assert ei.shape == ep.shape == (0, 10)
    (ei, ep), = t.retrieve_many([[]], k=10)
    assert ei.shape == (0, 10)


def test_k_above_num_docs(small_budget):
    corpus = _corpus(seed=3, D=300)
    j, t = _pinned(corpus=corpus)
    ji, jp = j.retrieve(QUERIES[:9], k=400)
    ti, tp = t.retrieve(QUERIES[:9], k=400)
    assert ti.shape == (9, 300)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def test_auto_chunking(small_budget, monkeypatch):
    """Batches past the score-matrix budget run in launched chunks."""
    for cls in (JaxScorer, BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SCORES_BUDGET_BYTES", 256 * 2048 * 4)
    j, t = _pinned()
    assert t._auto_batch_size() == j._auto_batch_size() == 256
    qs = (QUERIES * 5)[:300]
    ji, jp = j.retrieve(qs, k=5)
    ti, tp = t.retrieve(qs, k=5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    (mi, mp), = t.retrieve_many([qs], k=5)
    np.testing.assert_array_equal(mi, ti)
    np.testing.assert_array_equal(mp, tp)


def test_doc_mask(small_budget):
    j, t = _pinned()
    mask = np.ones(800, bool)
    mask[::2] = False
    ji, jp = j.retrieve(QUERIES, k=10, doc_mask=mask)
    ti, tp = t.retrieve(QUERIES, k=10, doc_mask=mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert mask[ti[ti >= 0]].all()


@pytest.mark.parametrize("storage", ["int8", "hilo"])
@pytest.mark.parametrize("method", ["percentile", "mixture", "elbow"])
def test_auto_calibration(small_budget, storage, method):
    kw = dict(base_rate="auto", base_rate_method=method,
              impact_storage=storage)
    j = JaxScorer(**kw)
    j.index(CORPUS, show_progress=False)
    t = BayesianBM25Scorer(**kw, device="cpu")
    t.index(CORPUS, show_progress=False)
    np.testing.assert_allclose(t.transform.alpha, j.transform.alpha,
                               rtol=1e-5)
    np.testing.assert_allclose(t.transform.beta, j.transform.beta,
                               rtol=1e-5)
    np.testing.assert_allclose(t.base_rate, j.base_rate, rtol=1e-5)
    pj = j._sample_pseudo_query_scores(CORPUS)
    pt = t._sample_pseudo_query_scores(CORPUS)
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_validation_and_unported_paths(small_budget):
    with pytest.raises(ValueError):
        BayesianBM25Scorer(method="bogus", device="cpu")
    with pytest.raises(ValueError):
        BayesianBM25Scorer(impact_storage="fp8", device="cpu")
    with pytest.raises(ValueError):
        BayesianBM25Scorer(matmul_precision="fast", device="cpu")
    with pytest.raises(ValueError):
        BayesianBM25Scorer(delta=0.0, device="cpu")
    with pytest.raises(ValueError):
        BayesianBM25Scorer(prob_dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BayesianBM25Scorer()             # device="cuda" is the default
    t = BayesianBM25Scorer(device="cpu")
    with pytest.raises(RuntimeError):
        t.retrieve(QUERIES[:2])
    # A vocabulary of at most 256 terms takes the doc-major path.
    tiny = [[f"w{i % 50}" for i in range(d, d + 20)] for d in range(40)]
    t.index(tiny)
    assert t._split is None and t.num_docs == 40
    _, t = _pinned()
    # explain=True: the same ids and probabilities, with one trace per
    # rank whose posterior is the probability (the trace reads the
    # length ratio in float32, as JAX's does, and the retrieval does
    # not: 4e-8 apart).
    res = t.retrieve(QUERIES[:2], explain=True)
    ids, probs = t.retrieve(QUERIES[:2])
    np.testing.assert_array_equal(res.doc_ids, ids)
    np.testing.assert_array_equal(res.probabilities, probs)
    post = [[tr.posterior for tr in row] for row in res.explanations]
    np.testing.assert_allclose(post, probs, rtol=1e-6)
    # approx=True selects exactly (engine/split_index.py docstring).
    np.testing.assert_array_equal(t.retrieve(QUERIES[:2], approx=True)[0],
                                  t.retrieve(QUERIES[:2])[0])
    with pytest.raises(ValueError):
        t.retrieve(QUERIES[:2], doc_mask=np.ones(3, bool))


def _shapes(out):
    """(shape, dtype) of every array in a result tree."""
    if isinstance(out, (list, tuple)):
        return [_shapes(o) for o in out]
    return (out.shape, out.dtype)


@pytest.mark.parametrize("path", ["split", "doc-major"])
def test_k_zero_returns_empty_results(small_budget, path):
    """k=0: every retrieval entry point returns (nq, 0) results, as the
    JAX package does, on the split path and the doc-major path;
    retrieve_thresholded still counts the passing docs. k < 0 raises in
    both packages."""
    corpus = CORPUS if path == "split" else _corpus(V=200)
    j, t = _pinned(corpus=corpus)
    assert (t._split is None) == (j._split is None) == (path == "doc-major")
    qs = QUERIES[:5]
    for name, call in (
            ("retrieve", lambda s: s.retrieve(qs, k=0)),
            ("retrieve_many",
             lambda s: s.retrieve_many([qs, qs[:2]], k=0)),
            ("retrieve_stream",
             lambda s: list(s.retrieve_stream([qs, qs[:2]], k=0))),
            ("retrieve_thresholded",
             lambda s: s.retrieve_thresholded(qs, 0.5, k=0))):
        got, want = call(t), call(j)
        assert _shapes(got) == _shapes(want), name
    np.testing.assert_array_equal(t.retrieve_thresholded(qs, 0.5, k=0)[2],
                                  j.retrieve_thresholded(qs, 0.5, k=0)[2])
    assert t.retrieve(qs, k=0)[0].shape == (5, 0)
    for s in (j, t):
        with pytest.raises(ValueError):
            s.retrieve(qs, k=-1)


@pytest.mark.parametrize("storage", ["hilo", "bf16", "int8", "f32"])
def test_counts_above_256_follow_jax(small_budget, storage):
    """A count of 257 under hilo and bf16 storage scores as JAX scores
    it: the counts are cast to the storage dtype first (257 -> 256).
    int8 (whose counts above 127 take the dequantized product) and f32
    count it exactly, in both packages."""
    j, t = _pinned(storage)
    assert t._split.n_frequent == j._split.n_frequent == 128
    qs = [["t40"] * 257 + ["t850"], ["t40"] * 3, QUERIES[0]]
    js, ts = j.get_scores_batch(qs), t.get_scores_batch(qs)
    np.testing.assert_array_equal(ts, js)
    ji, jp = j.retrieve(qs, k=10)
    ti, tp = t.retrieve(qs, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    # The cast shows: 257 counts as 256 under bf16 storage only.
    s257 = t.get_scores_batch([["t40"] * 257])[0]
    s256 = t.get_scores_batch([["t40"] * 256])[0]
    assert np.array_equal(s257, s256) == (storage in ("hilo", "bf16"))
