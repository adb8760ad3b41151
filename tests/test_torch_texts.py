"""PyTorch port: the raw-text entry points against JAX.

``index_texts``, ``index_jsonl`` and ``retrieve_texts`` of the port
(device="cpu") and of the JAX scorer on the same seeded texts: the
vocabulary and index tables equal, ids bit-equal, alpha and beta from
calibration within rtol 1e-5 (as tests/test_torch_scorer.py holds them),
and probabilities within atol 1e-6 with the port's transform pinned to
the JAX one (float64 on both sides). Also ``add_documents`` after
``index_texts`` against ``index_texts(old + new)``, which must not
tokenize the corpus, ``retrieve_texts`` after a ``prior_free`` fit, and
the Python path that runs without the native library, counted as
fallbacks.
"""

import json
import os

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import native as tnative
from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts
from bayesian_bm25_tpu_torch.models.scorer import (_ChainedTokens,
                                                   _LazyTokens)
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401

MINI_BEIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "data", "mini_beir")
SUFFIXES = ["", "", "ing", "ies", "ational", "ness", "s", "ed", "ly"]
STOP = ["the", "of", "and", "a", "to", "in", "is", "it", "that", "with"]


def _words(vocab=1500):
    return [f"w{i}" + SUFFIXES[i % len(SUFFIXES)] for i in range(vocab)]


def _texts(seed, n, length=50, vocab=1500):
    """Seeded texts: Zipf(1.3) words with English suffixes, stopwords,
    mixed case and punctuation, so lowercasing, stopword removal and
    both stemmers all act."""
    rng = np.random.default_rng(seed)
    words = _words(vocab) + STOP
    out = []
    for _ in range(n):
        toks = [words[i] for i in rng.zipf(1.3, size=length) % len(words)]
        toks = [t.upper() if j % 9 == 0 else t.capitalize() if j % 4 == 0
                else t for j, t in enumerate(toks)]
        out.append(" ".join(toks) + ".")
    return out


TEXTS = _texts(0, 600)
QUERY_TEXTS = [" ".join(t.split()[:4]) for t in _texts(1, 60)] + [
    "", "zzz unknown words", "The RUNNING ing", TEXTS[3]]


@pytest.fixture
def small_budget(monkeypatch):
    """K = 128 frequent terms in both packages, so the corpus has a rare
    tail and retrieval takes the sparse-candidate merge."""
    for cls in (JaxScorer, BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)


def _scorers(kw, storage):
    kw = dict(kw, impact_storage=storage, base_rate=0.01)
    return (JaxScorer(**kw),
            BayesianBM25Scorer(**kw, device="cpu", prob_dtype=torch.float64))


def _pin(t, j):
    """Pin the port's transform to the JAX scorer's whole state."""
    t._transform = convert.transform_from_numpy(
        convert.transform_to_numpy(j.transform), "cpu")


def _check(j, t, queries, k=10):
    """Calibration within rtol 1e-5, then ids equal and probabilities
    within 1e-6 with the transform pinned."""
    np.testing.assert_allclose([t.transform.alpha, t.transform.beta],
                               [j.transform.alpha, j.transform.beta],
                               rtol=1e-5, atol=0)
    _pin(t, j)
    ji, jp = j.retrieve_texts(queries, k=k)
    ti, tp = t.retrieve_texts(queries, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    return ti, tp


@pytest.mark.parametrize("stem,storage,opts", [
    (True, "int8", {}),
    ("snowball", "hilo", {}),
    (False, "int8", dict(lowercase=False, remove_stopwords=False)),
])
def test_index_texts_matches_jax(small_budget, stem, storage, opts):
    j, t = _scorers({}, storage)
    j.index_texts(TEXTS, stem=stem, **opts)
    tnative.reset_counts()
    t.index_texts(TEXTS, stem=stem, **opts)
    assert tnative.calls["corpus"] == 1 and tnative.calls["tokenize"] == 1
    assert t.bm25_index.vocab == j.bm25_index.vocab
    for name in ("term_ids_host", "term_counts_host", "weights_host"):
        np.testing.assert_array_equal(getattr(t.bm25_index, name),
                                      getattr(j.bm25_index, name))
    assert t._split.n_frequent == j._split.n_frequent == 128
    assert isinstance(t._corpus_tokens, _LazyTokens)
    assert t._corpus_tokens.n_tokenized == 50
    ids, probs = _check(j, t, QUERY_TEXTS)
    assert (ids[:60] >= 0).all() and (probs[-3] == 0).all()
    assert tnative.calls["encode_split"] > 0
    assert sum(tnative.fallbacks.values()) == 0


def test_index_jsonl_matches_jax(small_budget, tmp_path):
    path = os.path.join(MINI_BEIR, "corpus.jsonl")
    with open(os.path.join(MINI_BEIR, "queries.jsonl")) as f:
        queries = [json.loads(line)["text"] for line in f if line.strip()]
    j, t = _scorers({}, "int8")
    assert t.index_jsonl(path) == j.index_jsonl(path)
    _check(j, t, queries, k=5)
    # Titles and nested decoys stay out; a row without an "_id" is dropped.
    edge = tmp_path / "c.jsonl"
    rows = [{"_id": f"d{i}", "title": "T", "text": s,
             "metadata": {"text": "decoy"}} for i, s in enumerate(TEXTS)]
    rows.insert(5, {"_id": "", "text": "dropped"})
    edge.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    ids = t.index_jsonl(str(edge))
    assert ids == [f"d{i}" for i in range(len(TEXTS))]
    assert t.num_docs == len(TEXTS)


def test_add_documents_after_index_texts(small_budget):
    """index_texts(old) + add_documents(new tokens) equals
    index_texts(old + new) and the JAX scorer grown the same way, and
    tokenizes only the documents the two calibration samples read."""
    new_texts = _texts(2, 90)
    new_tokens = tokenize_texts(new_texts)
    j, t = _scorers({}, "int8")
    j.index_texts(TEXTS)
    j.add_documents(new_tokens)
    t.index_texts(TEXTS)
    t.add_documents(new_tokens)
    view = t._corpus_tokens
    assert isinstance(view, _ChainedTokens) and len(view) == 690
    lazy = view._parts[0]
    sample = np.random.default_rng(42).choice(690, 50, replace=False)
    first = np.random.default_rng(42).choice(600, 50, replace=False)
    assert set(lazy._cache) == set(first) | {i for i in sample if i < 600}
    assert view[650] == new_tokens[50] and view[-1] == new_tokens[-1]

    r = BayesianBM25Scorer(impact_storage="int8", base_rate=0.01,
                           device="cpu", prob_dtype=torch.float64)
    r.index_texts(TEXTS + new_texts)
    assert (r.transform.alpha, r.transform.beta) == (t.transform.alpha,
                                                     t.transform.beta)
    ri, rp = r.retrieve_texts(QUERY_TEXTS)
    ti, tp = t.retrieve_texts(QUERY_TEXTS)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tp, rp)
    _check(j, t, QUERY_TEXTS)


def test_prior_free_fit_then_retrieve_texts(small_budget):
    """transform.fit(mode="prior_free") on judgements taken from the
    scores, then retrieve_texts: the scorer's prior-free branch."""
    j, t = _scorers({}, "int8")
    j.index_texts(TEXTS)
    t.index_texts(TEXTS)
    _pin(t, j)
    qs = tokenize_texts(QUERY_TEXTS[:20])
    scores = t.get_scores_batch(qs)
    np.testing.assert_array_equal(scores, j.get_scores_batch(qs))
    s = scores[scores > 0]
    rng = np.random.default_rng(5)
    labels = (rng.uniform(size=s.size)
              < 1.0 / (1.0 + np.exp(-(s - np.median(s))))).astype(float)
    for model in (j, t):
        model.transform.fit(s, labels, mode="prior_free",
                            learning_rate=0.05, max_iterations=300)
    np.testing.assert_allclose([t.transform.alpha, t.transform.beta],
                               [j.transform.alpha, j.transform.beta],
                               rtol=1e-9, atol=0)
    ji, jp = j.retrieve_texts(QUERY_TEXTS, k=10)
    ti, tp = t.retrieve_texts(QUERY_TEXTS, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert t.transform._training_mode == "prior_free"


def test_python_path_without_the_library(small_budget, monkeypatch,
                                         tmp_path):
    """No native library: every entry point runs its Python twin, counts
    a fallback, and gives what the native path gives."""
    t = BayesianBM25Scorer(impact_storage="int8", base_rate=0.01,
                           device="cpu", prob_dtype=torch.float64)
    t.index_texts(TEXTS)
    want = t.retrieve_texts(QUERY_TEXTS)
    want_ab = (t.transform.alpha, t.transform.beta)

    def no_library():
        raise ImportError("no library")

    monkeypatch.setattr(tnative, "load", no_library)
    tnative.reset_counts()
    p = BayesianBM25Scorer(impact_storage="int8", base_rate=0.01,
                           device="cpu", prob_dtype=torch.float64)
    path = tmp_path / "c.jsonl"
    path.write_text("\n".join(json.dumps({"_id": str(i), "text": s})
                              for i, s in enumerate(TEXTS)))
    assert p.index_jsonl(str(path)) == [str(i) for i in range(len(TEXTS))]
    assert isinstance(p._corpus_tokens, list)
    assert (p.transform.alpha, p.transform.beta) == want_ab
    got = p.retrieve_texts(QUERY_TEXTS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert sum(tnative.calls.values()) == 0
    for kind in ("jsonl", "corpus", "tokenize", "encode_tokens",
                 "encode_split"):
        assert tnative.fallbacks[kind] > 0, kind
