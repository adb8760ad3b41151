"""PyTorch port: ``FusionDebugger`` (the traces, ``compare`` and every
formatter) and ``retrieve(explain=True)`` against the JAX package.

The same inputs go to both packages; JAX runs with x64 and the port in
float64 on the CPU. Trace fields are held to rtol 1e-12 (an exp or log
may round its last bit differently), and every formatter's text must
equal JAX's character for character. ``retrieve(explain=True)`` on the
split path and on the doc-major path: ids and probabilities equal to
the port's own ``retrieve``, ids equal to JAX's, a trace exactly where
JAX has one, raw scores and derived fields within rtol 1e-6 of JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu_torch.utils import debug as tdebug

CPU = dict(device="cpu")


def _pair(base_rate):
    kw = dict(alpha=1.2, beta=2.0, base_rate=base_rate)
    return (jbb.FusionDebugger(jbb.BayesianProbabilityTransform(**kw)),
            tbb.FusionDebugger(tbb.BayesianProbabilityTransform(**kw, **CPU)))


def _same(got, want, rtol=1e-12, path="trace"):
    """Dataclasses, lists and dicts equal field by field; floats within
    ``rtol``."""
    assert type(got).__name__ == type(want).__name__, path
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), rtol,
                  f"{path}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, rtol, f"{path}[{i}]")
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], rtol, f"{path}[{k}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=1e-300), path
    else:
        assert got == want, path


class _Calibrator:
    mu_G, sigma_G = 0.5, 0.1


def _traces(d):
    """One of each trace, from the same calls on either package's
    debugger."""
    out = [d.trace_bm25(5.0, 3.0, 0.8), d.trace_bm25(0.3, 0, 1.9),
           d.trace_vector(0.62), d.trace_vector(-1.0),
           d.trace_calibrated_vector(0.4, 0.8, f_R=2.5,
                                     calibration_method="kde",
                                     calibrator=_Calibrator()),
           d.trace_calibrated_vector(0.4, 0.8),
           d.trace_not(0.3, name="BM25"), d.trace_not(1.0)]
    p = [0.8, 0.35, 0.999999999999]
    for kw in (dict(), dict(alpha=0.0), dict(weights=[0.2, 0.5, 0.3]),
               dict(weights=[0.2, 0.5, 0.3], alpha=0.5),
               *(dict(gating=g, gating_beta=1.5) for g in
                 ("relu", "swish", "gelu", "softplus", "none")),
               dict(method="prob_and"), dict(method="prob_or"),
               dict(method="prob_not", names=["a", "b", "c"])):
        out.append(d.trace_fusion(p, **kw))
    docs = [d.trace_document(bm25_score=4.0, tf=3.0, doc_len_ratio=0.8,
                             cosine_score=0.62, doc_id="d7"),
            d.trace_document(bm25_score=2.5, tf=8.0, doc_len_ratio=0.4,
                             cosine_score=0.9, doc_id=3, method="prob_or"),
            d.trace_document(bm25_score=4.0, tf=1.0, doc_len_ratio=1.2,
                             weights=[0.7, 0.3], alpha=0.5),
            d.trace_document(cosine_score=0.1, method="prob_and")]
    out += docs
    out += [d.compare(docs[0], docs[1]), d.compare(docs[1], docs[2]),
            d.compare(docs[0], docs[0]), d.compare(docs[2], docs[3])]
    return out


@pytest.mark.parametrize("base_rate", [None, 0.05])
def test_traces_and_formatters_match_jax(base_rate):
    j, t = _pair(base_rate)
    jt, tt = _traces(j), _traces(t)
    _same(tt, jt)
    texts = []
    for d, traces in ((j, jt), (t, tt)):
        out = []
        for tr in traces:
            name = type(tr).__name__
            if name == "DocumentTrace":
                out += [d.format_trace(tr), d.format_trace(tr, verbose=False),
                        d.format_summary(tr)]
            elif name == "ComparisonResult":
                out.append(d.format_comparison(tr))
            elif name == "NotTrace":
                out.append(d.format_not(tr))
        texts.append(out)
    assert len(texts[1]) == 18
    assert texts[1] == texts[0]


def test_trace_bm25_equals_the_block_pass():
    """``trace_bm25`` (one score) and ``bm25_trace_rows`` (a block, as
    ``retrieve(explain=True)`` computes it) give the same traces; a score
    of 0 has none."""
    _, t = _pair(0.02)
    rng = np.random.default_rng(0)
    s = rng.gamma(2.0, 2.0, (4, 5))
    s[1, 3] = 0.0
    tf = rng.integers(0, 12, (4, 5)).astype(float)
    r = rng.uniform(0.2, 1.8, (4, 5))
    rows = tdebug.bm25_trace_rows(t._transform, s, tf, r)
    assert rows[1][3] is None
    for q in range(4):
        for c in range(5):
            if (q, c) != (1, 3):
                assert rows[q][c] == t.trace_bm25(float(s[q, c]),
                                                  float(tf[q, c]),
                                                  float(r[q, c]))


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=20, V=900):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    return qs + [["zzz-oov"], [], [f"t{V - 1}"]]


@pytest.mark.parametrize("path", ["split", "doc-major"])
def test_retrieve_explain_matches_jax(monkeypatch, path):
    for cls in (jbb.BayesianBM25Scorer, tbb.BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus = _corpus(V=900 if path == "split" else 200)
    queries = _queries(V=900 if path == "split" else 200)
    kw = dict(alpha=0.8, beta=1.0, base_rate=0.01, impact_storage="int8")
    j = jbb.BayesianBM25Scorer(**kw)
    t = tbb.BayesianBM25Scorer(**kw, **CPU, prob_dtype=torch.float64)
    for s in (j, t):
        s.index(corpus, show_progress=False)
    assert (t._split is None) == (path == "doc-major")
    mask = np.ones(len(corpus), bool)
    mask[50:] = False                 # most slots unfilled: no trace there
    # (The doc-major path without a mask only: each mask case costs JAX
    # a compile of its own.)
    for doc_mask in ((None, mask) if path == "split" else (None,)):
        jr = j.retrieve(queries, k=10, explain=True, doc_mask=doc_mask)
        tr = t.retrieve(queries, k=10, explain=True, doc_mask=doc_mask)
        assert isinstance(tr, tbb.RetrievalResult)
        ti, tp = t.retrieve(queries, k=10, doc_mask=doc_mask)
        np.testing.assert_array_equal(tr.doc_ids, ti)
        np.testing.assert_array_equal(tr.probabilities, tp)
        np.testing.assert_array_equal(tr.doc_ids, jr.doc_ids)
        np.testing.assert_allclose(tr.probabilities, jr.probabilities,
                                   rtol=0, atol=1e-6)
        assert len(tr.explanations) == len(queries)
        n = 0
        for trow, jrow in zip(tr.explanations, jr.explanations):
            assert [x is None for x in trow] == [x is None for x in jrow]
            for a, b in zip(trow, jrow):
                if b is not None:
                    _same(a, b, rtol=1e-6)
                    n += 1
        assert n > 20
    texts = [" ".join(q) for q in queries[:4]]
    t._tok_opts = dict(lowercase=False, remove_stopwords=False, stem=False)
    r = t.retrieve_texts(texts, k=5, explain=True)
    np.testing.assert_array_equal(r.doc_ids, t.retrieve(queries[:4], k=5)[0])
    assert len(r.explanations) == 4
