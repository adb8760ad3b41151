"""PyTorch port: ``MultiFieldScorer`` against the JAX package.

Both packages index the same documents (token lists, and the repo's
BEIR sample ``benchmarks/data/mini_beir/corpus.jsonl`` through
``index_jsonl``); the port's field scorers compute their probabilities
in float64 on the CPU. Each field's probabilities are within 1e-6 of
JAX's (the scorers' own parity, ``test_torch_dense_api.py``), so the
fused probabilities are compared at atol 1e-6 and the ids at every rank
whose probability is more than 1e-6 from its neighbours. The fusion
itself is held exactly: given JAX's field probabilities, the port's
fused matrix is within rtol 1e-12 of JAX's and ``retrieve``'s ids are
bit-equal (the same numpy ranking of the fused row).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import MultiFieldScorer as JaxMF
from bayesian_bm25_tpu_torch import MultiFieldScorer
from bayesian_bm25_tpu_torch.engine import native

CPU = dict(device="cpu", prob_dtype=torch.float64)
MINI = Path(__file__).resolve().parents[1] / "benchmarks/data/mini_beir"
TOL = 1e-6


def _docs(seed=0, n=240):
    rng = np.random.default_rng(seed)

    def toks(L, V):
        return [f"w{t}" for t in rng.zipf(1.3, size=L) % V]

    return [{"title": toks(6, 120), "body": toks(40, 600)} for _ in range(n)]


DOCS = _docs()
QUERIES = [[f"w{t}" for t in np.random.default_rng(1).zipf(1.3, 4) % 120]
           for _ in range(30)] + [["w1", "w1", "w2"], [], ["oov-term"]]
WEIGHTS = {"title": 0.3, "body": 0.7}


def _pair(weights=None, alpha="auto", docs=DOCS):
    j = JaxMF(["title", "body"], field_weights=weights, alpha=alpha,
              base_rate=0.02)
    t = MultiFieldScorer(["title", "body"], field_weights=weights,
                         alpha=alpha, base_rate=0.02, **CPU)
    for m in (j, t):
        m.index(docs, show_progress=False)
    return j, t


@pytest.fixture(scope="module")
def pair():
    return _pair(WEIGHTS)


def _assert_probs_close(t, j):
    assert t.dtype == np.float64 and t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


def _assert_ranked(ti, tp, ji, jp):
    np.testing.assert_allclose(tp, jp, rtol=0, atol=TOL)
    near = np.zeros(len(jp), dtype=bool)
    near[1:] |= np.abs(np.diff(jp)) <= 2 * TOL
    near[:-1] |= np.abs(np.diff(jp)) <= 2 * TOL
    np.testing.assert_array_equal(ti[~near], ji[~near])


@pytest.mark.parametrize("weights, alpha", [(None, "auto"), (WEIGHTS, None),
                                            (WEIGHTS, 1.0)])
def test_probabilities_match_jax(weights, alpha):
    j, t = _pair(weights, alpha)
    _assert_probs_close(t.get_probabilities_batch(QUERIES),
                        j.get_probabilities_batch(QUERIES))
    _assert_probs_close(t.get_probabilities(QUERIES[0]),
                        j.get_probabilities(QUERIES[0]))
    for q in QUERIES[:6]:
        _assert_ranked(*t.retrieve(q, k=15), *j.retrieve(q, k=15))


def test_fusion_exact_on_jax_field_probabilities(pair, monkeypatch):
    j, t = pair
    for f in t.fields:
        jf = j.scorers[f]
        monkeypatch.setattr(
            t.scorers[f], "_dense_probs_device",
            lambda qs, _jf=jf: torch.from_numpy(
                _jf.get_probabilities_batch(qs)))
    np.testing.assert_allclose(t.get_probabilities_batch(QUERIES),
                               j.get_probabilities_batch(QUERIES),
                               rtol=1e-12, atol=0)
    for q in QUERIES:
        (ti, tp), (ji, jp) = t.retrieve(q, k=20), j.retrieve(q, k=20)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tp, jp, rtol=1e-12, atol=0)
    # k above num_docs keeps every document.
    assert len(t.retrieve(QUERIES[0], k=10_000)[0]) == len(DOCS)


def test_index_jsonl_on_mini_beir():
    j = JaxMF(["title", "body"])
    t = MultiFieldScorer(["title", "body"], **CPU)
    native.reset_counts()
    ids = t.index_jsonl(str(MINI / "corpus.jsonl"), stem="snowball")
    assert native.calls["jsonl"] == 1 and not native.fallbacks["jsonl"]
    assert ids == j.index_jsonl(str(MINI / "corpus.jsonl"), stem="snowball")
    assert t.num_docs == len(ids) == 300
    assert t.scorers["title"]._tok_opts["stem"] == "snowball"
    texts = ["t0_33 t0_28 w143", "w2 w1 b0_6", "nothing-here"]
    for text in texts:
        _assert_ranked(*t.retrieve_texts(text, k=10),
                       *j.retrieve_texts(text, k=10))
    with pytest.raises(ValueError, match="title"):
        MultiFieldScorer(["body"], **CPU).index_jsonl(
            str(MINI / "corpus.jsonl"))


def test_index_jsonl_python_fallback(monkeypatch, tmp_path):
    path = tmp_path / "c.jsonl"
    path.write_text('{"_id": "a", "title": "red fox", "text": "quick fox"}\n'
                    '\n{"_id": "", "text": "dropped"}\n'
                    '{"_id": "b", "title": null, "text": "lazy dog"}\n')
    monkeypatch.setattr(native, "load_jsonl_native", lambda p: None)
    t = MultiFieldScorer(["title", "body"], **CPU)
    native.reset_counts()
    assert t.index_jsonl(str(path)) == ["a", "b"]
    assert native.fallbacks["jsonl"] == 1 and t.num_docs == 2


def test_delete_restore_add(pair):
    j0, t0 = pair
    j, t = _pair(WEIGHTS)
    dead = [3, 17, 200]
    for m in (j, t):
        m.delete_documents(dead)
    np.testing.assert_array_equal(t.deleted_mask, j.deleted_mask)
    tp = t.get_probabilities_batch(QUERIES)
    _assert_probs_close(tp, j.get_probabilities_batch(QUERIES))
    assert (tp[:, dead] == 0).all()
    ti, _ = t.retrieve(QUERIES[0], k=len(DOCS))
    assert set(ti[-3:]) == set(dead)
    for m in (j, t):
        m.restore_documents(dead)
    assert t.deleted_mask is None
    np.testing.assert_array_equal(t.get_probabilities_batch(QUERIES),
                                  t0.get_probabilities_batch(QUERIES))
    new = _docs(seed=7, n=30)
    for m in (j, t):
        m.add_documents(new, show_progress=False)
    assert t.num_docs == j.num_docs == len(DOCS) + 30
    _assert_probs_close(t.get_probabilities_batch(QUERIES),
                        j.get_probabilities_batch(QUERIES))
    with pytest.raises(ValueError, match="missing field"):
        t.add_documents([{"title": ["x"]}])


@pytest.mark.parametrize("kw, match", [
    (dict(fields=[]), "non-empty"),
    (dict(fields=["a", "a"]), "duplicates"),
    (dict(fields=["a", "b"], field_weights={"a": 0.9, "b": 0.9}), "sum to 1"),
    (dict(fields=["a", "b"], field_weights={"a": 1.0}), "missing key"),
])
def test_validation(kw, match):
    for cls in (JaxMF, MultiFieldScorer):
        with pytest.raises(ValueError, match=match):
            cls(**kw, **({} if cls is JaxMF else CPU))


@pytest.mark.parametrize("call", [
    lambda m: m.get_probabilities(["w1"]),
    lambda m: m.get_probabilities_batch([["w1"]]),
    lambda m: m.retrieve_texts("w1"),
    lambda m: m.delete_documents([0]),
    lambda m: m.restore_documents([0]),
    lambda m: m.add_documents(DOCS[:1]),
])
def test_calls_before_index(call):
    m = MultiFieldScorer(["title", "body"], **CPU)
    assert m.deleted_mask is None and m.num_docs == 0
    with pytest.raises(RuntimeError, match="index"):
        call(m)


def test_missing_field_default_weights_and_device():
    m = MultiFieldScorer(["title", "body"], **CPU)
    assert m.field_weights == {"title": 0.5, "body": 0.5}
    with pytest.raises(ValueError, match="missing field"):
        m.index(DOCS[:3] + [{"title": ["x"]}])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiFieldScorer(["title"])
