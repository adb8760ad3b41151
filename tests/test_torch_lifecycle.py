"""PyTorch port: the document lifecycle, ``append_to_index`` and
``retrieve_stream`` against the JAX package, on the CPU.

The lifecycle cases mirror the single-scorer cases of
tests/test_delete_documents.py on both packages at once: each scorer
indexes the same corpus (the constructor's default hilo storage), and
every result is compared with the JAX scorer's. Ids are equal,
probabilities within 1e-6 (the port's transform in float64, as the JAX
package computes under x64; alpha and beta come from each package's own
calibration, equal to rtol 1e-5). ``append_to_index`` is bit-equal to
the JAX package's in every field.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.utils import convert

PROB_TOL = 1e-6


def _corpus(seed=13, n=250):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.4, size=rng.integers(5, 30)) % 400]
            for _ in range(n)]


CORPUS = _corpus()


@pytest.fixture()
def pair():
    j = JaxScorer(base_rate="auto")
    j.index(CORPUS, show_progress=False)
    t = BayesianBM25Scorer(base_rate="auto", device="cpu",
                           prob_dtype=torch.float64)
    t.index(CORPUS, show_progress=False)
    assert t._split is not None and t._split.dense_impact_lo is not None
    return j, t


def _same(j, t, queries, k=10, doc_mask=None):
    """retrieve on both: ids equal, probabilities within PROB_TOL."""
    ji, jp = j.retrieve(queries, k=k, doc_mask=doc_mask)
    ti, tp = t.retrieve(queries, k=k, doc_mask=doc_mask)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=PROB_TOL)
    return ti, tp


def test_calibration_matches(pair):
    j, t = pair
    for a, b in ((t.transform.alpha, j.transform.alpha),
                 (t.transform.beta, j.transform.beta),
                 (t.base_rate, j.base_rate)):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_array_equal(t.doc_lengths, j.doc_lengths)
    assert t.avgdl == j.avgdl and t.bm25_index.n_docs == 250


def test_deleted_never_returned(pair):
    j, t = pair
    queries = [CORPUS[i][:5] for i in range(0, 60, 7)]
    ids0, _ = _same(j, t, queries)
    victims = sorted({int(d) for d in ids0[:, 0] if d >= 0})
    for s in (j, t):
        s.delete_documents(victims)
    ids1, _ = _same(j, t, queries)
    assert not set(ids1.ravel().tolist()) & set(victims)


def test_matches_explicit_doc_mask(pair):
    j, t = pair
    queries = [CORPUS[i][:5] for i in range(0, 40, 9)]
    mask = np.ones(250, bool)
    mask[::3] = False
    mask2 = np.ones(250, bool)
    mask2[1::3] = False
    ref_ids, ref_probs = _same(j, t, queries, k=8, doc_mask=mask)
    ref2, _ = _same(j, t, queries, k=8, doc_mask=mask & mask2)
    for s in (j, t):
        s.delete_documents(np.flatnonzero(~mask))
    got_ids, got_probs = _same(j, t, queries, k=8)
    np.testing.assert_array_equal(got_ids, ref_ids)
    np.testing.assert_array_equal(got_probs, ref_probs)
    got2, _ = _same(j, t, queries, k=8, doc_mask=mask2)   # AND-composed
    np.testing.assert_array_equal(got2, ref2)


def test_restore_and_idempotence(pair):
    j, t = pair
    q = [CORPUS[7][:5]]
    base_ids, _ = _same(j, t, q, k=5)
    for s in (j, t):
        s.delete_documents([3, 3, 5])
        s.delete_documents([5])
        assert s.deleted_mask.sum() == 2
    _same(j, t, q, k=5)
    for s in (j, t):
        s.restore_documents([3, 5])
        assert s.deleted_mask is None
    ids, _ = _same(j, t, q, k=5)
    np.testing.assert_array_equal(ids, base_ids)


def test_validation(pair):
    _, t = pair
    with pytest.raises(ValueError):
        t.delete_documents([t.num_docs])
    with pytest.raises(ValueError):
        t.delete_documents([-1])
    t.delete_documents([1])
    with pytest.raises(ValueError):
        t.restore_documents([t.num_docs])
    with pytest.raises(RuntimeError):
        BayesianBM25Scorer(device="cpu").delete_documents([0])
    with pytest.raises(RuntimeError):
        BayesianBM25Scorer(device="cpu").add_documents([["a"]])
    BayesianBM25Scorer(device="cpu").restore_documents([0])   # no-op


@pytest.mark.parametrize("method", ["robertson", "bm25+"])
def test_scores_and_probs_zeroed(method):
    """Tombstoned columns are exactly 0 in both dense outputs, the
    bm25+ shift included; the rest equals the JAX scorer."""
    j = JaxScorer(base_rate="auto", method=method)
    j.index(CORPUS, show_progress=False)
    t = BayesianBM25Scorer(base_rate="auto", method=method, device="cpu",
                           prob_dtype=torch.float64)
    t.index(CORPUS, show_progress=False)
    q = [CORPUS[2][:5], CORPUS[9][:4]]
    for s in (j, t):
        s.delete_documents([0, 10, 20])
    js, ts = j.get_scores_batch(q), t.get_scores_batch(q)
    jp, tp = j.get_probabilities_batch(q), t.get_probabilities_batch(q)
    assert (ts[:, [0, 10, 20]] == 0).all() and (tp[:, [0, 10, 20]] == 0).all()
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)


def test_thresholded_excludes(pair):
    j, t = pair
    q = [CORPUS[4][:5]]
    outs = [s.retrieve_thresholded(q, threshold=1e-4, k=10) for s in (j, t)]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    alive = [int(d) for d in outs[1][0][0] if d >= 0]
    assert alive
    for s in (j, t):
        s.delete_documents(alive[:1])
    (jids, jp, jn), (tids, tp, tn) = (
        s.retrieve_thresholded(q, threshold=1e-4, k=10) for s in (j, t))
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)
    assert alive[0] not in tids[0] and tn[0] == outs[1][2][0] - 1


def test_add_documents_extends_mask(pair):
    j, t = pair
    for s in (j, t):
        s.delete_documents([1])
        s.add_documents(CORPUS[:4], show_progress=False)
        assert s.num_docs == 254 and s.deleted_mask.shape == (254,)
        assert s.deleted_mask.sum() == 1 and s.deleted_mask[1]
    ids, _ = _same(j, t, [CORPUS[1][:6], CORPUS[2][:4]], k=10)
    assert 1 not in ids[0]


def test_reindex_clears_mask(pair):
    _, t = pair
    t.delete_documents([2])
    t.index(CORPUS, show_progress=False)
    assert t.deleted_mask is None


# -- append_to_index -----------------------------------------------------------


def _grow():
    """2,040 short docs, then 30 more: new terms, a longer doc (T grows)
    and a doc axis that crosses 2,048 (D_pad grows)."""
    rng = np.random.default_rng(4)
    old = [[f"t{t}" for t in rng.zipf(1.3, size=rng.integers(1, 12)) % 500]
           for _ in range(2040)]
    new = [[f"t{t}" for t in rng.zipf(1.3, size=rng.integers(1, 12)) % 700]
           for _ in range(29)] + [[f"u{i}" for i in range(140)]]
    return old, new


@pytest.mark.parametrize("method", ["robertson", "bm25l"])
def test_append_to_index_bit_equal(method):
    old, new = _grow()
    j = jidx.append_to_index(jidx.build_index(old, method=method), new)
    t = tidx.append_to_index(tidx.build_index(old, method=method,
                                              device="cpu"), new)
    assert t.term_ids_host.shape[1] > 128 and t.term_ids_host.shape[0] == 4096
    assert t.vocab == j.vocab
    want = convert.index_to_numpy(j)
    got = convert.index_to_numpy(t)
    assert want.keys() == got.keys()
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
            assert got[name].dtype == value.dtype, name
        else:
            assert got[name] == value, name
    # And equal to a full rebuild of old + new.
    full = tidx.build_index(old + new, method=method, device="cpu")
    np.testing.assert_array_equal(t.weights_host, full.weights_host)
    assert t.avgdl == full.avgdl and t.vocab == full.vocab


def test_add_documents_vs_jax():
    """add_documents on both scorers: ids equal with the transform
    pinned; auto-calibrated alpha and beta within rtol 1e-5."""
    old, new = CORPUS[:200], CORPUS[200:] + [["fresh", "t1", "t2"]]
    scorers = []
    for auto in (False, True):
        kw = (dict(base_rate="auto") if auto else
              dict(alpha=0.8, beta=1.0, base_rate=0.01))
        j = JaxScorer(**kw)
        t = BayesianBM25Scorer(**kw, device="cpu", prob_dtype=torch.float64)
        for s in (j, t):
            s.index(old, show_progress=False)
            s.add_documents(new, show_progress=False)
        scorers.append((j, t))
    (jp, tp), (ja, ta) = scorers
    assert tp.num_docs == 251 and "fresh" in tp.bm25_index.vocab
    queries = [CORPUS[i][:5] for i in range(0, 250, 11)] + [["fresh"]]
    ids, _ = _same(jp, tp, queries)
    assert 250 in ids[-1]
    np.testing.assert_allclose(ta.transform.alpha, ja.transform.alpha,
                               rtol=1e-5)
    np.testing.assert_allclose(ta.transform.beta, ja.transform.beta,
                               rtol=1e-5)
    # The same state as indexing old + new at once.
    full = BayesianBM25Scorer(base_rate="auto", device="cpu")
    full.index(old + new, show_progress=False)
    assert full.transform.alpha == ta.transform.alpha
    np.testing.assert_array_equal(full.retrieve(queries)[0],
                                  ta.retrieve(queries)[0])


# -- retrieve_stream -----------------------------------------------------------


def test_retrieve_stream_equals_retrieve_many(pair, monkeypatch):
    j, t = pair
    batches = [[CORPUS[i][:5] for i in range(s, s + 9)]
               for s in range(0, 90, 9)] + [[], [["t1", "t1"]]]
    want = t.retrieve_many(batches, k=7)
    for lookahead in (1, 4):
        got = list(t.retrieve_stream(batches, k=7, lookahead=lookahead))
        assert len(got) == len(want)
        for (gi, gp), (wi, wp) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gp, wp)
    # A generator input, oversized batches chunked, against JAX's stream.
    monkeypatch.setattr(t, "_auto_batch_size", lambda: 4)
    gen = (b for b in batches)
    got = list(t.retrieve_stream(gen, k=7, lookahead=2))
    jax_got = list(j.retrieve_stream(batches, k=7, lookahead=2))
    for (gi, gp), (wi, wp), (ji, jp) in zip(got, want, jax_got):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gi, np.asarray(ji))
        np.testing.assert_allclose(gp, np.asarray(jp), rtol=0, atol=PROB_TOL)
