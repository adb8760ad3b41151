"""PyTorch port: the doc-major compare (K5's plain version) and
engine/scoring.py against the JAX package, on the CPU.

Scores and tf counts are bit-equal to ``score_all_xla`` and to the JAX
``_compare_table``: both add each query slot as one fused multiply-add
(XLA contracts ``acc + c_j * s_j``), and counts of 3, 5 and 7 are where
a separate multiply and add would round differently. The Pallas kernel
K5 replaces sums over term positions instead; its own test holds it to
rtol 1e-6, and so does the one here. Probabilities: the port computes
the transform in float64, as the JAX package does under x64, and both
return float32: ids equal, probabilities within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import scoring as jscoring
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.ops import transform as jT
from bayesian_bm25_tpu_torch.engine import cuda_bm25
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.engine import scoring as tscoring
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.ops import transform as tT

from torch_helpers import one_thread  # noqa: F401

ALPHA, BETA, BASE_RATE = 0.9, 1.5, 0.01
F64 = torch.float64


def _corpus(seed=0, D=600, V=200, L=60):
    rng = np.random.default_rng(seed)
    return [[f"w{t}" for t in rng.zipf(1.3, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=40, V=200):
    rng = np.random.default_rng(seed)
    qs = [[f"w{t}" for t in rng.zipf(1.3, size=8) % V] for _ in range(n)]
    # counts 3, 5 and 7 on common and rare terms, an empty query, OOV
    return qs + [["w1"] * 3 + ["w150"] * 5 + ["w7"] * 7, ["w60"] * 5,
                 [], ["zzz-oov", "w2"], ["zzz-oov"]]


CORPUS = _corpus()
QUERIES = _queries()
JIDX = jidx.build_index(CORPUS)
TIDX = tidx.build_index(CORPUS, device="cpu")


def _table(seed, R, T, V, n_pad_rows):
    """(R, T) table of unique ids per row, left-compacted, random
    lengths, some all-pad rows; weights gamma-distributed."""
    rng = np.random.default_rng(seed)
    ids = np.full((R, T), jidx.DOC_PAD, np.int32)
    w = np.zeros((R, T), np.float32)
    lens = rng.integers(0, T + 1, R)
    lens[rng.choice(R, n_pad_rows, replace=False)] = 0
    for r in range(R):
        ids[r, :lens[r]] = rng.choice(V, lens[r], replace=False)
        w[r, :lens[r]] = rng.gamma(2.0, 1.5, lens[r])
    return ids, w


def _tail_queries(seed, nq, Q, V):
    rng = np.random.default_rng(seed)
    qids = np.full((nq, Q), jidx.QUERY_PAD, np.int32)
    qcnt = np.zeros((nq, Q), np.float32)
    for q in range(nq - 2):           # the last two rows stay all-pad
        n = rng.integers(1, Q + 1)
        qids[q, :n] = np.sort(rng.choice(V, n, replace=False))
        qcnt[q, :n] = rng.choice([1.0, 3.0, 5.0, 7.0], n)
    return qids, qcnt


def test_compare_table_bit_equal_with_odd_counts():
    """The compare tail is a fused multiply-add per query slot: bit-equal
    to the JAX ``_compare_table`` (a separate multiply and add is not)."""
    ids, w = _table(0, 4096, 8, 60, 40)
    qids, qcnt = _tail_queries(1, 64, 6, 60)
    js, jt = (np.asarray(a) for a in jsidx._compare_table(
        jnp.asarray(ids), jnp.asarray(w), jnp.asarray(qids),
        jnp.asarray(qcnt)))
    ts, tt = tsidx._compare_table(*(torch.from_numpy(a)
                                    for a in (ids, w, qids, qcnt)))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (jt > 1).sum() > 1000 and not js[-2:].any()
    # The counts 3/5/7 are the rounding-sensitive case.
    naive = np.zeros_like(js)
    for j in range(qids.shape[1]):
        m = ids[None] == qids[:, j, None, None]
        naive = naive + qcnt[:, j, None] * np.where(m, w[None], 0).sum(2)
    assert (naive != js).any()


def test_score_all_split_overflow_with_odd_counts():
    """Calibration scoring on a split index with an overflow table and
    queries whose rare terms repeat 3, 5 and 7 times."""
    vocab_rare = sorted(JIDX.vocab, key=lambda t: JIDX.doc_frequencies[
        JIDX.vocab[t]])[:40]
    rng = np.random.default_rng(3)
    qs = [list(rng.choice(vocab_rare, 2)) * int(c) + ["w1"] * int(c)
          for c in rng.choice([1, 3, 5, 7], 48)] + QUERIES
    split = jsidx.build_split_index(JIDX, 128, storage="int8",
                                    enable_overflow=True)
    assert split.over_term_ids is not None
    from bayesian_bm25_tpu_torch.utils import convert
    port = convert.split_index_from_numpy(
        convert.split_index_to_numpy(split), "cpu")
    enc = jsidx.encode_queries_split(qs, split)
    assert {3.0, 5.0, 7.0} <= set(np.unique(enc[4]))
    js, jt = (np.asarray(a) for a in jsidx.score_all_split(split, *enc))
    ts, tt = tsidx.score_all_split(port, *enc)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)


def test_encode_queries_equal():
    for qs in (QUERIES, [[]], [["zzz-oov"]]):
        for mqt in (None, 2):
            a = jidx.encode_queries(qs, JIDX.vocab, max_query_terms=mqt)
            b = tidx.encode_queries(qs, JIDX.vocab, max_query_terms=mqt)
            for x, y in zip(b, a):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype


@pytest.mark.parametrize("method", ["robertson", "bm25l", "bm25+"])
def test_query_score_shift_equal(method):
    j = jidx.build_index(CORPUS[:100], method=method)
    t = tidx.build_index(CORPUS[:100], method=method, device="cpu")
    np.testing.assert_array_equal(tidx.query_score_shift(t, QUERIES),
                                  jidx.query_score_shift(j, QUERIES))


def _enc():
    qids, qcnt = jidx.encode_queries(QUERIES, JIDX.vocab)
    return qids, qcnt, torch.from_numpy(qids), torch.from_numpy(qcnt)


def test_score_all_bit_equal_to_score_all_xla():
    qids, qcnt, tq, tc = _enc()
    assert {3.0, 5.0, 7.0} <= set(np.unique(qcnt))
    js, jt = (np.asarray(a) for a in jscoring.score_all_xla(
        JIDX.term_ids, JIDX.weights, qids, qcnt))
    ts, tt = tscoring.score_all(TIDX.term_ids, TIDX.weights, tq, tc)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert not js[:, JIDX.n_docs:].any()         # pad rows
    assert not js[-3].any() and not js[-1].any()  # empty, OOV-only
    assert (js > 0).sum() > 5000


def test_compare_within_pallas_kernel_tolerance():
    """Against the Pallas kernel K5 replaces (interpret mode), which sums
    over term positions: rtol 1e-6, as the JAX package's own test."""
    from bayesian_bm25_tpu.engine.pallas_bm25 import score_all_pallas

    qids, qcnt, tq, tc = _enc()
    ps, pt = (np.asarray(a) for a in score_all_pallas(
        JIDX.term_ids, JIDX.weights, qids[:8], qcnt[:8], interpret=True))
    ts, tt = cuda_bm25.compare(TIDX.term_ids, TIDX.weights, tq[:8], tc[:8])
    np.testing.assert_allclose(ts.numpy(), ps, rtol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), pt)


def test_compare_any_shape_and_query_chunks():
    """Q above 32 (slots in several chunks), Q = 0, a -1 query id (it
    matches pad slots, as in the reference) and nq = 0."""
    ids, w = _table(4, 300, 40, 90, 10)
    qids, qcnt = _tail_queries(5, 12, 40, 90)
    qids[3, 39] = jidx.DOC_PAD
    qcnt[3, 39] = 3.0
    js, jt = (np.asarray(a) for a in jsidx._compare_table(
        *(jnp.asarray(a) for a in (ids, w, qids, qcnt))))
    ts, tt = cuda_bm25.compare(*(torch.from_numpy(a)
                                 for a in (ids, w, qids, qcnt)))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (jt[3] > 0).all()
    s0, t0 = cuda_bm25.compare(torch.from_numpy(ids), torch.from_numpy(w),
                               torch.zeros((4, 0), dtype=torch.int32),
                               torch.zeros((4, 0)))
    assert s0.shape == (4, 300) and not s0.any() and not t0.any()
    s1, _ = cuda_bm25.compare(torch.from_numpy(ids), torch.from_numpy(w),
                              torch.zeros((0, 3), dtype=torch.int32),
                              torch.zeros((0, 3)))
    assert s1.shape == (0, 300)


def test_compare_mid_row_pads_and_repeated_query_ids():
    """Pads anywhere in a row (not only trailing), all-pad rows, ids near
    INT32_MAX, and one id in several slots of a query (each slot matches
    on its own): bit-equal to ``score_all_xla``."""
    rng = np.random.default_rng(6)
    R, T, V = 500, 48, 120
    ids = np.full((R, T), jidx.DOC_PAD, np.int32)
    w = np.zeros((R, T), np.float32)
    base = np.where(np.arange(R) % 3 == 0, np.iinfo(np.int32).max - V, 0)
    for r in range(R):
        n = rng.integers(0, T + 1)
        at = rng.choice(T, n, replace=False)           # scattered positions
        ids[r, at] = base[r] + rng.choice(V, n, replace=False)
        w[r, at] = rng.gamma(2.0, 1.5, n)
    ids[::11] = jidx.DOC_PAD                           # all-pad rows
    w[::11] = 0.0
    assert ((ids[:, :-1] == jidx.DOC_PAD) & (ids[:, 1:] >= 0)).any()
    qids = rng.integers(0, V, (40, 8)).astype(np.int32)
    qids[::2] += np.iinfo(np.int32).max - V
    qids[1:4, 1] = qids[1:4, 0]                        # repeated across slots
    qids[4, :] = qids[4, 0]
    qids[5, 5:] = jidx.QUERY_PAD
    qcnt = rng.choice([1.0, 3.0, 5.0, 7.0], (40, 8)).astype(np.float32)
    qcnt[5, 5:] = 0.0
    js, jt = (np.asarray(a) for a in jscoring.score_all_xla(
        ids, w, qids, qcnt))
    ts, tt = cuda_bm25.compare(*(torch.from_numpy(a)
                                 for a in (ids, w, qids, qcnt)))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    one = ids[:, :, None] == qids[4, 0]
    np.testing.assert_array_equal(jt[4], 8 * one.sum(axis=(1, 2)))
    assert (jt > 1).any() and not jt[:, ::11].any()


def test_compare_validates_and_never_falls_back():
    ids = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((4, 8))
    q = torch.zeros((2, 3), dtype=torch.int32)
    c = torch.zeros((2, 3))
    before = cuda_bm25.launches
    cuda_bm25.compare(ids, w, q, c)
    assert cuda_bm25.launches == before          # the plain version
    with pytest.raises(ValueError):
        cuda_bm25.compare(ids.long(), w, q, c)
    with pytest.raises(ValueError):
        cuda_bm25.compare(ids, w[:, :4], q, c)
    with pytest.raises(ValueError):
        cuda_bm25.compare(ids, w, q, c.double())
    meta = [t.to("meta") for t in (ids, w, q, c)]
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_bm25.compare(*meta)


@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_topk(masked):
    qids, qcnt, tq, tc = _enc()
    mask = np.ones(JIDX.n_docs, bool)
    mask[::3] = False
    mask[:300] = False
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ji, jp, js, jt = (np.asarray(a) for a in jscoring.retrieve_topk(
        JIDX.term_ids, JIDX.weights, JIDX.doc_lengths, JIDX.avgdl, qids,
        qcnt, 10, ALPHA, BETA, BASE_RATE, n_docs=JIDX.n_docs,
        doc_mask=jm))
    ti, tp, ts, tt = tscoring.retrieve_topk(
        TIDX.term_ids, TIDX.weights, TIDX.doc_lengths, TIDX.avgdl, tq, tc,
        10, ALPHA, BETA, BASE_RATE, n_docs=TIDX.n_docs, doc_mask=tm,
        prob_dtype=F64)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-6)
    if masked:
        assert mask[ji[ji >= 0]].all()


def _dense_pair():
    qids, qcnt, tq, tc = _enc()
    jp, js, jt = (np.asarray(a) for a in jscoring.probabilities_all(
        JIDX.term_ids, JIDX.weights, JIDX.doc_lengths, JIDX.avgdl, qids,
        qcnt, ALPHA, BETA, BASE_RATE, n_docs=JIDX.n_docs))
    tp, ts, tt = tscoring.probabilities_all(
        TIDX.term_ids, TIDX.weights, TIDX.doc_lengths, TIDX.avgdl, tq, tc,
        ALPHA, BETA, BASE_RATE, n_docs=TIDX.n_docs, prob_dtype=F64)
    return (jp, js, jt), (tp, ts, tt)


def test_probabilities_all_and_count_above():
    (jp, js, jt), (tp, ts, tt) = _dense_pair()
    assert tp.shape == (len(QUERIES), JIDX.n_docs)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-6)
    assert (tp.numpy()[js <= 0] == 0).all()
    for s_min in (0.5, 2.0, 3.7):
        np.testing.assert_array_equal(
            tscoring.count_above(ts, s_min).numpy(),
            np.asarray(jscoring.count_above(jnp.asarray(js), s_min)))


@pytest.mark.parametrize("threshold", [0.0, 0.2, 0.5, 0.8])
def test_thresholded_functions(threshold):
    (jp, js, jt), (tp, ts, tt) = _dense_pair()
    dl_j = JIDX.doc_lengths[: JIDX.n_docs]
    dl_t = TIDX.doc_lengths[: TIDX.n_docs]
    want = [np.asarray(a) for a in jscoring.thresholded_topk(
        jnp.asarray(jp), threshold, 10)]
    got = tscoring.thresholded_topk(tp, threshold, 10)
    outs = [(got, want)]
    want = [np.asarray(a) for a in jscoring.thresholded_topk_from_scores(
        js, jt, dl_j, JIDX.avgdl, threshold, 10, ALPHA, BETA, BASE_RATE)]
    got = tscoring.thresholded_topk_from_scores(
        ts, tt, dl_t, TIDX.avgdl, threshold, 10, ALPHA, BETA, BASE_RATE,
        prob_dtype=F64)
    outs.append((got, want))
    s_min = jT.wand_score_threshold(threshold, ALPHA, BETA, BASE_RATE)
    want = [np.asarray(a) for a in jscoring.thresholded_topk_pruned(
        js, jt, dl_j, JIDX.avgdl, threshold, s_min, 10, 64, ALPHA, BETA,
        BASE_RATE)]
    got = tscoring.thresholded_topk_pruned(
        ts, tt, dl_t, TIDX.avgdl, threshold, s_min, 10, 64, ALPHA, BETA,
        BASE_RATE, prob_dtype=F64)
    outs.append((got, want))
    for (gi, gp, gn), (wi, wp, wn) in outs:
        assert gi.dtype == torch.int32 and gn.dtype == torch.int32
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gn.numpy(), wn)
        np.testing.assert_allclose(gp.numpy(), wp, rtol=0, atol=1e-6)
    if 0 < threshold < 0.8:
        assert (wn > 0).any() and (wi == -1).any()


def test_wand_bounds_equal():
    for t in (-0.1, 0.0, 1e-9, 0.3, 0.5, 0.9, 0.999999, 1.0, 1.5):
        for a, br in ((0.8, None), (1.7, 0.01), (0.0, 0.1), (2.0, 1e-15)):
            for p_max in (0.5, 0.9):
                assert tT.wand_score_threshold(t, a, 1.3, br, p_max) == \
                    jT.wand_score_threshold(t, a, 1.3, br, p_max)
    ub = np.array([0.0, 0.7, 1.3, 4.0, 25.0])
    for br in (None, 0.01):
        want = np.asarray(jT.wand_upper_bound(ub, 0.8, 1.3, br))
        got = tT.wand_upper_bound(ub, 0.8, 1.3, br, dtype=F64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
        assert (got.numpy()[1:] >= got.numpy()[:-1]).all()
