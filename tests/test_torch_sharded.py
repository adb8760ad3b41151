"""PyTorch port: ``parallel/sharded.py`` against the JAX package's
functions on its 8 virtual CPU devices.

The same seeded numpy corpus and queries go through each JAX function on
a ``jax.sharding.Mesh`` and through the port's namesake on a mesh of
shards on the CPU (``make_mesh(n, device="cpu")``), 1-D with 8 and 2
shards and 2-D with 4 x 2. Ids are bit-equal, tie order included;
scores within rtol 1e-6 (float32, another summation order where a
product sums); probabilities within atol 2e-6 (the JAX bodies take the
transform's scalars as float32 operands, the port keeps them as Python
floats); corpus statistics equal; the sharded fit in float32 against
JAX's with x64 off within rtol 1e-5, with equal iteration counts; the
training steps within rtol 1e-5. The mesh policy is checked without
CUDA: a mesh over the cards raises, nothing falls back to the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.parallel import sharded as jsh
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.parallel import sharded as tsh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

PROB_ATOL = 2e-6
ALPHA, BETA, BR = 1.0, 2.0, 0.05


def _corpus(seed=3, V=500, D=64, L=30):
    rng = np.random.default_rng(seed)
    corpus = [[f"t{t}" for t in rng.integers(0, V, L)] for _ in range(D)]
    queries = [[f"t{t}" for t in rng.integers(0, V, 5)] for _ in range(6)]
    return corpus, queries + queries[:2]      # 8 queries: 4 query rows


CORPUS, QUERIES = _corpus()


@pytest.fixture(scope="module")
def pair():
    """The JAX and port indexes of one corpus (doc axis padded to 64 so
    it splits over 8 shards), their split indexes (128 frequent terms)
    and encodings."""
    j = jidx.build_index(CORPUS, doc_pad_multiple=8, pad_multiple=8)
    t = tidx.build_index(CORPUS, doc_pad_multiple=8, pad_multiple=8,
                         device="cpu")
    js = jsidx.build_split_index(j, n_frequent=128, enable_overflow=False)
    ts = tsidx.build_split_index(t, n_frequent=128, enable_overflow=False,
                                 device="cpu")
    jq = jidx.encode_queries(QUERIES, j.vocab)
    tq = tidx.encode_queries(QUERIES, t.vocab)
    jenc = jsidx.encode_queries_split(QUERIES, js)
    tenc = tsidx.encode_queries_split(QUERIES, ts)
    for a, b in zip(jq + jenc, tq + tenc):
        np.testing.assert_array_equal(np.asarray(a), b)
    return dict(j=j, t=t, js=js, ts=ts, q=tq, enc=tenc)


def _np(x):
    if isinstance(x, (list, tuple)):
        return np.concatenate([_np(p) for p in x], axis=1)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(jout, tout, score_i=2, prob_i=1):
    np.testing.assert_array_equal(_np(tout[0]), np.asarray(jout[0]))
    np.testing.assert_allclose(_np(tout[score_i]), np.asarray(jout[score_i]),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(tout[prob_i]), np.asarray(jout[prob_i]),
                               rtol=0, atol=PROB_ATOL)


def _mask(n, seed=4):
    return np.random.default_rng(seed).uniform(size=n) < 0.6


# -- the mesh ---------------------------------------------------------------


def test_mesh_shapes_and_axes():
    m = tsh.make_mesh(8, device="cpu")
    assert m.axis_names == ("d",) and m.shape == {"d": 8}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m2 = tsh.make_mesh_2d(4, 2, device="cpu")
    assert m2.axis_names == ("q", "d") and m2.shape == {"q": 4, "d": 2}
    assert m2.devices.shape == (4, 2)
    assert tsh.make_mesh(device="cpu").shape == {"d": 1}
    assert [tsh.doc_pad_multiple(n) for n in (1, 3, 8, 4096)] == [
        2048, 6144, 2048, 4096]


@pytest.mark.parametrize("make", [lambda: tsh.make_mesh(2),
                                  lambda: tsh.make_mesh(),
                                  lambda: tsh.make_mesh_2d(2, 2),
                                  lambda: tsh.make_mesh(2, device="cuda")])
def test_mesh_over_cards_raises_without_cuda(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_mesh_raises_with_fewer_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsh.make_mesh(2).shape == {"d": 2}
    with pytest.raises(ValueError, match="need 4 devices"):
        tsh.make_mesh(4)
    with pytest.raises(ValueError, match="need 6 devices"):
        tsh.make_mesh_2d(2, 3)


def test_collectives_keep_shard_order():
    parts = [torch.full((2, 3), float(s)) for s in range(4)]
    g = tsh._all_gather(parts, 1)
    assert g.shape == (2, 12)
    np.testing.assert_array_equal(g[0].numpy(), np.repeat(np.arange(4.), 3))
    x = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
         torch.tensor([-1e8]), torch.tensor([1.0])]
    # ((1e8 + 1) - 1e8) + 1 in float32, left to right
    assert float(tsh._psum(x)) == 1.0


# -- sharded postings and caps ------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_postings_bit_equal(n_shards, monkeypatch):
    """The sharded rectangles (shard-local ids, sentinel D_local, P_max
    rounded to 8), the per-shard df and the caps, tier 2 included (a
    small postings budget caps the width)."""
    rng = np.random.default_rng(1)
    corpus = [[f"t{t}" for t in rng.zipf(1.25, size=80) % 900]
              for _ in range(800)]
    pad = tsh.doc_pad_multiple(n_shards)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    j = jsidx.build_split_index(jidx.build_index(
        corpus, doc_pad_multiple=pad), n_frequent=128)
    t = tsidx.build_split_index(tidx.build_index(
        corpus, doc_pad_multiple=pad, device="cpu"), n_frequent=128)
    assert t.post2_doc_ids is not None
    for jb, tb in ((jsidx.build_sharded_postings,
                    tsidx.build_sharded_postings),
                   (jsidx.build_sharded_postings2,
                    tsidx.build_sharded_postings2)):
        jo, to = jb(j, n_shards), tb(t, n_shards)
        for a, b in zip(jo, to):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert to[0].shape[2] % 8 == 0
    assert (to[0] <= pad // n_shards).all()
    _, _, df = tsidx.build_sharded_postings(t, n_shards)
    _, _, df2 = tsidx.build_sharded_postings2(t, n_shards)
    slots = rng.integers(0, df.shape[1], (16, 4)).astype(np.int32)
    slots2 = rng.integers(0, df2.shape[1], (8, 2)).astype(np.int32)
    for k in (1, 10):
        assert tsidx.sharded_candidate_cap(df, slots, k, 40) == (
            jsidx.sharded_candidate_cap(df, slots, k, 40))
        assert tsidx.sharded_candidate_cap2(df, df2, slots[:8], slots2, k,
                                            40, 24) == (
            jsidx.sharded_candidate_cap2(df, df2, slots[:8], slots2, k,
                                         40, 24))


def test_sharded_postings_refuse_a_mesh_that_does_not_divide(pair):
    with pytest.raises(ValueError, match="must divide"):
        tsidx.build_sharded_postings(pair["ts"], 5)


def test_sharded_postings_need_ascending_rows():
    """The one-pass cut relies on each row's ids ascending, as every
    postings table is built; a row out of order raises."""
    pid = np.array([[1, 9, 6, 16], [9, 16, 16, 16]], np.int32)
    with pytest.raises(ValueError, match="ascending"):
        tsidx._shard_postings_rect(pid, np.ones_like(pid, np.float32), 16, 2)
    pid[0] = [1, 6, 9, 16]
    ids, w, df = tsidx._shard_postings_rect(pid, np.ones_like(pid, np.float32),
                                            16, 2)
    np.testing.assert_array_equal(df, [[2, 0], [1, 1]])
    np.testing.assert_array_equal(ids[1, :, :2], [[1, 8], [1, 8]])


# -- doc-major retrieval ------------------------------------------------------


@pytest.mark.parametrize("n_shards", [8, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_topk(pair, n_shards, masked):
    j, t = pair["j"], pair["t"]
    mask = _mask(j.n_docs) if masked else None
    jm = jsh.make_mesh(n_shards)
    jout = jsh.sharded_retrieve_topk(
        jm, *jsh.shard_index_arrays(jm, j.term_ids, j.weights,
                                    j.doc_lengths),
        j.avgdl, *pair["q"], 5, ALPHA, BETA, BR, n_docs=j.n_docs,
        return_tfs=True, doc_mask=mask)
    tm = tsh.make_mesh(n_shards, device="cpu")
    tout = tsh.sharded_retrieve_topk(
        tm, *tsh.shard_index_arrays(tm, t.term_ids, t.weights,
                                    t.doc_lengths),
        t.avgdl, *pair["q"], 5, ALPHA, BETA, BR, n_docs=t.n_docs,
        return_tfs=True, doc_mask=mask)
    _same(jout, tout)
    np.testing.assert_array_equal(_np(tout[3]), np.asarray(jout[3]))


def test_retrieve_topk_2d(pair):
    j, t = pair["j"], pair["t"]
    jout = jsh.sharded_retrieve_topk_2d(
        jsh.make_mesh_2d(4, 2), j.term_ids, j.weights, j.doc_lengths,
        j.avgdl, *pair["q"], 5, ALPHA, BETA, BR)
    tout = tsh.sharded_retrieve_topk_2d(
        tsh.make_mesh_2d(4, 2, device="cpu"), t.term_ids, t.weights,
        t.doc_lengths, t.avgdl, *pair["q"], 5, ALPHA, BETA, BR)
    _same(jout, tout)


def test_planted_tie_goes_to_the_lowest_global_id():
    """Eight identical documents, two per shard on a 4-shard mesh: every
    score ties, and the merge returns them in global id order across
    the shard boundaries, as lax.top_k does on one device."""
    corpus = [["a", "b"]] * 8 + [["c"]] * 8
    j = jidx.build_index(corpus, doc_pad_multiple=16, pad_multiple=8)
    t = tidx.build_index(corpus, doc_pad_multiple=16, pad_multiple=8,
                         device="cpu")
    q = tidx.encode_queries([["a"]], t.vocab)
    jm = jsh.make_mesh(4)
    jout = jsh.sharded_retrieve_topk(jm, j.term_ids, j.weights,
                                     j.doc_lengths, j.avgdl, *q, 6, ALPHA,
                                     BETA, n_docs=16)
    tout = tsh.sharded_retrieve_topk(tsh.make_mesh(4, device="cpu"),
                                     t.term_ids, t.weights, t.doc_lengths,
                                     t.avgdl, *q, 6, ALPHA, BETA, n_docs=16)
    np.testing.assert_array_equal(_np(tout[0]), [[0, 1, 2, 3, 4, 5]])
    _same(jout, tout)
    assert len(set(_np(tout[2])[0].tolist())) == 1


def test_corpus_stats_psum_exact(pair):
    j, t = pair["j"], pair["t"]
    jm = jsh.make_mesh()
    tids, _, dl = jsh.shard_index_arrays(jm, j.term_ids, j.weights,
                                         j.doc_lengths)
    jn, ja, jdf = jsh.corpus_stats_psum(jm, dl, tids, j.n_terms)
    tm = tsh.make_mesh(8, device="cpu")
    tn, ta, tdf = tsh.corpus_stats_psum(tm, t.doc_lengths, t.term_ids,
                                        t.n_terms)
    assert float(tn) == float(jn) == t.term_ids.shape[0]
    assert float(ta) == float(ja)
    assert tdf.dtype == torch.int32
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    np.testing.assert_array_equal(tdf.numpy(), t.doc_frequencies)


# -- split retrieval ----------------------------------------------------------


@pytest.mark.parametrize("n_shards", [8, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_topk_split(pair, n_shards, masked):
    j, t, js, ts = pair["j"], pair["t"], pair["js"], pair["ts"]
    mask = _mask(j.n_docs) if masked else None
    jm = jsh.make_mesh(n_shards)
    jout = jsh.sharded_retrieve_topk_split(
        jm, *jsh.shard_split_index_arrays(jm, js), j.doc_lengths, j.avgdl,
        *pair["enc"], 5, ALPHA, BETA, BR, n_docs=j.n_docs, return_tfs=True,
        doc_mask=mask)
    tm = tsh.make_mesh(n_shards, device="cpu")
    tout = tsh.sharded_retrieve_topk_split(
        tm, *tsh.shard_split_index_arrays(tm, ts), t.doc_lengths, t.avgdl,
        *pair["enc"], 5, ALPHA, BETA, BR, n_docs=t.n_docs, return_tfs=True,
        doc_mask=mask)
    _same(jout, tout)
    np.testing.assert_array_equal(_np(tout[3]), np.asarray(jout[3]))


@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_topk_split_2d(pair, masked):
    j, t, js, ts = pair["j"], pair["t"], pair["js"], pair["ts"]
    mask = _mask(j.n_docs) if masked else None
    jout = jsh.sharded_retrieve_topk_split_2d(
        jsh.make_mesh_2d(4, 2), js.dense_impact, js.dense_presence,
        js.tail_term_ids, js.tail_weights, j.doc_lengths, j.avgdl,
        *pair["enc"], 5, ALPHA, BETA, BR, n_docs=j.n_docs, doc_mask=mask)
    tout = tsh.sharded_retrieve_topk_split_2d(
        tsh.make_mesh_2d(4, 2, device="cpu"), ts.dense_impact,
        ts.dense_presence, ts.tail_term_ids, ts.tail_weights, t.doc_lengths,
        t.avgdl, *pair["enc"], 5, ALPHA, BETA, BR, n_docs=t.n_docs,
        doc_mask=mask)
    _same(jout, tout)


def _sparse_args(split, enc, n_shards, k, sharded_postings):
    fslots, fcnt, trows, tqids, tqcnt = enc
    tslots = tsidx.map_tail_slots(tqids, split)
    pid, pw, df = sharded_postings(split, n_shards)
    cap = tsidx.sharded_candidate_cap(df, tslots, k, pid.shape[2])
    return (pid, pw), (fslots, fcnt, trows, tslots, tqcnt), cap


@pytest.mark.parametrize("n_shards", [8, 2])
@pytest.mark.parametrize("local_k", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_retrieve_topk_split_sparse(pair, n_shards, local_k, masked):
    j, t, js, ts = pair["j"], pair["t"], pair["js"], pair["ts"]
    k = 6
    mask = _mask(j.n_docs) if masked else None
    jpost, enc, cap = _sparse_args(ts, pair["enc"], n_shards, k,
                                   jsidx.build_sharded_postings)
    jm = jsh.make_mesh(n_shards)
    jout = jsh.sharded_retrieve_topk_split_sparse(
        jm, js.dense_impact, js.dense_presence, *jpost, j.doc_lengths,
        j.avgdl, *enc, k, cap, ALPHA, BETA, BR, n_docs=j.n_docs,
        local_k=local_k, tf_from_sign=js.post_w_positive, doc_mask=mask)
    tpost, _, _ = _sparse_args(ts, pair["enc"], n_shards, k,
                               tsidx.build_sharded_postings)
    tout = tsh.sharded_retrieve_topk_split_sparse(
        tsh.make_mesh(n_shards, device="cpu"), ts.dense_impact,
        ts.dense_presence, *tpost, t.doc_lengths, t.avgdl, *enc, k, cap,
        ALPHA, BETA, BR, n_docs=t.n_docs, local_k=local_k,
        tf_from_sign=ts.post_w_positive, doc_mask=mask)
    _same(jout, tout)
    np.testing.assert_array_equal(_np(tout[3]), np.asarray(jout[3]))


# -- dense scores and probabilities -------------------------------------------


def test_scores_and_probabilities_all(pair):
    j, t = pair["j"], pair["t"]
    jm = jsh.make_mesh()
    tm = tsh.make_mesh(8, device="cpu")
    js_, jt_ = jsh.sharded_scores_all(jm, j.term_ids, j.weights, *pair["q"])
    ts_, tt_ = tsh.sharded_scores_all(tm, t.term_ids, t.weights, *pair["q"])
    assert len(ts_) == 8 and ts_[0].shape == (8, 8)
    np.testing.assert_array_equal(_np(ts_), np.asarray(js_))
    np.testing.assert_array_equal(_np(tt_), np.asarray(jt_))
    jp = jsh.sharded_probabilities_all(jm, j.term_ids, j.weights,
                                       j.doc_lengths, j.avgdl, *pair["q"],
                                       ALPHA, BETA, BR)
    tp = tsh.sharded_probabilities_all(tm, t.term_ids, t.weights,
                                       t.doc_lengths, t.avgdl, *pair["q"],
                                       ALPHA, BETA, BR)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("prior_free", [False, True])
def test_scores_all_split_and_transform(pair, prior_free):
    j, t, js, ts = pair["j"], pair["t"], pair["js"], pair["ts"]
    jm = jsh.make_mesh()
    tm = tsh.make_mesh(8, device="cpu")
    jsc, jtf = jsh.sharded_scores_all_split(
        jm, js.dense_impact, js.dense_presence, js.tail_term_ids,
        js.tail_weights, *pair["enc"])
    tsc, ttf = tsh.sharded_scores_all_split(
        tm, ts.dense_impact, ts.dense_presence, ts.tail_term_ids,
        ts.tail_weights, *pair["enc"])
    np.testing.assert_allclose(_np(tsc), np.asarray(jsc), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(_np(ttf), np.asarray(jtf))
    jp = jsh.apply_transform_sharded(jm, jsc, jtf, j.doc_lengths, j.avgdl,
                                     ALPHA, BETA, BR, prior_free=prior_free)
    tp = tsh.apply_transform_sharded(tm, tsc, ttf, t.doc_lengths, t.avgdl,
                                     ALPHA, BETA, BR, prior_free=prior_free)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0,
                               atol=PROB_ATOL)


# -- fits and training steps --------------------------------------------------


@pytest.mark.parametrize("prior_aware, n, max_it, tol, want_it", [
    (False, 4096, 500, 1e-6, 500), (True, 2048, 200, 1e-6, 200),
    (False, 4096, 3000, 1e-5, None)])
def test_sharded_fit_transform(prior_aware, n, max_it, tol, want_it):
    """Float32 in both (JAX with x64 off): alpha and beta within rtol
    1e-5, equal step counts; one fit converges before its cap."""
    rng = np.random.default_rng(7 if not prior_aware else 8)
    scores = rng.normal(1.0, 2.0, n).astype(np.float32)
    p = 1 / (1 + np.exp(-1.5 * (scores - 1.0)))
    labels = (rng.uniform(size=n) < p).astype(np.float32)
    priors = None
    if prior_aware:
        from bayesian_bm25_tpu_torch.ops import transform as TT

        tfs = rng.integers(0, 10, n).astype(np.float32)
        dlr = rng.uniform(0.3, 1.5, n).astype(np.float32)
        priors = TT.composite_prior(tfs, dlr).numpy()
    kw = dict(alpha0=0.5, beta0=0.0, prior_aware=prior_aware, priors=priors,
              learning_rate=0.1, max_iterations=max_it, tolerance=tol)
    with jax.enable_x64(False):
        ja, jb, jit = jsh.sharded_fit_transform(jsh.make_mesh(), scores,
                                                labels, **kw)
        ja, jb, jit = float(ja), float(jb), int(jit)
    ta, tb, tit = tsh.sharded_fit_transform(
        tsh.make_mesh(8, device="cpu"), scores, labels, **kw)
    assert ta.dtype == torch.float32
    assert tit == jit
    if want_it is not None:
        assert tit == want_it
    else:
        assert tit < max_it
    np.testing.assert_allclose([float(ta), float(tb)], [ja, jb], rtol=1e-5,
                               atol=1e-6)


def test_sharded_train_steps(pair):
    """Both training steps against JAX's, and the split step equal to the
    doc-major one (their per-shard scores are equal)."""
    j, t, js, ts = pair["j"], pair["t"], pair["js"], pair["ts"]
    rng = np.random.default_rng(0)
    D_pad = t.term_ids.shape[0]
    labels = (rng.uniform(size=(len(QUERIES), D_pad)) < 0.1).astype(
        np.float32)
    jm = jsh.make_mesh()
    tm = tsh.make_mesh(8, device="cpu")
    jstep = jsh.sharded_train_step(jm, j.term_ids, j.weights, j.doc_lengths,
                                   j.avgdl, *pair["q"], labels, 1.0, 2.0,
                                   learning_rate=0.1)
    tstep = tsh.sharded_train_step(tm, t.term_ids, t.weights, t.doc_lengths,
                                   t.avgdl, *pair["q"], labels, 1.0, 2.0,
                                   learning_rate=0.1)
    jsplit = jsh.sharded_train_step_split(
        jm, js.dense_impact, js.dense_presence, js.tail_term_ids,
        js.tail_weights, *pair["enc"], labels, 1.0, 2.0, learning_rate=0.1)
    tsplit = tsh.sharded_train_step_split(
        tm, ts.dense_impact, ts.dense_presence, ts.tail_term_ids,
        ts.tail_weights, *pair["enc"], labels, 1.0, 2.0, learning_rate=0.1)
    for jo, to in ((jstep, tstep), (jsplit, tsplit), (tstep, tsplit)):
        np.testing.assert_allclose([float(x) for x in to],
                                   [float(x) for x in jo], rtol=1e-5)
    a2, b2, loss2 = tsh.sharded_train_step(
        tm, t.term_ids, t.weights, t.doc_lengths, t.avgdl, *pair["q"],
        labels, float(tstep[0]), float(tstep[1]), learning_rate=0.1)
    assert float(loss2) <= float(tstep[2]) + 1e-7


def test_dryrun_tiny_shapes():
    """The JAX package's multi-device dry run, on the port: one sharded
    training step, one distributed retrieve, the psum'd statistics and
    the 2-D and split forms, at tiny shapes on an 8-shard CPU mesh."""
    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.integers(0, 200, 20)] for _ in range(64)]
    idx = tidx.build_index(corpus, doc_pad_multiple=8, pad_multiple=8,
                           device="cpu")
    queries = [[f"t{t}" for t in rng.integers(0, 200, 5)] for _ in range(4)]
    qids, qcnt = tidx.encode_queries(queries, idx.vocab)
    mesh = tsh.make_mesh(8, device="cpu")
    tids, w, dl = tsh.shard_index_arrays(mesh, idx.term_ids, idx.weights,
                                         idx.doc_lengths)
    D_pad = idx.term_ids.shape[0]
    labels = (rng.uniform(size=(4, D_pad)) < 0.1).astype(np.float32)
    alpha, beta, loss = tsh.sharded_train_step(mesh, tids, w, dl, idx.avgdl,
                                               qids, qcnt, labels, 1.0, 2.0)
    assert np.isfinite(float(loss))
    ids, probs, _ = tsh.sharded_retrieve_topk(mesh, tids, w, dl, idx.avgdl,
                                              qids, qcnt, 5, float(alpha),
                                              float(beta), 0.05)
    assert ids.shape == probs.shape == (4, 5)
    n, _, _ = tsh.corpus_stats_psum(mesh, dl, tids, idx.n_terms)
    assert float(n) == D_pad
    ids2d, _, _ = tsh.sharded_retrieve_topk_2d(
        tsh.make_mesh_2d(2, 4, device="cpu"), idx.term_ids, idx.weights,
        idx.doc_lengths, idx.avgdl, qids, qcnt, 5, float(alpha),
        float(beta), 0.05)
    assert ids2d.shape == (4, 5)
    split = tsidx.build_split_index(idx, n_frequent=128,
                                    enable_overflow=False, device="cpu")
    enc = tsidx.encode_queries_split(queries, split)
    arrays = tsh.shard_split_index_arrays(mesh, split)
    assert [p.shape[0] for p in arrays[0]] == [8] * 8
    ids_s, _, _ = tsh.sharded_retrieve_topk_split(
        mesh, *arrays, dl, idx.avgdl, *enc, 5, float(alpha), float(beta),
        0.05, n_docs=idx.n_docs)
    assert ids_s.shape == (4, 5)
    *_, loss_s = tsh.sharded_train_step_split(mesh, *arrays, *enc, labels,
                                              1.0, 2.0)
    assert np.isfinite(float(loss_s))
