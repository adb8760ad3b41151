"""PyTorch port: ``ShardedBayesianBM25Scorer`` against the JAX package's
sharded scorer on its 8 virtual CPU devices and against the port's own
single-device scorer.

The battery of ``tests/test_sharded_scorer.py``, run three ways on the
same seeded corpora: the JAX sharded scorer, the port's sharded scorer
on a mesh of shards on the CPU (``device="cpu"``) and the port's
single-device scorer. Against the port's single scorer, ids and
probabilities are equal (the shards' products round as the whole
product does and the transform is the same float64 one). Against JAX,
ids are equal and probabilities within atol 1e-5 (the JAX bodies take
the transform's scalars as float32 operands); the estimated parameters
within rtol 1e-6. No tensor of a sharded scorer spans the whole doc
axis, and without CUDA a mesh over the cards raises.
"""

import jax
import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.parallel import sharded as jsh
from bayesian_bm25_tpu_torch.engine import cuda_matmul as tcm
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.parallel import sharded as tsh

from torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

F64 = dict(device="cpu", prob_dtype=torch.float64)
JAX_ATOL = 1e-5


def random_corpus(rng, n_docs, vocab, max_len):
    return [
        [f"t{t}" for t in rng.integers(0, vocab, rng.integers(1, max_len))]
        for _ in range(n_docs)
    ]


def _three(corpus, n_shards=8, mesh_shape=None, **kw):
    """(JAX sharded, port sharded, port single) indexed on ``corpus``."""
    mesh = dict(mesh_shape=mesh_shape) if mesh_shape else dict(
        n_devices=n_shards)
    j = jbb.ShardedBayesianBM25Scorer(**kw, **mesh)
    j.index(corpus, show_progress=False)
    t = tbb.ShardedBayesianBM25Scorer(**kw, **mesh, **F64)
    t.index(corpus, show_progress=False)
    s = tbb.BayesianBM25Scorer(**kw, **F64)
    s.index(corpus, show_progress=False)
    return j, t, s


@pytest.fixture(scope="module")
def trio():
    """The three scorers on a 400-doc corpus, built with a small split
    budget (128 frequent terms of 500) so that retrieval merges a rare
    tail."""
    rng = np.random.default_rng(0)
    corpus = random_corpus(rng, 400, 500, 40)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jbb.BayesianBM25Scorer, tbb.BayesianBM25Scorer):
            mp.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
        return (*_three(corpus, base_rate="auto"), corpus)


def _agree(outs, jax_atol=JAX_ATOL):
    """(ids, probs) of JAX sharded, port sharded, port single: ids equal,
    the port's two equal, JAX's within ``jax_atol``."""
    (ji, jp), (ti, tp), (si, sp) = outs[:3]
    np.testing.assert_array_equal(ti, si)
    np.testing.assert_array_equal(tp, sp)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=jax_atol)


def _each(scorers, fn):
    return [fn(x) for x in scorers]


class TestIndexParity:
    def test_estimated_parameters(self, trio):
        j, t, s, _ = trio
        for name in ("alpha", "beta"):
            assert getattr(t.transform, name) == getattr(s.transform, name)
            assert getattr(t.transform, name) == pytest.approx(
                getattr(j.transform, name), rel=1e-6)
        assert t.base_rate == s.base_rate == pytest.approx(j.base_rate,
                                                           rel=1e-6)
        assert t.num_docs == s.num_docs == j.num_docs
        assert t.avgdl == s.avgdl == j.avgdl

    def test_no_tensor_spans_the_doc_axis(self, trio):
        _, t, _, _ = trio
        D_pad = t.bm25_index.term_ids_host.shape[0]
        D_local = D_pad // 8
        assert t.mesh.shape == {"d": 8}
        idx, split = t.bm25_index, t._split
        assert idx.term_ids is None and idx.weights is None
        assert idx.doc_lengths is None
        for name in ("dense_impact", "dense_impact_lo", "dense_presence",
                     "tail_term_ids", "tail_weights", "impact_scale"):
            assert getattr(split, name) is None, name
        held = [v for obj in (t, idx, split) for v in vars(obj).values()]
        held += [p for parts in t._sh.values() for p in parts]
        held += [p for parts in t._post_sh[:2] for p in parts]
        tensors = [v for v in held if isinstance(v, torch.Tensor)]
        assert len(tensors) > 20
        assert all(D_pad not in v.shape for v in tensors)
        for name, parts in t._sh.items():
            if parts[0] is not None:
                assert len(parts) == 8
                assert all(p.shape[0] == D_local for p in parts), name


class TestQueryParity:
    def test_retrieve_exact(self, trio):
        *scorers, corpus = trio
        queries = [corpus[i][:5] for i in range(0, 60, 7)]
        queries += [["zzz_oov"], [], ["t1", "t1", "t3"]]
        _agree(_each(scorers, lambda x: x.retrieve(queries, k=10)))

    def test_retrieve_large_k_ties(self, trio):
        # k beyond the matches: zero-score ties, pad masking and the
        # shard-major merge order give the single scorer's lowest ids
        *scorers, _ = trio
        _agree(_each(scorers, lambda x: x.retrieve([["t3"]], k=50)))

    def test_retrieve_many_stream_and_k0(self, trio):
        _, t, s, corpus = trio
        batches = [[corpus[i][:4] for i in range(5)], [corpus[9][:3]], [[]]]
        for a, b in zip(t.retrieve_many(batches, k=7),
                        s.retrieve_many(batches, k=7)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        for a, b in zip(t.retrieve_stream(iter(batches), k=7, lookahead=2),
                        s.retrieve_many(batches, k=7)):
            np.testing.assert_array_equal(a[0], b[0])
        ids, probs = t.retrieve(batches[0], k=0)
        assert ids.shape == probs.shape == (5, 0)

    def test_scores_batch_exact(self, trio):
        *scorers, corpus = trio
        queries = [corpus[3][:4], corpus[9][:6]]
        j, t, s = _each(scorers, lambda x: x.get_scores_batch(queries))
        np.testing.assert_array_equal(t, s)
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=2e-6)

    def test_probabilities_batch_exact(self, trio):
        *scorers, corpus = trio
        queries = [corpus[3][:4], ["t7", "t8"]]
        j, t, s = _each(scorers,
                        lambda x: x.get_probabilities_batch(queries))
        np.testing.assert_array_equal(t, s)
        np.testing.assert_allclose(t, j, rtol=0, atol=JAX_ATOL)

    def test_thresholded_exact(self, trio):
        *scorers, corpus = trio
        queries = [corpus[5][:5], corpus[11][:5]]
        mask = np.arange(scorers[1].num_docs) % 3 > 0
        for kw in ({}, {"doc_mask": mask}):
            (ji, jp, jn), (ti, tp, tn), (si, sp, sn) = _each(
                scorers, lambda x: x.retrieve_thresholded(queries, 0.5, k=5,
                                                          **kw))
            np.testing.assert_array_equal(tn, sn)
            np.testing.assert_array_equal(tn, jn)
            _agree([(ji, jp), (ti, tp), (si, sp)])

    def test_explain_traces(self, trio):
        *scorers, corpus = trio
        j, t, s = _each(scorers, lambda x: x.retrieve(
            [corpus[2][:4], corpus[7][:3]], k=3, explain=True))
        np.testing.assert_array_equal(t.doc_ids, s.doc_ids)
        np.testing.assert_array_equal(t.doc_ids, j.doc_ids)
        for rt, rs, rj in zip(t.explanations, s.explanations,
                              j.explanations):
            for a, b, c in zip(rt, rs, rj):
                assert (a is None) == (b is None) == (c is None)
                if a is not None:
                    assert a.posterior == b.posterior
                    assert a.tf == b.tf == c.tf
                    assert a.posterior == pytest.approx(c.posterior,
                                                        rel=1e-5)
        tr = t.explanations[0][0]
        assert tr.posterior == pytest.approx(t.probabilities[0][0],
                                             rel=1e-5)

    def test_fused_product_per_shard(self, trio, monkeypatch):
        """FUSED_MM on: each shard's product and block maxima through
        K4's plain version here, equal to the single scorer's fused
        path and to the unfused run."""
        _, t, s, corpus = trio
        queries = [corpus[i][:5] for i in range(0, 40, 3)]
        base = t.retrieve(queries, k=8)
        monkeypatch.setattr(tsidx, "FUSED_MM", True)
        fused = t.retrieve(queries, k=8)
        assert "impact_cols" in t._sh
        single = s.retrieve(queries, k=8)
        for a, b in ((fused, single), (fused, base)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])

    def test_default_route_on_the_cpu(self, trio, monkeypatch):
        """Under the default (FUSED_MM None) the shards on the CPU take
        the library product, as the single scorer does there: K4 is
        never called."""
        _, t, s, corpus = trio
        assert tsidx.FUSED_MM is None
        calls = []

        def spy(*args):
            calls.append(args[-1])
            return real(*args)

        real = tcm.impact_matmul_bmax
        monkeypatch.setattr(tcm, "impact_matmul_bmax", spy)
        queries = [corpus[i][:5] for i in range(0, 40, 3)]
        got = t.retrieve(queries, k=8)
        assert calls == []
        single = s.retrieve(queries, k=8)
        np.testing.assert_array_equal(got[0], single[0])
        np.testing.assert_array_equal(got[1], single[1])

    def test_tombstones(self, trio):
        _, t, s, corpus = trio
        queries = [corpus[i][:5] for i in range(0, 30, 4)]
        try:
            for x in (t, s):
                x.delete_documents([0, 4, 8, 100, 399])
            _agree([s.retrieve(queries, k=6), t.retrieve(queries, k=6),
                    s.retrieve(queries, k=6)], jax_atol=0)
            np.testing.assert_array_equal(t.get_scores_batch(queries),
                                          s.get_scores_batch(queries))
        finally:
            for x in (t, s):
                x.restore_documents(range(400))


class TestLifecycleParity:
    @pytest.mark.parametrize("n_shards, n_docs, vocab", [(8, 400, 500),
                                                         (3, 60, 120)])
    def test_add_documents(self, n_shards, n_docs, vocab):
        rng = np.random.default_rng(7)
        corpus = random_corpus(rng, n_docs, vocab, 30)
        extra = random_corpus(rng, 30, vocab + 100, 30)
        scorers = _three(corpus, n_shards, base_rate="auto")
        for x in scorers:
            x.add_documents(extra)
        t = scorers[1]
        assert t.num_docs == n_docs + 30
        assert t.bm25_index.term_ids_host.shape[0] % n_shards == 0
        if n_shards == 3:
            assert t.bm25_index.term_ids_host.shape[0] == 6144
        q = [extra[0][:5], corpus[0][:5]]
        _agree(_each(scorers, lambda x: x.retrieve(q, k=8)))
        assert t.transform.alpha == scorers[2].transform.alpha

    def test_no_split_small_vocab(self):
        # a vocabulary of <= 256 terms: no split, the doc-major path
        rng = np.random.default_rng(5)
        corpus = [[f"t{t}" for t in rng.integers(0, 50, 12)]
                  for _ in range(100)]
        scorers = _three(corpus)
        assert scorers[1]._split is None
        q = [corpus[4][:4], ["t1"]]
        _agree(_each(scorers, lambda x: x.retrieve(q, k=7)))
        j, t, s = _each(scorers, lambda x: x.get_probabilities_batch(q))
        np.testing.assert_array_equal(t, s)

    def test_index_texts(self):
        texts = [f"document number {i} about topic {i % 7}"
                 for i in range(64)]
        j = jbb.ShardedBayesianBM25Scorer(n_devices=8)
        j.index_texts(texts)
        t = tbb.ShardedBayesianBM25Scorer(n_devices=8, **F64)
        t.index_texts(texts)
        s = tbb.BayesianBM25Scorer(**F64)
        s.index_texts(texts)
        _agree(_each((j, t, s),
                     lambda x: x.retrieve_texts(["topic 3"], k=5)))

    def test_mesh_validation(self):
        sc = tbb.ShardedBayesianBM25Scorer(
            mesh=tsh.make_mesh_2d(2, 4, device="cpu"))
        assert sc._is_2d and sc._n_shards == 4
        assert sc.device == torch.device("cpu")
        for bad in (tsh.ShardMesh(np.array([torch.device("cpu")] * 8,
                                           dtype=object).reshape(4, 2),
                                  ("a", "b")),
                    tsh.ShardMesh([torch.device("cpu")] * 2, ("q",))):
            with pytest.raises(ValueError, match="mesh must be"):
                tbb.ShardedBayesianBM25Scorer(mesh=bad)

    @pytest.mark.parametrize("kw", [dict(n_devices=2), dict(),
                                    dict(mesh_shape=(2, 2)),
                                    dict(n_devices=2, device="cuda")])
    def test_no_cuda_raises(self, kw, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tbb.ShardedBayesianBM25Scorer(**kw)


class TestShardedDocMask:
    def test_masked_retrieve_matches(self):
        rng = np.random.default_rng(17)
        corpus = [[f"t{t}" for t in rng.zipf(1.4, size=20) % 600]
                  for _ in range(160)]
        queries = [[f"t{t}" for t in rng.zipf(1.4, size=5) % 600]
                   for _ in range(8)]
        mask = rng.uniform(size=len(corpus)) < 0.5
        scorers = _three(corpus, base_rate="auto",
                         matmul_precision="highest")
        outs = _each(scorers, lambda x: x.retrieve(queries, k=5,
                                                   doc_mask=mask))
        _agree(outs)
        ids = outs[1][0]
        assert np.all(mask[ids[ids >= 0]])

    def test_bad_mask_shape_raises(self, trio):
        _, t, _, corpus = trio
        with pytest.raises(ValueError, match="doc_mask"):
            t.retrieve([corpus[0][:3]], k=3, doc_mask=np.ones(7, dtype=bool))


class TestShardedSparsePath:
    def test_sparse_postings_built(self, trio):
        _, t, _, _ = trio
        pid_sh, pw_sh, df_sh = t._post_sh
        assert len(pid_sh) == 8 and df_sh.shape[0] == 8
        assert t._split.n_frequent == 128 and df_sh.sum() > 0
        # the per-shard dfs partition the global postings
        np.testing.assert_array_equal(df_sh.sum(axis=0), t._split.rare_df)

    def test_approx_flag_runs(self, trio):
        _, t, _, corpus = trio
        queries = [corpus[2][:5], corpus[8][:4]]
        ids_a, probs_a = t.retrieve(queries, k=5, approx=True)
        ids_e, probs_e = t.retrieve(queries, k=5)
        np.testing.assert_array_equal(ids_a, ids_e)
        np.testing.assert_array_equal(probs_a, probs_e)

    def test_retrieve_equal_packed_on_off(self, trio, monkeypatch):
        _, t, _, corpus = trio
        queries = [corpus[i][:6] for i in range(0, 90, 11)]
        queries += [[], ["zzz_oov"], corpus[3][:1]]
        monkeypatch.setattr(tsidx, "PACKED_BUILD", False)
        ids0, probs0 = t.retrieve(queries, k=9)
        monkeypatch.setattr(tsidx, "PACKED_BUILD", True)
        ids1, probs1 = t.retrieve(queries, k=9)
        np.testing.assert_array_equal(ids0, ids1)
        np.testing.assert_array_equal(probs0, probs1)

    def test_sharded_postings_round_trip(self, trio, monkeypatch):
        # A small split budget (128 frequent terms) leaves a rare tail.
        monkeypatch.setattr(tbb.BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES",
                            2_000_000)
        t = tbb.ShardedBayesianBM25Scorer(n_devices=8, **F64)
        t.index(trio[3], show_progress=False)
        s = t._split
        assert s.n_frequent == 128
        pid_sh = [p.numpy() for p in t._post_sh[0]]
        pw_sh = [p.numpy() for p in t._post_sh[1]]
        D_pad = t.bm25_index.term_ids_host.shape[0]
        D_local = D_pad // 8
        got, want = {}, {}
        for sh in range(8):
            rr, cc = np.nonzero(pid_sh[sh] < D_local)
            for r, c in zip(rr, cc):
                got.setdefault(int(r), []).append(
                    (sh * D_local + int(pid_sh[sh][r, c]),
                     float(pw_sh[sh][r, c])))
        gpid, gpw = s.post_doc_ids.numpy(), s.post_weights.numpy()
        rr, cc = np.nonzero(gpid < D_pad)
        for r, c in zip(rr, cc):
            want.setdefault(int(r), []).append((int(gpid[r, c]),
                                                float(gpw[r, c])))
        assert want and got == want      # ascending ids in both


class TestMesh2D:
    def test_retrieve_parity(self):
        rng = np.random.default_rng(5)
        corpus = random_corpus(rng, 300, 400, 30)
        scorers = _three(corpus, mesh_shape=(2, 4), base_rate="auto")
        assert scorers[1].mesh.shape == {"q": 2, "d": 4}
        queries = [corpus[3][:5], corpus[7][:4], corpus[11][:3]]
        _agree(_each(scorers, lambda x: x.retrieve(queries, k=5)))
        res = scorers[1].retrieve(queries, k=5, explain=True)
        ref = scorers[2].retrieve(queries, k=5, explain=True)
        assert [[e and e.tf for e in r] for r in res.explanations] == [
            [e and e.tf for e in r] for r in ref.explanations]

    def test_doc_mask_on_2d(self):
        rng = np.random.default_rng(6)
        corpus = random_corpus(rng, 200, 300, 25)
        scorers = _three(corpus, mesh_shape=(2, 4), base_rate="auto")
        mask = np.ones(scorers[1].num_docs, bool)
        mask[::2] = False
        outs = _each(scorers, lambda x: x.retrieve([corpus[1][:4]], k=5,
                                                   doc_mask=mask))
        _agree(outs)
        live = outs[1][0][outs[1][0] >= 0]
        assert np.all(mask[live])


class TestLocalK:
    def _run(self, trio, k, local_k):
        j, t, s, corpus = trio
        queries = [corpus[1][:5], corpus[6][:4]]
        outs = []
        for pkg, sc in ((jsh, j), (tsh, t)):
            sidx = tsidx if pkg is tsh else jsidx
            fslots, fcnt, trows, tqids, tqcnt = (
                sidx.encode_queries_split(queries, sc._split))
            tslots = sidx.map_tail_slots(tqids, sc._split)
            pid_sh, pw_sh, df_sh = sc._post_sh
            cap = sidx.sharded_candidate_cap(df_sh, tslots, k,
                                             pid_sh[0].shape[-1])
            if pkg is tsh:
                ar = sc._sh
                arrays = (ar["dense_impact"], ar["dense_presence"], pid_sh,
                          pw_sh, ar["doc_lengths"])
                lo = ar["dense_impact_lo"]
            else:
                spl, idx = sc._split, sc._index
                arrays = (spl.dense_impact, spl.dense_presence, pid_sh,
                          pw_sh, idx.doc_lengths)
                lo = spl.dense_impact_lo
            tr = sc.transform
            out = pkg.sharded_retrieve_topk_split_sparse(
                sc.mesh, *arrays, sc.avgdl, fslots, fcnt, trows, tslots,
                tqcnt, k, cap, tr.alpha, tr.beta, tr.base_rate,
                n_docs=sc.num_docs, impact_lo=lo, local_k=local_k)
            outs.append(np.asarray(out[0]) if pkg is jsh
                        else out[0].numpy())
        return outs, s.retrieve(queries, k=k)[0]

    def test_local_k_equals_k_is_exact(self, trio):
        (j_ids, t_ids), ref = self._run(trio, 25, 25)
        np.testing.assert_array_equal(t_ids, ref)
        np.testing.assert_array_equal(t_ids, j_ids)

    def test_local_k_reduced_high_recall(self, trio):
        # 8 shards x local_k 8 = 64 candidates for the top 32: on 50
        # docs a shard the winners concentrate, so recall drops (the
        # knob trades it for merge width); the ids still equal JAX's
        (j_ids, t_ids), ref = self._run(trio, 32, 8)
        np.testing.assert_array_equal(t_ids, j_ids)
        assert t_ids.shape == (2, 32)
        for row in range(2):
            ref_set = set(ref[row][ref[row] >= 0].tolist())
            got_set = set(t_ids[row][t_ids[row] >= 0].tolist())
            assert len(got_set & ref_set) / len(ref_set) >= 0.3
            assert got_set <= set(range(400))
