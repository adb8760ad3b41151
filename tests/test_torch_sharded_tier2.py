"""PyTorch port: the sharded sparse path at width-capped scale (tier-2
postings, the light/heavy split), against the JAX package's sharded
scorer on its 8 virtual CPU devices and the port's single scorer.

The protocol of ``tests/test_sharded_tier2.py``: budgets patched small
in both packages (``_SPLIT_BUDGET_BYTES``, ``_POSTINGS_MAX_ENTRIES``,
``LIGHT_HEAVY`` and its floors) so that an 800-doc corpus caps its
postings width. The port's sharded scorer must take the sharded
sparse-candidate path, not the compare-tail fallback, and run its
tier-1, heavy and tier-2 merge passes in every shard (recorded at
``split_index._sparse_merge``). Ids equal the port's single scorer's and
JAX's; probabilities equal the single scorer's and lie within atol 1e-5
of JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu_torch.engine import split_index as tsidx

from torch_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

F64 = dict(device="cpu", prob_dtype=torch.float64)


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=40, V=900):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    # edge rows: duplicate tokens, OOV, empty, single rare term
    return qs + [["t1", "t1", "t2"], ["zzz-oov"], [], [f"t{V - 1}"]]


CORPUS, QUERIES = _corpus(), _queries()


def _patch(monkeypatch, budget, light_heavy=False):
    for cls in (jbb.BayesianBM25Scorer, tbb.BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", budget)
        monkeypatch.setattr(mod, "LIGHT_HEAVY", light_heavy)
        if light_heavy:
            monkeypatch.setattr(mod, "_LH_MIN_SAVE", 0)
            monkeypatch.setattr(mod, "_LH_MIN_RATIO", 1.0)


def _build():
    j = jbb.ShardedBayesianBM25Scorer(base_rate=0.01, n_devices=8)
    j.index(CORPUS, show_progress=False)
    t = tbb.ShardedBayesianBM25Scorer(base_rate=0.01, n_devices=8, **F64)
    t.index(CORPUS, show_progress=False)
    s = tbb.BayesianBM25Scorer(base_rate=0.01, **F64)
    s.index(CORPUS, show_progress=False)
    return j, t, s


def _passes(monkeypatch):
    """Record the kind of every _sparse_merge call: "tier-2" (group B's
    postings2), "heavy" (over a previous pass) or "tier-1"."""
    kinds = []
    orig = tsidx._sparse_merge

    def merge(*a, **kw):
        kinds.append("tier-2" if kw.get("postings2") is not None else
                     "heavy" if kw.get("base_tail_tf") is not None
                     else "tier-1")
        return orig(*a, **kw)

    monkeypatch.setattr(tsidx, "_sparse_merge", merge)
    return kinds


def _agree(j, t, s, **kw):
    ji, jp = j.retrieve(QUERIES, k=10, **kw)
    ti, tp = t.retrieve(QUERIES, k=10, **kw)
    si, sp = s.retrieve(QUERIES, k=10, **kw)
    np.testing.assert_array_equal(ti, si)
    np.testing.assert_array_equal(tp, sp)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-5)
    return ti


class TestShardedTier2:
    def test_capped_takes_sparse_path(self, monkeypatch):
        _patch(monkeypatch, 20000)
        j, t, _ = _build()
        s = t._split
        assert s.post2_doc_ids is not None, "cap did not engage"
        assert t._post_sh is not None, "sharded path fell back"
        assert t._post2_sh is not None, "tier-2 tables not sharded"
        # per-shard tier-2 tables keep the global one's row count
        assert t._post2_sh[0][0].shape[0] == s.post2_doc_ids.shape[0]
        for a, b in zip(t._post_sh + t._post2_sh, j._post_sh + j._post2_sh):
            got = (np.stack([p.numpy() for p in a]) if isinstance(a, list)
                   else a)
            np.testing.assert_array_equal(got, np.asarray(b))

    def test_capped_matches_single(self, monkeypatch):
        _patch(monkeypatch, 20000)
        j, t, s = _build()
        fs, fc, tr, tq, tc = tsidx.encode_queries_split(QUERIES, t._split)
        _, grpB = tsidx.split_tail_groups(tr, tq, tc, t._split)
        assert grpB is not None, "no tier-2 rows in the test batch"
        kinds = _passes(monkeypatch)
        ids = t.retrieve(QUERIES, k=10)[0]
        assert kinds == ["tier-1", "tier-2"] * 8     # both, in every shard
        np.testing.assert_array_equal(ids, _agree(j, t, s))

    def test_capped_light_heavy_matches(self, monkeypatch):
        _patch(monkeypatch, 20000, light_heavy=True)
        j, t, s = _build()
        fs, fc, tr, tq, tc = tsidx.encode_queries_split(QUERIES, t._split)
        (tr, ts, tc), grpB = tsidx.split_tail_groups(tr, tq, tc, t._split)
        assert grpB is not None
        assert tsidx.split_light_heavy(tr, ts, tc, t._split, 10) \
            is not None, "light/heavy did not engage"
        kinds = _passes(monkeypatch)
        ids = t.retrieve(QUERIES, k=10)[0]
        assert kinds == ["tier-1", "heavy", "tier-2"] * 8
        np.testing.assert_array_equal(ids, _agree(j, t, s))

    def test_capped_with_doc_mask(self, monkeypatch):
        _patch(monkeypatch, 20000, light_heavy=True)
        j, t, s = _build()
        rng = np.random.default_rng(3)
        mask = rng.random(s.num_docs) > 0.3
        ids = _agree(j, t, s, doc_mask=mask)
        assert np.all(mask[ids[ids >= 0]])

    def test_capped_explain_tf_parity(self, monkeypatch):
        _patch(monkeypatch, 20000)
        j, t, s = _build()
        qs = QUERIES[:12]
        e = [x.retrieve(qs, k=5, explain=True) for x in (j, t, s)]
        np.testing.assert_array_equal(e[1].doc_ids, e[2].doc_ids)
        np.testing.assert_array_equal(e[1].doc_ids, e[0].doc_ids)
        for rows in zip(*(r.explanations for r in e)):
            for a, b, c in zip(*rows):
                assert (a is None) == (b is None) == (c is None)
                if b is not None:
                    assert a.tf == b.tf == c.tf
                    assert b.posterior == c.posterior

    def test_uncapped_unchanged(self, monkeypatch):
        """The wide-budget common case takes the one-pass path."""
        _patch(monkeypatch, 128_000_000)
        j, t, s = _build()
        assert t._split.post2_doc_ids is None
        assert t._post2_sh is None
        kinds = _passes(monkeypatch)
        t.retrieve(QUERIES, k=10)
        assert kinds == ["tier-1"] * 8
        _agree(j, t, s)
