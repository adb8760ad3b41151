"""The plain reference: against a loop written from the BM25 formula,
and against the port on a small corpus on the CPU."""

import math

import numpy as np
import pytest
import torch

from perfbench import gen, plugins
from perfbench.reference import Reference, probability


def _texts(rows):
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return gen.Texts(np.concatenate(rows).astype(np.int32),
                     offsets.astype(np.int64))


def test_scores_are_the_formula():
    rng = np.random.default_rng(0)
    rows = [rng.integers(0, 12, rng.integers(1, 9)) for _ in range(40)]
    ref = Reference(_texts(rows))
    N = len(rows)
    avgdl = np.mean([len(r) for r in rows])
    df = {t: sum(t in set(r.tolist()) for r in rows) for t in range(12)}
    q = np.array([1, 3, 3, 7, 20])
    want = np.zeros(N)
    for d, r in enumerate(rows):
        for t in set(q.tolist()):
            tf = int((r == t).sum())
            if tf == 0:
                continue
            idf = max(math.log((N - df[t] + 0.5) / (df[t] + 0.5)), 0.0)
            norm = 1 - 0.75 + 0.75 * len(r) / avgdl
            want[d] += int((q == t).sum()) * idf * 2.2 * tf / (tf + 1.2 * norm)
    got = ref.scores([q])[0].numpy()
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    ids = torch.tensor([[0, 5, -1]])
    tf = ref.tf_at([q], ids)[0].tolist()
    assert tf == [len({1, 3, 7, 20} & set(rows[0].tolist())),
                  len({1, 3, 7, 20} & set(rows[5].tolist())), 0]


def test_transform_matches_the_port_in_float64():
    from bayesian_bm25_tpu_torch.ops import transform as T

    rng = np.random.default_rng(1)
    s = rng.uniform(0.01, 12, 500)
    tf = rng.integers(0, 14, 500).astype(float)
    r = rng.uniform(0, 3, 500)
    want = T.score_to_probability(torch.tensor(s), torch.tensor(tf),
                                  torch.tensor(r), 0.7, 3.1, 0.02,
                                  dtype=torch.float64).numpy()
    assert np.allclose(probability(s, tf, r, 0.7, 3.1, 0.02), want,
                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("storage", [None, "int8"])
def test_reference_against_the_port_on_the_cpu(storage):
    from bayesian_bm25_tpu_torch import BayesianBM25Scorer

    cfg = plugins.load_json("configs", "fiqa")
    cfg["corpus"]["docs"] = 1500
    cfg["corpus"]["length"]["mean"] = 30
    rc, rq, _ = gen.streams(11)
    corpus = gen.corpus(cfg, rc)
    names = gen.token_names(30000)
    sc = BayesianBM25Scorer(base_rate="auto", impact_storage=storage,
                            device="cpu")
    sc.index(gen.to_tokens(corpus, names))
    ref = Reference(corpus)
    q = gen.queries(cfg, rq, 64)
    qs = [q.row(i) for i in range(len(q))]
    want = ref.scores(qs).numpy()
    got = sc.get_scores_batch(gen.to_tokens(q, names))
    assert np.abs(got - want).max() <= 1e-4 * want.max()
    alpha, beta, base_rate = ref.calibration(corpus)
    t = sc.transform
    assert t.alpha == pytest.approx(alpha, rel=1e-4)
    assert t.beta == pytest.approx(beta, rel=1e-4)
    if storage is None:
        # hilo keeps tied weights tied: the percentile base rate agrees
        assert t.base_rate == pytest.approx(base_rate, rel=1e-9)
    else:
        # the int8 pair unties some: the base rate over its scores
        K = sc._split.n_frequent
        held = ref.int8_pair_scores(qs, K).double().numpy()
        assert np.array_equal(held, sc._scores_internal(
            gen.to_tokens(q, names)))
        stored = dict(storage="int8_pair", frequent_terms=K)
        assert t.base_rate == pytest.approx(
            ref.calibration(corpus, stored=stored)[2], rel=1e-12)
