"""PyTorch port: ``SimpleIVF`` (``engine/ivf.py``) and the search
diagnostics (``utils/diagnostics.py``) against the JAX package.

``build`` runs on well-separated seeded clusters, where the float32
products of the two packages cannot disagree on an assignment:
assignments, cell layout and populations are equal, centroids within
1e-5 (the update sums float32 in another order). The searches run on a
carried JAX state (``utils/convert.ivf_from_numpy``), which separates
their parity from the build's float order. Each cosine score is one
float32 dot product that XLA and torch sum in another order, so scores
agree within 1e-6 and two documents whose scores lie that close are a
tie that either package may order first: ids are bit-equal at every
other rank, and at every -inf rank (probed cells holding fewer than k
documents: index order in both). The diagnostics and the gate read the
same search results in both packages: rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.engine import ivf as J
from bayesian_bm25_tpu.utils import diagnostics as JD
from bayesian_bm25_tpu_torch.engine import ivf as P
from bayesian_bm25_tpu_torch.utils import convert
from bayesian_bm25_tpu_torch.utils import diagnostics as PD

from torch_helpers import one_thread  # noqa: F401

CPU = dict(device="cpu")
SCORE_TOL = 1e-6


def _assert_ranked_equal(ti, ts, ji, js):
    """Ids equal at every rank whose JAX score is more than SCORE_TOL
    from the other scores of its row (and at every -inf rank), the same
    ids among each row's tied ranks, scores within SCORE_TOL, -inf at
    the same ranks."""
    ti, ts, ji, js = (np.atleast_2d(a) for a in (ti, ts, ji, js))
    assert ti.shape == ji.shape
    if ji.size == 0:
        return
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], atol=SCORE_TOL, rtol=0)
    with np.errstate(invalid="ignore"):  # -inf - -inf
        gap = np.abs(js[:, :, None] - js[:, None, :])
    gap[:, np.arange(js.shape[1]), np.arange(js.shape[1])] = np.inf
    tied = fin & (np.nan_to_num(gap, nan=np.inf).min(axis=2) <= SCORE_TOL)
    np.testing.assert_array_equal(ti[~tied], ji[~tied])
    for row in np.unique(np.nonzero(tied)[0]):
        assert sorted(ti[row][tied[row]]) == sorted(ji[row][tied[row]])


def _clusters(seed=0, n=1200, dim=24, k=10, spread=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim))
    labels = rng.integers(0, k, n)
    emb = centers[labels] * 4.0 + rng.normal(size=(n, dim)) * spread
    return emb.astype(np.float32)


EMB = _clusters()
QUERIES = np.random.default_rng(5).normal(size=(40, 24)).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """A JAX-built index and the port's copy of its state."""
    j = J.SimpleIVF.build(EMB, n_cells=10, seed=1)
    return j, convert.ivf_from_numpy(convert.ivf_to_numpy(j), "cpu")


@pytest.mark.parametrize("n_cells, seed, iters", [(None, 42, 10),
                                                  (10, 3, 4), (25, 7, 6)])
def test_build_matches_jax(n_cells, seed, iters):
    """Auto cells (35), the clusters' count, and more cells than
    clusters (empty cells refilled from the same seeded draws)."""
    kw = dict(n_cells=n_cells, seed=seed, max_iterations=iters)
    j, t = J.SimpleIVF.build(EMB, **kw), P.SimpleIVF.build(EMB, **kw, **CPU)
    np.testing.assert_array_equal(t.assignments, j.assignments)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5, rtol=0)
    for name in ("sorted_doc_ids", "cell_offsets", "cell_populations"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for name in ("background_distances", "cell_residual_means",
                 "cell_residual_q90"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   atol=1e-6, rtol=0)
    assert (t.n_cells, t.default_nprobe, t.avg_population) == (
        j.n_cells, j.default_nprobe, j.avg_population)
    assert t.embeddings.dtype == np.float32 and t.device.type == "cpu"


def test_build_validation_and_device():
    for bad in (dict(embeddings=np.zeros((0, 4), np.float32)),
                dict(embeddings=EMB, max_iterations=0)):
        with pytest.raises(ValueError):
            P.SimpleIVF.build(**bad, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.SimpleIVF.build(EMB[:50])


@pytest.mark.parametrize("k, nprobe", [(10, None), (5, 1), (150, 1),
                                       (300, 2), (40, 10), (1200, 3)])
def test_search_batch_ids_bit_equal(carried, k, nprobe):
    """k = 150 and 300 exceed what one or two cells hold: the -inf
    entries come back in index order, as lax.top_k returns them."""
    j, t = carried
    ji, js = j.search_batch(QUERIES, k, nprobe=nprobe)
    ti, ts = t.search_batch(QUERIES, k, nprobe=nprobe)
    assert ti.dtype == np.int32 and ts.dtype == np.float64
    assert ti.shape == ji.shape == (len(QUERIES), k)
    _assert_ranked_equal(ti, ts, ji, js)
    if k >= 150 and nprobe == 1:
        assert np.isinf(js).any()


def test_search_batch_chunks_and_edges(carried, monkeypatch):
    j, t = carried
    ref = t.search_batch(QUERIES, 10)
    monkeypatch.setattr(P.SimpleIVF, "_SCORES_BUDGET_BYTES", 8 * 1280 * 4)
    assert t._chunk_rows() == 8
    got = t.search_batch(QUERIES, 10)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    ids, scores = t.search_batch(QUERIES, 0)
    assert ids.shape == scores.shape == (len(QUERIES), 0)
    with pytest.raises(ValueError, match="k must be"):
        t.search_batch(QUERIES, t.n_docs + 1)


@pytest.mark.parametrize("nprobe, k", [(None, 10), (1, 10), (2, 0),
                                       (1, 5000), (99, 25)])
def test_search_matches_jax(carried, nprobe, k):
    j, t = carried
    for q in QUERIES[:8]:
        a, b = j.search(q, k, nprobe=nprobe), t.search(q, k, nprobe=nprobe)
        _assert_ranked_equal(b.indices, b.scores, a.indices, a.scores)
        for name in ("candidate_indices", "candidate_cell_ids",
                     "candidate_cell_populations", "probed_cell_ids"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        for name in ("candidate_scores", "probed_cell_scores",
                     "centroid_scores"):
            np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                       atol=1e-6, rtol=0)


def test_score_documents(carried):
    j, t = carried
    ids = np.array([0, 7, 1199, 7])
    np.testing.assert_allclose(t.score_documents(QUERIES[0], ids),
                               j.score_documents(QUERIES[0], ids), atol=1e-6)
    assert t.score_documents(QUERIES[0], []).shape == (0,)


def test_convert_round_trip(carried):
    j, t = carried
    state = convert.ivf_to_numpy(t)
    again = convert.ivf_from_numpy(state, "cpu")
    for name, value in convert.ivf_to_numpy(j).items():
        np.testing.assert_array_equal(np.asarray(getattr(again, name)),
                                      np.asarray(value))
    vpt = convert.vpt_from_numpy(
        {"mu_G": 0.7, "sigma_G": 0.1, "base_rate": 0.02}, "cpu")
    assert convert.vpt_to_numpy(vpt) == {"mu_G": 0.7, "sigma_G": 0.1,
                                         "base_rate": 0.02}


@pytest.mark.parametrize("local_k, shell_k", [(10, 10), (3, 50), (1, 0)])
def test_exact_diagnostics(local_k, shell_k):
    s = np.sort(np.random.default_rng(6).uniform(-0.2, 0.95, 60))[::-1]
    for scores in (s, s[:5], []):
        a = JD.build_exact_search_diagnostics(scores, local_k=local_k,
                                              shell_k=shell_k)
        b = PD.build_exact_search_diagnostics(scores, local_k=local_k,
                                              shell_k=shell_k)
        _same_diagnostics(a, b)


def _same_diagnostics(a, b):
    np.testing.assert_allclose(b.accepted_distances, a.accepted_distances,
                               rtol=1e-12)
    np.testing.assert_allclose(b.contrast_distances, a.contrast_distances,
                               rtol=1e-12)
    for name in ("purity", "coverage", "cohesion", "separation",
                 "reliability"):
        assert getattr(b, name) == pytest.approx(getattr(a, name), rel=1e-12)
    for kw in ({}, dict(min_gate=0.1, max_gate=0.5)):
        assert PD.separability_gate(b, **kw) == pytest.approx(
            JD.separability_gate(a, **kw), rel=1e-12)


@pytest.mark.parametrize("nprobe, local_k", [(None, 10), (1, 10), (3, 4)])
def test_ivf_diagnostics(carried, nprobe, local_k):
    """Both packages' diagnostics on the same (JAX) search results;
    nprobe 1 puts every candidate in the primary cell, so the contrast
    falls back to the best other centroid and its residuals."""
    j, t = carried
    for q in QUERIES[:6]:
        r = j.search(q, 50, nprobe=nprobe)
        a = JD.build_ivf_search_diagnostics(r.scores, r.cell_ids, r, j,
                                            local_k=local_k)
        b = PD.build_ivf_search_diagnostics(r.scores, r.cell_ids, r, t,
                                            local_k=local_k)
        _same_diagnostics(a, b)
    empty = PD.build_ivf_search_diagnostics([], [], r, t)
    assert (empty.purity, PD.separability_gate(empty)) == (0.0, 0.02)


def test_search_diagnostics_dataclass():
    d = PD.SearchDiagnostics([0.1, 0.3], [], purity=1.7, coverage=-0.2)
    assert (d.purity, d.coverage, d.separation) == (1.0, 0.0, d.cohesion)
    assert d.accepted_distances.dtype == np.float64
