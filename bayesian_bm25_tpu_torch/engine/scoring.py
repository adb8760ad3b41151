"""Doc-major BM25 scoring and the dense probability pipelines.

Counterpart of ``bayesian_bm25_tpu/engine/scoring.py``. The scoring core
evaluates, for a query with unique term ids q and counts c,

    score[d] = sum_j c[j] * sum_t weights[d, t] * (term_ids[d, t] == q[j])
    tf[d]    = sum_j        sum_t                (term_ids[d, t] == q[j])

over the doc-major padded term table (engine/index.py) through K5
(``cuda_bm25.compare``), in ``score_all_xla``'s order, bit-equal to it.
Every ``lax.top_k`` of the JAX module is K3 (``cuda_topk.topk``) or
``split_index.exact_topk_blockwise`` (K1 + K3), which return the same
values and positions; ``torch.topk`` breaks ties in another order.

Probabilities are computed in an explicit ``prob_dtype`` and returned
as float32 (the JAX functions cast to the scores' float32 dtype).
``score_all``, ``score_all_xla`` and ``probabilities_all`` take numpy
arrays as JAX's take them, on the device of ``term_ids`` when it is a
tensor, else on the default one (``mathx.resolve_device()``: the card).
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import cuda_bm25
from bayesian_bm25_tpu_torch.engine.split_index import exact_topk_blockwise
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.ops.mathx import as_float, resolve_device


def _operands(term_ids, weights, qids, qcnt):
    """The compare's four operands. Tensors pass as the main path gives
    them, the query ids and counts cast to int32 / float32, so K5's
    wrapper still refuses a table of the wrong dtype or device.
    Array-likes become contiguous int32 / float32 tensors on the device
    of ``term_ids`` when it is a tensor, else on the default one."""
    dev = (term_ids.device if isinstance(term_ids, torch.Tensor)
           else resolve_device())

    def table(x, dt):
        return x if isinstance(x, torch.Tensor) else as_float(x, dt, dev)

    def query(x, dt):
        return as_float(x, dt, x.device if isinstance(x, torch.Tensor)
                        else dev).contiguous()

    return (table(term_ids, torch.int32), table(weights, torch.float32),
            query(qids, torch.int32), query(qcnt, torch.float32))


def score_all(term_ids, weights, qids, qcnt):
    """(nq, D) BM25 scores and unique-overlap tf counts for a query
    batch (K5)."""
    return cuda_bm25.compare(*_operands(term_ids, weights, qids, qcnt))


def score_all_xla(term_ids, weights, qids, qcnt, query_chunk: int = 16):
    """:func:`score_all` without a kernel: K5's plain version
    (``cuda_bm25.compare_plain``) on any device, bit-equal to K5 and to
    JAX's ``score_all_xla``. JAX's name and signature; the main path
    never calls it. ``query_chunk`` bounds JAX's (chunk, D, T) compare;
    the plain version bounds its blocks by element count instead."""
    del query_chunk
    return cuda_bm25.compare_plain(*_operands(term_ids, weights, qids, qcnt))


def _topk(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: K1 + K3 blockwise for wide
    rows, K3 alone otherwise. Positions are int64."""
    v, p = exact_topk_blockwise(x.contiguous(), k, block=256)
    return v, p.long()


def _probs(scores, tfs, doc_lengths, avgdl, alpha, beta, base_rate,
           prior_free, prob_dtype):
    """Dense transform of (nq, D) scores; 0 where score <= 0."""
    dlr = T.true_div(doc_lengths, float(avgdl))[None, :]
    probs = T.score_to_probability(scores, tfs, dlr, alpha, beta, base_rate,
                                   prior_free=prior_free, dtype=prob_dtype)
    return torch.where(scores > 0, probs.to(torch.float32), 0.0)


def probabilities_all(
    term_ids, weights, doc_lengths, avgdl, qids, qcnt,
    alpha, beta, base_rate=None, *, n_docs: int | None = None,
    prior_free: bool = False, prob_dtype: torch.dtype = torch.float32,
):
    """Dense calibrated probabilities for every document, with the scores
    and tf counts they came from: (probs, scores, tfs), each
    (nq, n_docs). ``n_docs`` slices off index pad rows."""
    scores, tfs = score_all(term_ids, weights, qids, qcnt)
    doc_lengths = as_float(doc_lengths, torch.float32, scores.device)
    if n_docs is not None:
        scores = scores[:, :n_docs]
        tfs = tfs[:, :n_docs]
        doc_lengths = doc_lengths[:n_docs]
    probs = _probs(scores, tfs, doc_lengths, avgdl, alpha, beta, base_rate,
                   prior_free, prob_dtype)
    return probs, scores, tfs


def thresholded_topk(probs: torch.Tensor, threshold: float, k: int):
    """(ids, probs, n_passing) of the k most probable docs with
    P >= threshold per query, from a dense probability matrix (the
    passing set is complete); ids -1 / probs 0 beyond it. Probability 0
    never passes, even at threshold 0."""
    passing = (probs >= threshold) & (probs > 0.0)
    n_passing = passing.sum(dim=1, dtype=torch.int32)
    if k == 0:
        # Only the passing counts: (nq, 0) results, no top-k launch.
        empty = probs.new_zeros((probs.shape[0], 0))
        return empty.to(torch.int32), empty, n_passing
    masked = torch.where(passing, probs, -1.0)
    top_p, pos = _topk(masked, k)
    keep = top_p >= threshold
    return (torch.where(keep, pos, -1).to(torch.int32),
            torch.where(keep, top_p, 0.0), n_passing)


def count_above(scores: torch.Tensor, s_min: float) -> torch.Tensor:
    """Per-query count of positive scores >= s_min (int32)."""
    return ((scores > 0) & (scores >= s_min)).sum(dim=1, dtype=torch.int32)


def thresholded_topk_from_scores(
    scores, tfs, doc_lengths, avgdl, threshold: float, k: int,
    alpha, beta, base_rate=None, *, prior_free: bool = False,
    prob_dtype: torch.dtype = torch.float32,
):
    """Dense thresholded retrieval from precomputed (scores, tfs):
    probabilities equal to ``probabilities_all`` + ``thresholded_topk``
    on the same inputs. Masked (-inf) scores give probability 0."""
    probs = _probs(scores, tfs, doc_lengths, avgdl, alpha, beta, base_rate,
                   prior_free, prob_dtype)
    return thresholded_topk(probs, threshold, k)


def thresholded_topk_pruned(
    scores, tfs, doc_lengths, avgdl, threshold: float, s_min,
    k: int, C: int, alpha, beta, base_rate=None, *,
    prior_free: bool = False, prob_dtype: torch.dtype = torch.float32,
):
    """WAND-pruned thresholded retrieval: exact probabilities for the top
    C positive scores at or above ``s_min`` only; output-identical to the
    dense path whenever C covers every query's ``count_above`` (the
    certified bound puts every passing doc above ``s_min``). Candidates
    are re-sorted by doc id, stably, so probability ties go to the lowest
    id as in the dense top-k. ``scores`` must already be doc-masked
    (-inf) and sliced to n_docs."""
    n_docs = scores.shape[1]
    screen = torch.where((scores > 0) & (scores >= s_min), scores,
                         float("-inf"))
    cand_s, cand_ids = _topk(screen, C)
    sort_key = torch.where(torch.isfinite(cand_s), cand_ids, n_docs)
    sid, order = torch.sort(sort_key, dim=1, stable=True)
    ss = torch.gather(cand_s, 1, order)
    valid = torch.isfinite(ss)
    gi = sid.clamp(max=n_docs - 1)
    safe_s = torch.where(valid, ss, 0.0)
    cand_tf = torch.gather(tfs, 1, gi)
    cand_dlr = T.true_div(doc_lengths[gi], float(avgdl))
    probs = T.score_to_probability(safe_s, cand_tf, cand_dlr, alpha, beta,
                                   base_rate, prior_free=prior_free,
                                   dtype=prob_dtype)
    probs = torch.where(valid & (safe_s > 0), probs.to(torch.float32), 0.0)
    pos, top_p, n_passing = thresholded_topk(probs, threshold, k)
    out_ids = torch.where(pos >= 0,
                          torch.gather(sid, 1, pos.long().clamp(min=0)), -1)
    return out_ids.to(torch.int32), top_p, n_passing


def retrieve_topk(
    term_ids, weights, doc_lengths, avgdl, qids, qcnt, k: int,
    alpha, beta, base_rate=None, *, n_docs: int | None = None,
    prior_free: bool = False, doc_mask=None,
    prob_dtype: torch.dtype = torch.float32,
):
    """Top-k by BM25 score with calibrated probabilities (nq, k): ranking
    by raw score, probabilities for the selected docs. ``doc_mask``
    (bool, per doc) excludes documents from selection; unfilled slots
    return id -1 / probability 0. Returns (ids int32, probs, scores,
    tfs)."""
    scores, tfs = score_all(term_ids, weights, qids, qcnt)
    D = scores.shape[1]
    n = D if n_docs is None else n_docs
    if doc_mask is not None:
        scores = torch.where(doc_mask[None, :n], scores[:, :n],
                             float("-inf"))
        top_scores, top_ids = _topk(scores, k)
    else:
        # Pad docs are masked inside K1 (valid_upto) instead of a slice.
        top_scores, top_ids = exact_topk_blockwise(
            scores, k, block=256, valid_upto=None if n == D else n)
    dead = ~torch.isfinite(top_scores)
    top_scores = torch.where(dead, 0.0, top_scores)
    top_ids = torch.where(dead, -1, top_ids)
    safe_ids = top_ids.clamp(min=0)
    top_tfs = torch.gather(tfs, 1, safe_ids)
    top_dlr = T.true_div(doc_lengths[safe_ids], float(avgdl))
    probs = T.score_to_probability(top_scores, top_tfs, top_dlr, alpha, beta,
                                   base_rate, prior_free=prior_free,
                                   dtype=prob_dtype)
    probs = torch.where(top_scores > 0, probs.to(torch.float32), 0.0)
    return top_ids.to(torch.int32), probs, top_scores, top_tfs
