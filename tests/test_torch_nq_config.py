"""PyTorch port: the BEIR NQ deployment (``perfbench/configs/nq.json``)
at a size the CPU holds.

At its published 2,681,468 passages the scorer's own rules cap the split
index at K 384 frequent terms (the 4 GiB split budget over int8 pairs),
cut the rare postings into a width-capped tier-1 rectangle and a tier-2
one, and chunk requests by 256 queries. The first test checks those rules
without building anything. The second builds a few thousand passages from
the configuration's own generators, with the budgets scaled so that K is
budget-capped and all four merge passes run (light tier-1, heavy tier-1,
tier-2 and its heavy half: the merge counters show it), and holds
``retrieve_stream`` to the benchmark's plain float64 reference, under the
cell's limits. The file imports neither jax nor the JAX package.
"""

import copy
import json
import sys

import numpy as np
import pytest

from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import index as eidx
from bayesian_bm25_tpu_torch.engine import split_index as sidx
from bayesian_bm25_tpu_torch.utils import spans

from torch_helpers import ROOT, one_thread  # noqa: F401

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check, gen  # noqa: E402
from perfbench.reference import Reference  # noqa: E402

NQ_DOCS = 2_681_468


def _config() -> dict:
    with open(ROOT / "perfbench" / "configs" / "nq.json") as f:
        return json.load(f)


def _limits() -> dict:
    with open(ROOT / "perfbench" / "limits" / "nq.bulk.json") as f:
        return json.load(f)


def test_the_scorers_rules_at_nq_scale():
    cfg = _config()
    assert cfg["corpus"]["docs"] == NQ_DOCS
    sc = BayesianBM25Scorer(**cfg["scorer"], device="cpu")
    D_pad = eidx._round_up(NQ_DOCS, sc._doc_pad_multiple())
    assert D_pad == 2_682_880
    assert sc._split_plan(D_pad, cfg["corpus"]["terms"]["mod"]) \
        == ("int8", 384)
    assert cfg["reference"]["base_rate"]["frequent_terms"] == 384
    # The chunk rule reads only the padded doc count.
    sc._index = eidx.BM25Index(
        k1=1.2, b=0.75, method="robertson", vocab={}, term_ids=None,
        weights=None, doc_lengths=None, doc_frequencies=None, idf=None,
        term_ids_host=np.empty((D_pad, 0), np.int32))
    assert sc._auto_batch_size() == 256


def _small_nq(docs=6000, n_queries=1200, seed=20):
    """The nq generators at ``docs`` passages: (corpus ids, query ids,
    the corpus and the queries as token lists)."""
    cfg = copy.deepcopy(_config())
    cfg["corpus"]["docs"] = docs
    r_corpus, r_queries, _ = gen.streams(seed)
    corpus = gen.corpus(cfg, r_corpus)
    queries = gen.queries(cfg, r_queries, n_queries)
    names = gen.token_names(int(max(corpus.ids.max(),
                                    queries.ids.max())) + 1)
    return (corpus, queries, gen.to_tokens(corpus, names),
            gen.to_tokens(queries, names))


def test_budget_capped_int8_index_runs_every_merge_pass_and_meets_the_reference(
        monkeypatch):
    corpus, queries, tokens, q_tokens = _small_nq()
    D_pad = eidx._round_up(len(corpus), 2048)
    # The NQ arithmetic at this size: int8 storage, a split budget of 400
    # columns of (int8 pair + bf16 presence), so K is capped at 384 ...
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_INT8_MIN_DOCS", 0)
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES",
                        400 * D_pad * 4)
    # ... a postings budget that caps the tier-1 width and moves the
    # commonest rare terms to the tier-2 rectangle, and light/heavy
    # splits whenever they narrow a pass at all.
    monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 600_000)
    for name in ("_LH_MIN_SAVE", "_LHB_MIN_SAVE"):
        monkeypatch.setattr(sidx, name, 0)
    for name in ("_LH_MIN_RATIO", "_LHB_MIN_RATIO"):
        monkeypatch.setattr(sidx, name, 1.0)
    cfg = _config()
    sc = BayesianBM25Scorer(**cfg["scorer"], device="cpu")
    sc.index(tokens)
    s = sc._split
    assert s.n_frequent == 384 and s.impact_scale is not None
    assert s.post_doc_ids is not None and s.post2_doc_ids is not None

    spans.reset()
    batches = [q_tokens[i:i + 600] for i in range(0, len(q_tokens), 600)]
    got = list(sc.retrieve_stream(batches, k=10, lookahead=4))
    for p in spans.MERGES:
        assert spans.counts[f"merge_rows.{p}"] > 0, p
        assert spans.counts[f"merge_candidates.{p}"] \
            >= 10 * spans.counts[f"merge_rows.{p}"], p
    ids = np.concatenate([g[0] for g in got])
    probs = np.concatenate([g[1] for g in got])

    ref = Reference(corpus)
    cal = ref.calibration(corpus, base_rate_auto=True,
                          stored=cfg["reference"]["base_rate"])
    qs = [queries.row(i) for i in range(len(queries))]
    numbers = check.compare(ref, cal, qs, list(ids), list(probs), 10)
    limits = _limits()
    assert check.verdict(numbers, limits), numbers
    # Where the reference's scores separate them, the ids are its exact
    # top-k, ties to the lowest id.
    S = ref.scores(qs).numpy()
    for r in range(len(qs)):
        order = np.lexsort((np.arange(S.shape[1]), -S[r]))[:10]
        live = S[r, order] > 0
        same = ids[r][live] == order[live]
        tied = np.isclose(S[r, ids[r][live]], S[r, order[live]],
                          rtol=limits["score_gap"], atol=0.0)
        assert (same | tied).all(), r
