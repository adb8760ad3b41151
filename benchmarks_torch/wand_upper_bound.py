"""WAND upper-bound quality: tightness (actual max / bound), skip rates at
thresholds, and safety on a real scored corpus
(reference: benchmarks/wand_upper_bound.py).

The port's copy of benchmarks/wand_upper_bound.py. Two lines differ: the
index holds torch tensors on its device, which numpy reads after a copy
to the host (``.cpu()``), where it reads a JAX array directly.

Usage: python benchmarks_torch/wand_upper_bound.py
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

from bayesian_bm25_tpu import (  # noqa: E402
    BayesianBM25Scorer,
    BayesianProbabilityTransform,
)
from bayesian_bm25_tpu.engine.tokenize import tokenize_texts  # noqa: E402
from benchmarks.common import print_table  # noqa: E402
from benchmarks.utils import synthetic_dataset  # noqa: E402


def main():
    rng = np.random.default_rng(0)

    # --- tightness on synthetic score populations --------------------------
    t = BayesianProbabilityTransform(alpha=0.8, beta=3.0, base_rate=0.05)
    rows = []
    for ub_score in (4.0, 8.0, 12.0, 20.0):
        bound = float(t.wand_upper_bound(ub_score))
        scores = rng.uniform(0, ub_score, 2000)
        tfs = rng.integers(0, 20, 2000).astype(float)
        ratios = rng.uniform(0.1, 2.5, 2000)
        actual = np.asarray(t.score_to_probability(scores, tfs, ratios))
        rows.append((ub_score, bound, float(actual.max()),
                     float(actual.max() / bound),
                     bool(np.all(actual <= bound + 1e-12))))
    print_table("Bound tightness (random doc populations)", rows,
                ("max score", "bound", "actual max", "ratio", "safe"))

    # --- skip rates on a scored corpus -------------------------------------
    ds = synthetic_dataset(n_docs=1500, n_queries=24)
    corpus_tokens = tokenize_texts([ds.corpus[d] for d in ds.doc_ids])
    query_tokens = tokenize_texts(list(ds.queries.values()))
    scorer = BayesianBM25Scorer(method="lucene", base_rate="auto")
    scorer.index(corpus_tokens, show_progress=False)
    tr = scorer.transform

    idx = scorer.bm25_index
    idf = idx.idf
    rows = []
    for threshold in (0.5, 0.7, 0.8, 0.9, 0.95):
        skipped = 0
        total = 0
        unsafe = 0
        for qt in query_tokens:
            terms = [idx.vocab[tok] for tok in qt if tok in idx.vocab]
            if not terms:
                continue
            # global per-query score upper bound: sum of per-term maxima
            w = np.asarray(idx.weights.cpu())
            tid = np.asarray(idx.term_ids.cpu())
            per_term_max = []
            for term in terms:
                m = w[tid == term]
                per_term_max.append(float(m.max()) if m.size else 0.0)
            ub = float(tr.wand_upper_bound(sum(per_term_max)))
            probs = scorer.get_probabilities(qt)
            total += 1
            if ub < threshold:
                skipped += 1
                if probs.max() >= threshold:
                    unsafe += 1
        rows.append((threshold, total, skipped,
                     round(skipped / max(total, 1), 3), unsafe))
    print_table("Query-level skip rates (global WAND bound)", rows,
                ("threshold", "queries", "skipped", "skip rate", "unsafe"))
    print(f"\nidf range: [{idf.min():.2f}, {idf.max():.2f}]; "
          f"alpha={tr.alpha:.3f} beta={tr.beta:.3f} "
          f"base_rate={tr.base_rate:.2e}")


if __name__ == "__main__":
    main()
