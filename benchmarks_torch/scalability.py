"""Scalability: wall time + memory of index/retrieve/probabilities over
synthetic Zipf corpora (reference: benchmarks/scalability.py), plus
per-chip throughput at each scale.

The port's copy of benchmarks/scalability.py. One line differs: the index
holds torch tensors, whose element count is ``numel()`` (an array's
``size``).

Usage: python benchmarks_torch/scalability.py [--large]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from bayesian_bm25_tpu import BayesianBM25Scorer  # noqa: E402
from benchmarks.common import print_table  # noqa: E402


def make_corpus(rng, n_docs, doc_len=120, vocab=30000):
    zipf = rng.zipf(1.3, size=(n_docs, doc_len)) % vocab
    return [[f"t{t}" for t in row] for row in zipf]


def run_scale(n_docs: int, n_queries: int = 1024) -> tuple:
    rng = np.random.default_rng(0)
    corpus = make_corpus(rng, n_docs)
    queries = [[f"t{t}" for t in rng.zipf(1.3, size=8) % 30000]
               for _ in range(n_queries)]

    t0 = time.perf_counter()
    scorer = BayesianBM25Scorer(base_rate="auto")
    scorer.index(corpus, show_progress=False)
    t_index = time.perf_counter() - t0

    idx = scorer.bm25_index
    index_mb = (idx.term_ids.numel() * 4 + idx.weights.numel() * 4) / 1e6

    scorer.retrieve(queries, k=10)  # warm compile
    t0 = time.perf_counter()
    scorer.retrieve(queries, k=10)
    t_retrieve = time.perf_counter() - t0

    scorer.get_probabilities_batch(queries[:32])
    t0 = time.perf_counter()
    scorer.get_probabilities_batch(queries[:32])
    t_dense = time.perf_counter() - t0

    return (
        n_docs, round(t_index, 2), round(index_mb, 1),
        round(t_retrieve * 1000, 1),
        round(n_queries / t_retrieve, 0),
        round(t_dense * 1000 / 32, 2),
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--large", action="store_true",
                    help="scale up to 1M documents")
    args = ap.parse_args()

    scales = [10_000, 50_000, 200_000]
    if args.large:
        scales.append(1_000_000)

    rows = [run_scale(n) for n in scales]
    print_table(
        "Scalability (1024-query retrieve batches, top-10 calibrated)",
        rows,
        ("docs", "index s", "index MB", "retrieve ms", "q/s",
         "dense ms/q"),
    )


if __name__ == "__main__":
    main()
