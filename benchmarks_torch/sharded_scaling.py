"""Sharded-retrieval scaling study on the PyTorch port: the counterpart of
``benchmarks/sharded_scaling.py`` (which makes a JAX virtual CPU mesh).

Measures the sharded sparse-candidate retrieve at 1/2/4/8 shards —
throughput RATIOS and per-shard memory, not absolute speed. Every shard
lives on the SAME device (``sharded.make_mesh(n, device=...)``; the card
by default), so compute cannot scale here; what the curve exposes is the
sharding layer's overhead (each shard's kernels launched in turn, the
candidates gathered and merged on the first shard's device, the query
encode done once) and the per-shard memory that governs a deployment
over n cards. The merge moves ``local_k x 16 bytes`` (score, id, tf, dl
as f32/i32) a query from each shard: k * n_shards * 16 B/query at the
exact default, independent of corpus size.

    python3 benchmarks_torch/sharded_scaling.py [--docs 20000]
        [--queries 512] [-k 10] [--device cuda] [-o out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bayesian_bm25_tpu_torch import (  # noqa: E402
    BayesianBM25Scorer,
    ShardedBayesianBM25Scorer,
)

# The split index's doc-axis tables, as benchmarks/sharded_scaling.py counts.
TABLES = ("dense_impact", "dense_impact_lo", "dense_presence",
          "tail_term_ids", "tail_weights")


def make_corpus(rng, n_docs, doc_len=60, vocab=8000):
    zipf = rng.zipf(1.3, size=(n_docs, doc_len)) % vocab
    return [[f"t{t}" for t in row] for row in zipf]


def make_queries(rng, n, vocab=8000):
    return [[f"t{t}" for t in rng.zipf(1.3, size=6) % vocab]
            for _ in range(n)]


def nbytes(x):
    """Bytes of a tensor, or of each tensor in a list (one per shard)."""
    if x is None:
        return 0
    if isinstance(x, (list, tuple)):
        return sum(nbytes(p) for p in x)
    return x.numel() * x.element_size()


def shard_memory(scorer):
    """Per-shard device bytes of the split index + postings."""
    n = getattr(scorer, "_n_shards", 1)
    if n == 1:
        s = scorer._split
        total = sum(nbytes(getattr(s, name)) for name in TABLES)
        post = nbytes(s.post_doc_ids) + nbytes(s.post_weights)
    else:
        total = sum(nbytes(scorer._sh[name]) for name in TABLES)
        post = (0 if scorer._post_sh is None else
                nbytes(scorer._post_sh[0]) + nbytes(scorer._post_sh[1]))
    return (total + post) / n


def bench(scorer, batches, k, reps=2):
    outs = scorer.retrieve_many(batches, k=k)  # build + warm
    t0 = time.time()
    for _ in range(reps):
        outs = scorer.retrieve_many(batches, k=k)
    dt = (time.time() - t0) / reps
    del outs
    return sum(len(b) for b in batches) / dt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("-k", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the one device every shard lives on")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    corpus = make_corpus(rng, args.docs)
    batches = [make_queries(rng, args.queries)]

    rows = []
    single = BayesianBM25Scorer(base_rate=0.01, device=args.device)
    single.index(corpus, show_progress=False)
    s = single._split
    print(f"all shards share one device ({args.device}); split merge: "
          + (f"yes, postings {tuple(s.post_doc_ids.shape)}"
             if s is not None and s.post_doc_ids is not None else "no"),
          flush=True)
    qps1 = bench(single, batches, args.k)
    rows.append({"devices": 1, "qps": qps1, "ratio": 1.0,
                 "shard_MB": shard_memory(single) / 2**20,
                 "merge_B_per_query": 0})
    print(f"single scorer     : {qps1:8.0f} q/s  "
          f"{rows[-1]['shard_MB']:7.1f} MB/shard", flush=True)

    for n in (2, 4, 8):
        sc = ShardedBayesianBM25Scorer(base_rate=0.01, n_devices=n,
                                       device=args.device)
        sc.index(corpus, show_progress=False)
        qps = bench(sc, batches, args.k)
        rows.append({
            "devices": n, "qps": qps, "ratio": qps / qps1,
            "shard_MB": shard_memory(sc) / 2**20,
            "merge_B_per_query": args.k * n * 16,
        })
        print(f"{n} shards, 1 device: {qps:8.0f} q/s  "
              f"ratio {qps/qps1:4.2f}  "
              f"{rows[-1]['shard_MB']:7.1f} MB/shard  "
              f"merge {args.k * n * 16} B/q", flush=True)

    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"written to {args.output}")


if __name__ == "__main__":
    main()
