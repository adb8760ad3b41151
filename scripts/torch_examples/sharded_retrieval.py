"""Document-sharded retrieval on the PyTorch port: the counterpart of
examples/sharded_retrieval.py, with its steps and its prints.

    python3 scripts/torch_examples/sharded_retrieval.py [--device DEVICE]

The JAX example makes an 8-device virtual CPU mesh; here 8 shards share
one device, the card by default (``sharded.make_mesh(8, device=...)``).
One process launches each shard's kernels on its device, and the
all_gather and psum are ordered concatenations and sums on the first
shard's device.
"""

import argparse

import numpy as np

from bayesian_bm25_tpu_torch import ShardedBayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import index as eidx
from bayesian_bm25_tpu_torch.parallel import sharded

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="the device the 8 shards share (default: the card)")
device = ap.parse_args().device

n_dev = 8
mesh = sharded.make_mesh(n_dev, device=device)
print(f"devices: {n_dev} x {mesh.devices.flat[0].type}")

rng = np.random.default_rng(0)
corpus = [[f"t{t}" for t in rng.integers(0, 500, 40)] for _ in range(64)]
idx = eidx.build_index(corpus, doc_pad_multiple=n_dev, pad_multiple=8,
                       device=device)

tids, w, dl = sharded.shard_index_arrays(
    mesh, idx.term_ids, idx.weights, idx.doc_lengths)
print(f"term table {tuple(idx.term_ids.shape)} sharded over mesh "
      f"{mesh.shape}")

queries = [[f"t{t}" for t in rng.integers(0, 500, 5)] for _ in range(4)]
qids, qcnt = eidx.encode_queries(queries, idx.vocab)

ids, probs, scores = sharded.sharded_retrieve_topk(
    mesh, tids, w, dl, idx.avgdl, qids, qcnt, k=5,
    alpha=1.0, beta=2.0, base_rate=0.05,
)
ids, probs = ids.cpu().numpy(), probs.cpu().numpy()
print("\nper-shard top-k + all_gather merge results:")
for qi in range(len(queries)):
    print(f"  q{qi}: docs {ids[qi].tolist()} "
          f"probs {np.round(probs[qi], 3).tolist()}")

n, avgdl, df = sharded.corpus_stats_psum(mesh, dl, tids, idx.n_terms)
print(f"\npsum corpus stats: N={int(n)} avgdl={float(avgdl):.2f} "
      f"df checksum={int(df.sum())}")

# --- the user-facing form: ShardedBayesianBM25Scorer --------------------
scorer = ShardedBayesianBM25Scorer(mesh=mesh, base_rate="auto")
scorer.index(corpus, show_progress=False)
s_ids, s_probs = scorer.retrieve(queries, k=5)
print(f"\nShardedBayesianBM25Scorer (auto base_rate="
      f"{scorer.base_rate:.2e}):")
for qi in range(len(queries)):
    print(f"  q{qi}: docs {s_ids[qi].tolist()} "
          f"probs {np.round(s_probs[qi], 3).tolist()}")

scorer.add_documents([["t1", "t2", "freshly", "added"]])
print(f"\nafter incremental add_documents: {scorer.num_docs} docs, "
      f"retrieval still live:",
      scorer.retrieve([["freshly"]], k=1)[0].tolist())
