#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure. The split path's frequent-term product
runs where each phase says; elsewhere it takes the card's default, K4
(split_index.FUSED_MM None), which the phases counting launches
require:
  1. device  -- require CUDA; print the card's name and power limit;
  2. build   -- compile the CUDA kernels from bayesian_bm25_tpu_torch/csrc
                (one nvcc per source, in parallel) and the native host
                library from native/bb25_native.cpp (g++; fatal if it
                fails); K5's first launch on a
                small table against its plain version, then a table with
                pads in mid-row and ids near INT32_MAX, and a table too
                wide for the shared-memory hash (the scan kernel, timed);
  3. index   -- bench.py's headline regime: 50,000-doc Zipf(1.3) corpus,
                BayesianBM25Scorer(base_rate=0.01, impact_storage="int8");
                calibration scores through the compare tail (K5);
  4. kernels -- K1-K3 against their plain PyTorch versions on the card,
                bit-exact, at the shapes the main path gives them (recorded
                from one retrieve of the first batch), with edge cases;
                both timed with CUDA events; K3 also at C < 32, C not a
                multiple of 32 and k on each side of the warp kernel's
                limit; K2 on edge cases (unsorted rows, ids -1, d_pad - 1
                and d_pad, rows out of range, cap 1, 31 and 33), then on
                the path's own operands, timed cold (L2 flushed before
                each launch, outside the timed interval), warm, and cold
                with every id a sentinel (the launch with nothing to
                gather), with its byte bound and its sector floor (one
                32-byte sector per distinct (row, id >> 3), counted on
                the card);
  5. slice   -- (phases 4-5 on the library route, FUSED_MM False)
                retrieve_many over 5 batches of 8,192 queries at k=10
                with every launch counter reset first and required > 0
                after; ids and probabilities checked; the first 32 queries
                compared with the same index state on the CPU, then the
                unfused product's other branches on 8 queries each:
                coarse=True and the dequantize fallback of a count above
                127; q/s as the median of 3 timed runs;
  6. dense   -- the same scorer: get_probabilities_batch on 2,048 queries
                and retrieve_thresholded on 8,192 at threshold 0.5; K5
                checked at the split index's tail table first;
  7. fused int8 -- K4 against its plain version: synthetic edge cases in
                all three storage modes (ragged nq, n_docs inside a block,
                fully masked blocks, all-zero query rows, signed values
                with negative totals, unions wider than one column slice),
                then the bench scorer's own operands (8,192 x 2,048 batch
                qvec, 51,200 x 2,048 int8 pair, read from the index's kept
                column-major copy), bit-exact, timed beside the plain
                version and the unfused route; then split_index.FUSED_MM
                on: retrieve_many over the
                5 batches, counted, checked against the CPU, and an A/B in
                turns (unfused, fused, fused, unfused; median of 3 each);
  8. tail    -- the rare postings refused (budget 0), the bench corpus
                indexed again: retrieve of 2,048 queries through the dense
                compare tail (retrieve_topk_split);
  9. doc-major -- a 50,000-doc corpus over a 200-term vocabulary (no split
                index): index, retrieve_many over 2 batches of 8,192,
                retrieve_thresholded, get_probabilities_batch; K5 checked at
                the (51200, 128) table first;
 10. ctor default -- BayesianBM25Scorer(base_rate=0.01) on the bench corpus
                (hilo storage): K4 in hilo mode and in single bf16 mode (on
                the hilo index's hi matrix) at the path's widths, within 1
                ulp of the plain version; the A/B of phase 7 in hilo;
 11. lifecycle -- the same scorer, fused: delete 1% of the ids (K4 idle,
                K2 busy, no deleted id returned, dense probabilities exactly
                0 there), restore (K4 again), add_documents of 2,048 docs
                against a CPU scorer grown the same way, and
                retrieve_stream(lookahead=4) equal to retrieve_many;
 12. split 1M -- the JAX package's 1M profile corpus (1,000,000 docs of
                120 Zipf(1.3) tokens mod 120,000): its corpus CSR built
                both ways (native, then the Python twin; equal arrays),
                then the corpus under
                BayesianBM25Scorer(base_rate=0.01): int8 storage, K 1,024,
                tier-2 postings, 1,024-query chunks. On the library route,
                one counted
                retrieve_many over 2 batches of 8,192 with the merge passes
                recorded: the group-A light/heavy split, a group-B (tier-2)
                pass and the group-B light/heavy split must each run in
                some chunk; K1-K3 bit-exact and timed on the operands of
                the chunk with the most passes (K2 cold and warm at every
                pass); then FUSED_MM on for one counted retrieve_many
                (K4 > 0, equal to the unfused run, 32 queries against the
                CPU), K4 bit-exact and timed on the richest chunk's
                (1,024 x 1,024) counts and the 1,001,472 x 1,024 int8
                pair, and retrieve_many unfused and fused in turns
                (unfused, fused, fused, unfused; median of 3 each); peak
                memory (K4's column-major copy included), index seconds
                (the corpus CSR built natively), and the host encode ms
                per 1,024-query chunk, native and its Python twin;
 13. text    -- a generated 50,000-document raw-text corpus (150 Zipf(1.3)
                words a document over ~30,000 generated words with
                English suffixes, stopwords and case variants) written as
                a BEIR corpus.jsonl: index_jsonl under the constructor's
                default (hilo, Porter) and under int8 with Porter2, each
                counted (K5 in calibration; native loader, corpus build,
                tokenizer and encoder), retrieve_texts on 8,192 query
                texts, counted, 32 queries against the CPU; then
                add_documents of 2,048 token lists, which must tokenize
                no document beyond the two calibration samples, and 32
                queries against the CPU;
 14. calibration -- the bench split int8 scorer rebuilt: transform.fit in
                the three modes on 250,000 (score, tf, length ratio)
                triples from get_scores_batch on the card with seeded
                logistic labels, on the card and on the CPU in turns
                (CPU, card, card, CPU; alpha and beta within rtol 1e-8,
                step counts equal or one apart), online updates in
                mini-batches and a temporal fit, each against the CPU;
                retrieval through the fitted prior-free
                transform, counted, against the CPU; then three
                configurations against the CPU on the same state: the
                unpacked candidate build (PACKED_BUILD off), the tf
                co-sorted by the merge (tf_from_sign off), and
                calibration through an overflow table;
 15. encoder A/B -- retrieve_many on that scorer, unfused and fused, with
                the host encoder in turns (Python twin, native, native,
                Python; median of 3 each) and the encode ms per batch;
 16. library -- on the same scorer: retrieve(explain=True) of one
                8,192-query batch, counted (ids and probabilities equal
                to retrieve's, a trace exactly where the score is
                positive, 256 queries' traces against the CPU within rtol
                1e-6), timed in turns with retrieve; the fusion algebra
                (log_odds_conjunction unweighted, weighted, each gate and
                max_logit, balanced_log_odds_fusion, prob_and, prob_or)
                on get_probabilities of 2,048 queries beside a seeded
                cosine matrix, (2,048, 50,000, 2) float64, each timed
                against its bytes bound, 64 rows against the CPU within
                1e-12, peak memory; the learnable, attention and 4-head
                weight models fitted on the batch's 81,920 top-10 rows
                on the card and the CPU in turns, mini-batch updates and
                prune, within rtol 1e-8 of the CPU; Platt and isotonic
                calibration and the metrics of the scorer's probabilities
                on phase 14's triples against the CPU (ECE within 1e-12);
                BlockMaxIndex.from_bm25_index with blocks of 128,
                bit-equal to np.maximum.at, and 256 queries' prune masks
                at 0.5 equal to the CPU's, with a count of the documents
                at or above 0.5 in pruned blocks.
 17. vectors -- 50,000 x 384 float32 embeddings (224 seeded clusters on
                the unit sphere plus noise): SimpleIVF.build (224 cells,
                nprobe 15) on the card and the CPU (assignment agreement,
                centroid gap); search_batch of 8,192 queries at k=10,
                counted (K1, K3), against the CPU on the card's state;
                search, build_ivf_search_diagnostics and
                separability_gate for 256 queries against the CPU; the
                hybrid harness's VPT protocol for 256 queries (sample:
                the dense top 1,000 from an exhaustive search_batch;
                eval set: its union with the BM25 top 1,000 of the bench
                scorer; auto with the blended guidance, kde with
                sharpened BM25 weights at bandwidth factors 0.2, 0.5, 1,
                2, gmm with ivf_density_prior weights, and
                balanced_log_odds_fusion) on the CPU and the card in
                turns within rtol 1e-9; then 1,000,000 x 384 (1,000
                cells, nprobe 32): build seconds, search_batch of 8,192
                in 1,024-query chunks, counted, q/s, peak memory, and 32
                queries against a CPU search on the same state;
 18. fields and checkpoints -- MultiFieldScorer(["title", "body"])
                .index_jsonl on phase 13's bodies with an 8-word title a
                document, counted; get_probabilities_batch of 2,048
                queries and retrieve of 256, counted, 64 against a CPU
                MultiFieldScorer on the same state; 1% of the documents
                deleted (probabilities exactly 0) and restored (equal to
                before); add_documents of 2,048, counted, against the
                CPU; save_scorer of the bench int8 scorer, load_scorer on
                the card (retrieve_many of 2 batches equal to the
                original's, counted) and on the CPU (equal to the CPU
                scorer on the same state); save_model / load_model of
                phase 16's weight models and calibrators and of the
                scorer's transform on the card and the CPU.
 19. sharded -- ShardedBayesianBM25Scorer with four shards on the card
                (parallel/sharded.py): the bench int8 configuration,
                retrieve_many over the 5 batches on the library route,
                counted (K1-K3), ids
                equal to the single scorer's outside ties (a differing
                slot must hold two docs of equal score) and probabilities
                within 1e-5; the same with FUSED_MM (K4 once per shard a
                batch); q/s in turns against the single scorer (single,
                sharded, sharded, single; median of 3 each), launches,
                device busy ms and wall ms a batch under the profiler,
                held device bytes and the retrieval peak of both; the
                dense API (K5 on the shard tails) against the single
                scorer; a (2, 2) mesh (the q x d split path) and the
                doc-major corpus over 4 shards against single scorers;
                phase 12's 1M corpus over 4 shards (index, a counted
                retrieve_many of its 2 batches with the merge passes
                recorded per shard: light/heavy and tier-2 must run,
                ids equal to phase 12's outside ties, q/s, peak memory);
                sharded_fit_transform (float32, balanced and prior-aware)
                on phase 14's triples against transform.fit on the card,
                and sharded_train_step_split on the card against the CPU.
 20. cost model -- parallel/cost_model.py beside the card's device ms by
                stage (torch.profiler, the ranges of ``staged``: matmul,
                leader selection, each merge pass, tf + transform; the
                median of 3 retrieves, each in its own profiler session,
                after a warm-up; up to 8 while the profiler credits a
                stage with no kernel time, and that stage's CUDA-event
                span where none does) of one 8,192-query batch on phase 3's
                bench int8 scorer (measured after phase 7, where it
                lives) and of phase 12's richest 1,024-query chunk
                (measured in phase 12), unfused and fused: measured ms,
                model ms and their ratio per stage and per merge pass;
                the model's 1/2/4/8-shard table at 1M (a model, not a
                measurement) and its cap shrink beside phase 19's
                per-shard postings widths. Fatal only on a missing stage
                or a non-finite number;
 21. examples -- scripts/run_examples_torch.py in its own process: the
                JAX package's 18 examples/*.py unchanged (imports of
                bayesian_bm25_tpu mapped to the port) and the port's
                sharded counterpart, on the card; each must exit 0 and
                print what the JAX package printed
                (tests/data/examples_jax/), wall times, q/s, temporary
                paths, the mesh repr and the device platform masked,
                integers equal and other numbers within one unit of
                their last printed digit; their kernel launches counted.
 22. benchmarks -- scripts/run_benchmarks_torch.py in its own process on
                the card: run_dataset (benchmarks_torch/hybrid_beir.py,
                the port's copy of the JAX package's harness) on the
                checked-in mini BEIR at k=5, R=50, every method's NDCG@5
                within 1e-6 of tests/data/mini_beir_frozen.json, and with
                the IVF and per-query separability gating; the one-seed
                gates of tests/test_benchmarks.py with their own
                assertions; the JAX package's benchmark scripts unchanged
                (imports mapped to the port) and hybrid_beir.py's
                defaults, each equal to the JAX package's recorded output
                (tests/data/benchmarks_jax/) under the runner's masks;
                benchmarks_torch/sharded_scaling.py (1/2/4/8 shards on
                the card). K3, K4 and K5 must launch, and K2 where
                sharded_scaling's corpus takes the split merge; seconds
                and launches per part;
 23. JAX suites -- scripts/run_jax_suites_torch.py --device cuda in its
                own process: the JAX package's own test files of both
                sets (43 files) unchanged against the port's defaults on
                the card; each file's counts and seconds logged; fatal if
                a case fails that tests/data/jax_suites_torch/
                differences.json does not list for the card, if a listed
                case does not fail, or if K3, K4 or K5 never launched;
                the runner has 180 s.
Phases 5-19 each reset the kernel and native-library counters before
each counted run and require their kernels > 0, native calls > 0 (none
for phase 17's vector searches, which encode no text) and no Python
fallback after, and compare 32 queries with the same state on the CPU
(ids equal outside ties, probabilities within 1e-5); the counts of
phases 21-23 come from the runners' own processes.

The second-to-last line of standard output is the kernels' JSON record,
the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

N_DOCS, K_TOP, N_BATCHES, BATCH = 50_000, 10, 5, 8192
CHECK_QUERIES = 32
PROB_TOL = 1e-5
DENSE_QUERIES = 2048          # get_probabilities_batch and the tail retrieve
THRESHOLD = 0.5
DM_VOCAB, DM_BATCHES = 200, 2  # the doc-major corpus
PLAIN_ROWS = 256              # query rows the plain K5 checks first
# Published H100 SXM peaks (NVIDIA data sheet, 700 W): device-memory
# bytes/s, float32 operations/s outside the tensor cores, and the tensor
# cores' dense int8 and bf16 rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
ADD_DOCS = 2048               # documents add_documents appends
# GPU clock cycles per millisecond for torch.cuda._sleep: at least the
# H100's 1.98 GHz boost clock, so a sleep lasts at least as long as asked.
SLEEP_CYCLES_PER_MS = 2.0e6
SHARDS = 4                    # phase 19: four shards on the one card
FIT_RTOL = 1e-4               # sharded float32 fit against transform.fit
# The 1M-document configuration (phase 12): the JAX package's 1M profile
# corpus (benchmarks/profiles/profile_1m_stages.py), 2 batches of 8,192.
N_1M, LEN_1M, VOCAB_1M, BATCHES_1M = 1_000_000, 120, 120_000, 2
L2_FLUSH_BYTES = 256 << 20    # read before each cold K2 launch
CAL_SAMPLES = 250_000         # judged triples the phase-14 fits take


def make_corpus(rng, n_docs=50_000, doc_len=150, vocab=30_000):
    zipf = rng.zipf(1.3, size=(n_docs, doc_len)) % vocab
    return [[f"t{t}" for t in row] for row in zipf]


def make_queries(rng, n=8192, qlen=8, vocab=30_000):
    return [[f"t{t}" for t in rng.zipf(1.3, size=qlen) % vocab] for _ in range(n)]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds per call, after one warm-up call. The
    stream is held busy (torch.cuda._sleep) while the calls are enqueued,
    so a kernel that takes less time than its wrapper's host overhead is
    timed on the device, not at the host's enqueue rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * (2 * reps * host_ms + 1)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, flush, reps: int = 20) -> float:
    """Mean device milliseconds per call with the L2 cache cold: a read
    of ``flush`` (five times the 50 MB L2) runs before each call, outside
    its timed interval. The stream is held as in cuda_ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.amax()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * (2 * reps * host_ms + 1)))
    for start, end in events:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def timed_once(fn):
    """(result, device milliseconds) of one call, no warm-up."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def in_turns(fn, order=("cpu", "cuda", "cuda", "cpu")):
    """fn(device) on each device of ``order`` in turn, timed on the host
    clock (fn ends in a host read): ({device: the last result},
    {device: [seconds, ...]})."""
    import torch

    out, secs = {}, {}
    for dev in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = fn(dev)
        torch.cuda.synchronize()
        secs.setdefault(dev, []).append(round(time.perf_counter() - t0, 4))
    return out, secs


def check_fit(what: str, fits: dict, names, rtol: float = 1e-8) -> None:
    """A model fitted on the card against the same fit on the CPU: each
    of ``names`` (floats or arrays) within ``rtol``, finite, and the
    step counts equal or one apart (the stop test may straddle the
    tolerance: the card sums in another order)."""
    from bayesian_bm25_tpu_torch.utils.convert import array_to_numpy

    g, c = fits["cuda"], fits["cpu"]
    for name in names:
        a, b = (np.asarray(array_to_numpy(getattr(m, name)), dtype=np.float64)
                for m in (g, c))
        if not (np.isfinite(a).all()
                and np.allclose(a, b, rtol=rtol, atol=0)):
            fail(f"{what}: {name} on the card {a} against the CPU's {b}")
    n_g = getattr(g, "_fit_iterations", 0)
    n_c = getattr(c, "_fit_iterations", 0)
    if abs(n_g - n_c) > 1:
        fail(f"{what}: {n_g} steps on the card against {n_c} on the CPU")


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> dict:
    """Least time for the work on the card: bytes over the memory rate or
    operations over the rate of their type (float32 by default),
    whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a, b) -> float:
    """Largest |a - b|, where equal entries (infinities included) count 0."""
    import torch

    same = a == b
    if bool(same.all()):
        return 0.0
    return float(torch.where(same, 0.0, (a.double() - b.double()).abs()).max())


def reset_counts() -> None:
    """Zero the kernel wrappers' launch counts and the native library's
    call and fallback counts."""
    from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                                cuda_matmul, cuda_reduce,
                                                cuda_topk, native)

    for mod in (cuda_reduce, cuda_gather, cuda_topk, cuda_bm25, cuda_matmul):
        mod.launches = 0
    native.reset_counts()


def read_counts() -> dict:
    """Kernel launches by kernel name, and under "native" and
    "fallbacks" the native library's nonzero call and fallback counts."""
    from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                                cuda_matmul, cuda_reduce,
                                                cuda_topk, native)

    return {"block_max": cuda_reduce.launches,
            "row_gather": cuda_gather.launches, "topk": cuda_topk.launches,
            "bm25_compare": cuda_bm25.launches,
            "impact_matmul_bmax": cuda_matmul.launches,
            "native": {k: v for k, v in native.calls.items() if v},
            "fallbacks": {k: v for k, v in native.fallbacks.items() if v}}


def record_shapes(scorer, batch, k):
    """Shapes of every kernel call one retrieve of ``batch`` makes; under
    "topk_inputs" a copy of K3's input at each (shape, k), under
    "block_max_inputs" K1's first input, and under "row_gather_inputs"
    K2's operands (scores, sid, trows) at every call."""
    from bayesian_bm25_tpu_torch.engine import cuda_gather, cuda_reduce, cuda_topk

    shapes = {"block_max": [], "row_gather": [], "topk": [], "topk_inputs": {},
              "block_max_inputs": None, "row_gather_inputs": []}
    orig = (cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk)

    def bm(scores, block, valid_upto=None):
        shapes["block_max"].append((tuple(scores.shape), block, valid_upto))
        if shapes["block_max_inputs"] is None:
            shapes["block_max_inputs"] = (scores, block, valid_upto)
        return orig[0](scores, block, valid_upto)

    def rg(scores, sid, trows):
        shapes["row_gather"].append((tuple(scores.shape), tuple(sid.shape)))
        shapes["row_gather_inputs"].append((scores, sid, trows))
        return orig[1](scores, sid, trows)

    def tk(x, kk):
        shapes["topk"].append((tuple(x.shape), kk))
        shapes["topk_inputs"].setdefault((tuple(x.shape), kk), x.clone())
        return orig[2](x, kk)

    cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk = bm, rg, tk
    try:
        scorer.retrieve(batch, k=k)
    finally:
        cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk = orig
    return shapes


def json_shapes(shapes) -> str:
    return json.dumps({k: v for k, v in shapes.items()
                       if not k.endswith("_inputs")})


def record_compares(fn) -> list:
    """The operands of every K5 call ``fn()`` makes, largest first:
    [(table_ids, table_w, qids, qcnt), ...]."""
    from bayesian_bm25_tpu_torch.engine import cuda_bm25

    calls = []
    orig = cuda_bm25.compare

    def rec(table_ids, table_w, qids, qcnt):
        calls.append((table_ids, table_w, qids, qcnt))
        return orig(table_ids, table_w, qids, qcnt)

    cuda_bm25.compare = rec
    try:
        fn()
    finally:
        cuda_bm25.compare = orig
    return sorted(calls, key=lambda c: -c[0].shape[0] * c[2].shape[0]
                  * c[0].shape[1])


def gather_work(scores, sid, trows) -> tuple[int, int]:
    """(distinct 32-byte sectors, gathered floats) of one K2 call: a
    sector for each distinct (row, id >> 3) with the id and row in range,
    counted from the operands on the card."""
    import torch

    nq, d_pad = scores.shape
    rows = trows.long()[:, None]
    ok = (sid >= 0) & (sid < d_pad) & (rows >= 0) & (rows < nq)
    keys = ((rows * d_pad + sid.long()) >> 3)[ok]
    return int(torch.unique(keys).numel()), int(ok.sum())


def k2_edges(score_shape, sid_shape, gen) -> None:
    """K2 bit-exact against its plain version on synthetic operands: a
    -inf row read by several sid rows, unsorted and sorted rows, ids -1,
    d_pad - 1 and d_pad, an all-sentinel row, rows outside [0, nq)."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_gather

    (nq, d_pad), (nt, cap) = score_shape, sid_shape
    scores = torch.rand((nq, d_pad), generator=gen, device="cuda") * 30.0
    scores[3] = float("-inf")
    sid = torch.randint(-1, d_pad + 1, (nt, cap), generator=gen,
                        device="cuda", dtype=torch.int32)
    sid[nt // 2:] = torch.sort(sid[nt // 2:], dim=1).values
    sid[1] = d_pad                                   # all sentinels
    sid[2, :3] = torch.tensor([d_pad - 1, -1, d_pad])[:cap].to(sid)
    trows = torch.randint(0, nq, (nt,), generator=gen, device="cuda",
                          dtype=torch.int32)
    trows[: nt // 8 + 1] = 3                         # repeated -inf row
    trows[4] = nq                                    # rows out of range
    trows[5] = -1
    got = cuda_gather.row_gather(scores, sid, trows)
    want = cuda_gather.row_gather_plain(scores, sid, trows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K2 row_gather differs from its plain version on edge cases "
             f"at {(nq, d_pad)} x {(nt, cap)}")
    log(f"K2 row_gather edge cases {(nq, d_pad)} x {(nt, cap)} "
        f"(unsorted rows, ids -1 / d_pad - 1 / d_pad, sentinel row, -inf "
        f"rows, rows outside [0, nq)): bit-exact")


def check_k2(ops, label, card, flush) -> dict:
    """K2 on one call's operands from the path: bit-exact against its
    plain version, timed cold (L2 flushed before each launch) and warm
    (back-to-back launches), and cold with every id a sentinel (nothing
    gathered), with the byte bound and the sector floor."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_gather

    scores, sid, trows = ops
    got = cuda_gather.row_gather(scores, sid, trows)
    want = cuda_gather.row_gather_plain(scores, sid, trows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"K2 row_gather differs from its plain version ({label})")
    err = max_abs_err(got, want)

    def gather():
        return cuda_gather.row_gather(scores, sid, trows)

    rec = dict(shape=[list(scores.shape), list(sid.shape)], label=label,
               cold_ms=cuda_ms_cold(gather, flush), warm_ms=cuda_ms(gather))
    rec["plain_ms"] = cuda_ms(lambda: cuda_gather.row_gather_plain(
        scores, sid, trows))
    # The same launch with nothing to gather (every id a sentinel): sid
    # read, out written, the launch and its latency.
    blank = torch.full_like(sid, scores.shape[1])
    rec["no_gather_cold_ms"] = cuda_ms_cold(
        lambda: cuda_gather.row_gather(scores, blank, trows), flush)
    sectors, n_valid = gather_work(scores, sid, trows)
    nt, cap = sid.shape
    io = nt * cap * 8 + nt * 4                      # sid and trows, out
    # The guide's bound: each byte read once (sid, trows, the gathered
    # floats) or written once (out). The sector floor: a 32-byte sector
    # per distinct (row, id >> 3), plus sid, trows and out.
    b = bound(io + n_valid * 4, 0)
    floor = bound(io + sectors * 32, 0)
    rec.update(sectors=sectors, gathered=n_valid, bound_ms=b["bound_ms"],
               sector_bound_ms=floor["bound_ms"], err=err)
    log(f"K2 row_gather {label} scores {tuple(scores.shape)} sid "
        f"{(nt, cap)}: bit-exact; cold {rec['cold_ms']:.4f} ms, warm "
        f"{rec['warm_ms']:.4f} ms; with no id to gather, cold "
        f"{rec['no_gather_cold_ms']:.4f} ms; plain {rec['plain_ms']:.4f} ms; "
        f"bound {b['bound_ms']:.4f} ms ({n_valid} floats gathered), sector "
        f"floor {floor['bound_ms']:.4f} ms ({sectors} sectors) [{card}]")
    return rec


def check_block_max(x, block, valid_uptos, label, card) -> dict:
    """K1 bit-exact against its plain version on ``x`` at each of
    ``valid_uptos``, timed at the first beside the plain version and
    ``amax`` over the reshaped view (a yardstick without the mask)."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_reduce

    errs = []
    for vu in valid_uptos:
        got = cuda_reduce.block_max(x, block, vu)
        want = cuda_reduce.block_max_plain(x, block, vu)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 block_max differs from its plain version ({label}, "
                 f"valid_upto={vu})")
        errs.append(max_abs_err(got, want))
        del got, want
    vu = valid_uptos[0]
    nq, d = x.shape
    rec = dict(shape=[nq, d], err=max(errs),
               ms=cuda_ms(lambda: cuda_reduce.block_max(x, block, vu)),
               plain_ms=cuda_ms(lambda: cuda_reduce.block_max_plain(
                   x, block, vu)),
               library_ms=cuda_ms(
                   lambda: x.view(nq, d // block, block).amax(dim=2)),
               **bound(nq * d * 4 + nq * (d // block) * 4, nq * d))
    log(f"K1 block_max {label} {(nq, d)} block {block} valid_upto {vu}: "
        f"bit-exact; {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms, "
        f"amax {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"[{card}]")
    return rec


def check_topk(x, kk, label, card) -> dict:
    """K3 bit-exact (values and indices) against its plain version on
    ``x``, timed beside the plain version and torch.topk (a yardstick
    only: it breaks ties in another order)."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_topk

    rows, c = x.shape
    got = cuda_topk.topk(x, kk)
    want = cuda_topk.topk_plain(x, kk)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"K3 topk differs from its plain version at {(rows, c)} "
             f"k={kk} ({label})")
    rec = dict(shape=[rows, c], k=kk, err=max_abs_err(got[0], want[0]),
               ms=cuda_ms(lambda: cuda_topk.topk(x, kk)),
               plain_ms=cuda_ms(lambda: cuda_topk.topk_plain(x, kk)),
               library_ms=cuda_ms(lambda: torch.topk(x, kk, dim=1)),
               **bound(rows * c * 4 + rows * kk * 8, rows * c))
    log(f"K3 topk {label} {(rows, c)} k={kk}: bit-exact; {rec['ms']:.4f} ms "
        f"vs plain {rec['plain_ms']:.4f} ms, torch.topk "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms [{card}]")
    return rec


def tie_heavy(gen, rows, c):
    """A top-k input in {0, ..., 4} with a -inf row, a row with fewer
    than 3 finite entries and a row that is one big tie."""
    import torch

    y = torch.randint(0, 5, (rows, c), generator=gen, device="cuda").float()
    y[0] = float("-inf")
    y[1, 3:] = float("-inf")
    y[2] = 1.0
    return y


def check_kernels(shapes, gen, card, flush):
    """Each kernel vs its plain version at the recorded shapes, with
    -inf rows, a block cut by valid_upto, sentinel ids, repeated rows,
    heavy ties and rows with fewer than k finite entries. Returns the K1
    and K3 entries, and K2's record at the path's operands."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_topk

    # K1: the leader-selection block maxima.
    (nq, d), block, valid_upto = shapes["block_max"][0]
    x = torch.rand((nq, d), generator=gen, device="cuda") * 30.0
    x[1] = float("-inf")
    x[2, : d // 2] = float("-inf")
    k1 = check_block_max(x, block, (valid_upto, d, valid_upto - 1),
                         "50k path shape", card)
    del x
    out = [dict(name="block_max", route="cuda",
                source="bayesian_bm25_tpu_torch/csrc/block_max.cu",
                replaces="bayesian_bm25_tpu/engine/pallas_reduce.py:69",
                max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
                bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
                library_ms=k1["library_ms"])]

    # K2: the merge's base-score gather. Edge cases on synthetic operands
    # at the path's widest shape, then the path's own operands, timed.
    (nq, d_pad), (nt, cap) = max(shapes["row_gather"],
                                 key=lambda s: s[1][0] * s[1][1])
    k2_edges((nq, d_pad), (nt, cap), gen)
    for c in (1, 31, 33):
        k2_edges((64, 2048), (40, c), gen)
    ops = max(shapes["row_gather_inputs"], key=lambda o: o[1].numel())
    k2 = [check_k2(ops, "50k path", card, flush)]

    # K3: every top-k shape of the path (block selection, leader top-k,
    # merge candidates), on the path's own input and on a tie-heavy one
    # (the warp kernel's insertions depend on the data: a fifth of each
    # tie-heavy row ties at the top).
    errs, times, n_bytes, n_ops = [], [], 0, 0
    for (rows, c), kk in sorted(set(shapes["topk"])):
        p = check_topk(shapes["topk_inputs"][((rows, c), kk)], kk,
                       "the path's input", card)
        t = check_topk(tie_heavy(gen, rows, c), kk, "tie-heavy input", card)
        errs += [p["err"], t["err"]]
        times.append((p["ms"], p["plain_ms"], p["library_ms"], t["ms"]))
        n_bytes += rows * c * 4 + rows * kk * 8
        n_ops += rows * c
    b = bound(n_bytes, n_ops)
    # Beyond the path's shapes: C below 32, C not a multiple of 32, and k
    # on each side of the warp kernel's limit.
    lim = cuda_topk.WARP_K_MAX
    extra = []
    for (rows, c), kk in (((8192, 7), 5), ((8192, 33), 10),
                          ((8192, 2560), lim), ((8192, 2560), lim + 1)):
        route = "warp" if kk <= lim else "rounds"
        e = check_topk(tie_heavy(gen, rows, c), kk, f"{route} kernel", card)
        errs.append(e.pop("err"))
        extra.append(dict(e, kernel=route))
    log(f"K3 topk main-path shapes: {sum(t[0] for t in times):.4f} ms in "
        f"all on the path's inputs ({sum(t[3] for t in times):.4f} ms "
        f"tie-heavy), bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"[{card}]")
    out.append(dict(name="topk", route="cuda",
                    source="bayesian_bm25_tpu_torch/csrc/topk.cu",
                    replaces="bayesian_bm25_tpu/engine/pallas_topk.py:54",
                    max_abs_err=max(errs), ms=sum(t[0] for t in times),
                    plain_ms=sum(t[1] for t in times), **b,
                    library_ms=sum(t[2] for t in times),
                    ties_ms=sum(t[3] for t in times), extra=extra))
    return out, k2


def check_compare_first_launch() -> None:
    """K5's first launch: a small table against the plain version."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_bm25

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    # Table rows hold unique ids (the function's contract), then pads.
    ids = torch.argsort(torch.rand((700, 60), generator=g, device="cuda"),
                        dim=1)[:, :24].to(torch.int32)
    ids[:, 12:] = -1
    w = torch.rand((700, 24), generator=g, device="cuda")
    qids = torch.randint(0, 70, (70, 40), generator=g, device="cuda",
                         dtype=torch.int32)
    qcnt = torch.full((70, 40), 3.0, device="cuda")
    got = cuda_bm25.compare(ids, w, qids, qcnt)
    want = cuda_bm25.compare_plain(ids, w, qids, qcnt)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("K5 bm25_compare differs from its plain version on a small "
             f"table ({int((got[0] != want[0]).sum())} scores, "
             f"{int((got[1] != want[1]).sum())} tf counts)")
    log("K5 bm25_compare first launch (700, 24) x (70, 40): bit-exact")


def with_edge_queries(qids, qcnt, n_terms):
    """A copy of (qids, qcnt) whose first rows hold the edge cases: an
    all-pad query, ids that hit no row, counts 3, 5 and 7, a -1 slot
    (it matches the rows' pads) and one id in two slots."""
    import torch

    qids, qcnt = qids.clone(), qcnt.clone()
    Q = qids.shape[1]
    hit = qids[qids >= 0][0]
    qids[0] = -2                                     # QUERY_PAD
    qcnt[0] = 0.0
    qids[1] = n_terms + torch.arange(Q, device=qids.device, dtype=torch.int32)
    qcnt[1] = 1.0
    for r, c in ((2, 3.0), (3, 5.0), (4, 7.0), (5, 3.0)):
        qcnt[r] = torch.where(qids[r] >= 0, c, 0.0)
    qids[6, 0], qcnt[6, 0] = -1, 3.0                 # DOC_PAD slot
    qids[7, 0] = qids[7, -1] = hit                   # one id, two slots
    qcnt[7, 0], qcnt[7, -1] = 3.0, 5.0
    return qids, qcnt


def compare_work(ids, qids):
    """(bytes, lookups, compares) of one K5 call. Bytes: the table, the
    query arrays and both outputs once. Lookups: one per real query slot
    and table row, what the function needs. Compares: each real query id
    against each real table id, the work of an all-pairs scan (logged
    only)."""
    (R, T), (nq, Q) = ids.shape, qids.shape
    n_bytes = R * T * 8 + nq * Q * 8 + 2 * nq * R * 4
    n_real = int((qids >= 0).sum())
    return n_bytes, n_real * R, n_real * int((ids >= 0).sum())


def check_compare_edges(card) -> dict:
    """K5 against its plain version on a table with pads in mid-row, all-pad
    rows and ids near INT32_MAX, then on a table too wide for the
    shared-memory hash (the scan kernel), timed. Returns the wide table's
    timing."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_bm25

    g = torch.Generator(device="cuda")
    g.manual_seed(2)

    def table(R, T, span):
        ids = torch.argsort(torch.rand((R, span), generator=g, device="cuda"),
                            dim=1)[:, :T].to(torch.int32)
        ids[::3] += 2**31 - 1 - span                 # near INT32_MAX
        pad = torch.rand((R, T), generator=g, device="cuda") < 0.3
        pad[::13] = True
        ids = torch.where(pad, -1, ids)
        w = torch.where(pad, 0.0, torch.rand((R, T), generator=g,
                                             device="cuda") * 4)
        return ids, w

    def queries(nq, Q, span):
        qids = torch.randint(0, span, (nq, Q), generator=g, device="cuda",
                             dtype=torch.int32)
        qids[::2] += 2**31 - 1 - span
        qids[::9, Q // 2:] = -2
        qcnt = torch.tensor([1.0, 3.0, 5.0, 7.0], device="cuda")[
            torch.randint(0, 4, (nq, Q), generator=g, device="cuda")]
        return with_edge_queries(qids, torch.where(qids < 0, 0.0, qcnt),
                                 span)

    ids, w = table(8192, 128, 400)
    if not bool(((ids[:, :-1] == -1) & (ids[:, 1:] >= 0)).any()):
        fail("K5 edge table has no pad in mid-row")
    qids, qcnt = queries(2048, 8, 400)
    got = cuda_bm25.compare(ids, w, qids, qcnt)
    want = cuda_bm25.compare_plain(ids, w, qids, qcnt)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("K5 bm25_compare differs from its plain version on the table "
             "with mid-row pads and ids near INT32_MAX")
    log("K5 bm25_compare (8192, 128) mid-row pads, ids near INT32_MAX x "
        "(2048, 8) with edge queries: bit-exact")

    T = 4 * cuda_bm25.HASH_MAX_T
    ids, w = table(8192, T, 2 * T)
    qids, qcnt = queries(1024, 8, 2 * T)
    got = cuda_bm25.compare(ids, w, qids, qcnt)
    want = cuda_bm25.compare_plain(ids, w, qids, qcnt)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"K5 bm25_compare (scan kernel, T={T}) differs from its plain "
             "version")
    ms = cuda_ms(lambda: cuda_bm25.compare(ids, w, qids, qcnt), reps=5)
    n_bytes, n_ops, n_cmp = compare_work(ids, qids)
    b = bound(n_bytes, n_ops)
    log(f"K5 bm25_compare wide table (8192, {T}) x (1024, 8), scan kernel: "
        f"bit-exact; {ms:.4f} ms, bound {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} ({n_cmp:.3e} all-pairs compares) [{card}]")
    return dict(shape=[[8192, T], [1024, 8]], kernel="scan", ms=ms, **b)


def check_compare(label, operands, n_terms, card) -> dict:
    """K5 against its plain version at one recorded main-path call:
    bit-exact on the first PLAIN_ROWS query rows, then on every row with
    one timed plain call; the kernel timed with CUDA events."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_bm25

    ids, w, qids, qcnt = operands
    qids, qcnt = with_edge_queries(qids, qcnt, n_terms)
    (R, T), (nq, Q) = ids.shape, qids.shape
    head = (ids, w, qids[:PLAIN_ROWS].contiguous(),
            qcnt[:PLAIN_ROWS].contiguous())
    got = cuda_bm25.compare(*head)
    want = cuda_bm25.compare_plain(*head)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"K5 bm25_compare differs from its plain version ({label}, "
             f"first {PLAIN_ROWS} rows)")
    ms = cuda_ms(lambda: cuda_bm25.compare(ids, w, qids, qcnt))
    got = cuda_bm25.compare(ids, w, qids, qcnt)
    want, plain_ms = timed_once(lambda: cuda_bm25.compare_plain(ids, w, qids, qcnt))
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    if err != 0.0 or not torch.equal(got[0], want[0]):
        fail(f"K5 bm25_compare differs from its plain version ({label}): "
             f"max |diff| {err}")
    if not bool((got[1][2:8] > 0).any()) or bool(got[1][:2].any()):
        fail(f"K5 edge rows unexpected ({label})")
    n_bytes, n_ops, n_cmp = compare_work(ids, qids)
    b = bound(n_bytes, n_ops)
    del got, want
    torch.cuda.empty_cache()
    log(f"K5 bm25_compare {label} table {(R, T)} queries {(nq, Q)}: "
        f"bit-exact; {ms:.4f} ms vs plain {plain_ms:.4f} ms (one call), "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"({n_bytes / 1e9:.3f} GB, {n_ops:.3e} lookups; {n_cmp:.3e} "
        f"all-pairs compares) [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, n_bytes=n_bytes, n_ops=n_ops,
                err=err, shape=[[R, T], [nq, Q]])


def check_int8_epilogue(scorer, batch) -> None:
    """The int8 score epilogue must be the fused multiply-add the JAX
    package computes: compare with an exact float64 evaluation."""
    import torch

    from bayesian_bm25_tpu_torch.engine import split_index as sidx
    from bayesian_bm25_tpu_torch.engine.index import to_device

    s = scorer._split
    fslots, fcnt = sidx.encode_queries_split(batch, s)[:2]
    qvec, _ = sidx._densify_queries(to_device(fslots, "cuda"),
                                    to_device(fcnt, "cuda"), s.n_frequent)
    got = sidx._impact_matmul(qvec, s.dense_impact, s.dense_impact_lo,
                              scale=s.impact_scale)
    qi = qvec.to(torch.int8)
    hi = sidx._int8_dot(qi, s.dense_impact).double()
    lo = sidx._int8_dot(qi, s.dense_impact_lo).float() * s.impact_scale[1]
    want = (hi * s.impact_scale[0].double() + lo.double()).float()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("int8 epilogue is not a fused multiply-add on this card "
             f"({int((got != want).sum())} entries differ)")
    log(f"int8 epilogue {tuple(got.shape)}: fused multiply-add, bit-exact")


def check_matmul_branches(scorer, cpu, qs) -> None:
    """The unfused product's other two branches on the card against the
    same state on the CPU: ``coarse=True`` (the hi pass only; int8
    products, bit-exact) and the dequantize fallback that a count above
    127 takes (one float32 product, which sums its few nonzero terms in
    the library's order on each device: ties within 4 ulps)."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    compare_retrieve(scorer, cpu, qs[:8], "coarse retrieve", coarse=True)
    heavy = [["t1"] * 130 + q for q in qs[:8]]
    fcnt = sidx.encode_queries_split(heavy, scorer._split)[1]
    if sidx._q_int8_ok(scorer._split, fcnt):
        fail("a count of 130 did not leave the int8 product")
    compare_retrieve(scorer, cpu, heavy, "retrieve with a count of 130 "
                     "(dequantized product)", tie_ulps=4)


def require_launched(counts: dict, names, path: str,
                     native_kinds=()) -> None:
    """Fail unless each kernel in ``names`` launched, the native library
    was called (each kind in ``native_kinds`` at least once; some call in
    any case: every path encodes ASCII tokens) and no Python fallback
    ran in its place."""
    log(f"{path} launches: {counts}")
    for name in names:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by {path}")
    require_native(counts, path, native_kinds)


def require_native(counts: dict, path: str, kinds=()) -> None:
    if not counts["native"] or any(k not in counts["native"] for k in kinds):
        fail(f"{path}: the native library was not called "
             f"({counts['native']}, needed {list(kinds) or 'any'})")
    if counts["fallbacks"]:
        fail(f"{path}: Python fallbacks ran in place of the native "
             f"library: {counts['fallbacks']}")


def compare_retrieve(gpu, cpu, qs, what: str, tie_ulps: int = 0,
                     coarse: bool = False) -> None:
    """retrieve on the card against the same state on the CPU: ids equal
    outside ties (scores within ``tie_ulps`` ulps; exact by default),
    probabilities within PROB_TOL."""
    import torch

    _, g_ids, g_probs, g_scores, _ = gpu._retrieve_launch(
        qs, K_TOP, False, None, coarse=coarse)
    _, c_ids, c_probs, c_scores, _ = cpu._retrieve_launch(
        qs, K_TOP, False, None, coarse=coarse)
    g_ids, g_probs, g_scores = (a.cpu() for a in (g_ids, g_probs, g_scores))
    differ = g_ids != c_ids
    ulp = torch.nextafter(c_scores.abs(), torch.tensor(float("inf"))) - c_scores.abs()
    if bool((differ & ((g_scores - c_scores).abs() > tie_ulps * ulp)).any()):
        fail(f"{what}: card and CPU disagree on ids outside ties")
    p_err = float((g_probs - c_probs).abs().max())
    s_err = float((g_scores - c_scores).abs().max())
    if p_err > PROB_TOL:
        fail(f"{what}: card and CPU probabilities differ by {p_err} > {PROB_TOL}")
    log(f"{what}: card vs CPU on {len(qs)} queries: ids equal "
        f"({int(differ.sum())} tie swaps), max |dscore| {s_err}, "
        f"max |dprob| {p_err}")
    return g_ids.numpy()


def compare_dense(gpu, cpu, qs, g_thr, what: str) -> None:
    """get_probabilities_batch and retrieve_thresholded (``g_thr``, the
    card's result on ``qs``) against the CPU: probabilities within
    PROB_TOL; ids equal except between docs whose probabilities lie
    within PROB_TOL; passing counts equal except for docs within PROB_TOL
    of the threshold."""
    g_dense = gpu.get_probabilities_batch(qs)
    c_dense = cpu.get_probabilities_batch(qs)
    d_err = float(np.abs(g_dense - c_dense).max())
    if d_err > PROB_TOL:
        fail(f"{what}: dense probabilities differ by {d_err} > {PROB_TOL}")
    g_ids, g_p, g_n = g_thr
    c_ids, c_p, c_n = cpu.retrieve_thresholded(qs, THRESHOLD, k=K_TOP)
    t_err = float(np.abs(g_p - c_p).max())
    if t_err > PROB_TOL:
        fail(f"{what}: thresholded probabilities differ by {t_err}")
    rows, cols = np.nonzero(g_ids != c_ids)
    for r, c in zip(rows, cols):
        a, b = g_ids[r, c], c_ids[r, c]
        if a < 0 or b < 0 or abs(g_dense[r, a] - g_dense[r, b]) > PROB_TOL:
            fail(f"{what}: thresholded ids differ outside ties (query {r})")
    near = (np.abs(g_dense - THRESHOLD) <= PROB_TOL).sum(axis=1)
    if (np.abs(g_n - c_n) > near).any():
        fail(f"{what}: passing counts differ")
    log(f"{what}: card vs CPU on {len(qs)} queries: dense max |dprob| "
        f"{d_err}; thresholded ids equal ({len(rows)} tie swaps), max "
        f"|dprob| {t_err}, n_passing equal")


def check_ranked(ids, probs, nq, k, what: str, n_docs: int = N_DOCS) -> None:
    if ids.shape != (nq, k) or probs.shape != (nq, k):
        fail(f"{what}: bad output shapes {ids.shape} {probs.shape}")
    if ids.dtype != np.int32 or probs.dtype != np.float64:
        fail(f"{what}: bad output dtypes {ids.dtype} {probs.dtype}")
    if not ((ids >= -1) & (ids < n_docs)).all():
        fail(f"{what}: ids outside [-1, n_docs)")
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs < 1).all()):
        fail(f"{what}: probabilities outside [0, 1)")


def check_thresholded(out, nq, what: str) -> None:
    ids, probs, n_passing = out
    check_ranked(ids, probs, nq, K_TOP, what)
    live = ids >= 0
    if not (probs[live] >= THRESHOLD).all() or (probs[~live] != 0).any():
        fail(f"{what}: thresholded probabilities below the threshold")
    if (n_passing < live.sum(axis=1)).any() or n_passing.shape != (nq,):
        fail(f"{what}: passing counts below the returned ids")


def phase_dense(scorer, cpu, batch, card) -> dict:
    """get_probabilities_batch and retrieve_thresholded on the bench
    split index, counted."""
    import torch

    qs = batch[:DENSE_QUERIES]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = scorer.get_probabilities_batch(qs)
    dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    thr = scorer.retrieve_thresholded(batch, THRESHOLD, k=K_TOP)
    thr_s = time.perf_counter() - t0
    counts = read_counts()
    require_launched(counts, ["bm25_compare"], "dense API (bench split index)")
    if dense.shape != (DENSE_QUERIES, N_DOCS) or dense.dtype != np.float64:
        fail(f"get_probabilities_batch: bad output {dense.shape} {dense.dtype}")
    if not (np.isfinite(dense).all() and (dense >= 0).all() and (dense < 1).all()):
        fail("get_probabilities_batch: probabilities outside [0, 1)")
    check_thresholded(thr, len(batch), "retrieve_thresholded (split)")
    compare_dense(scorer, cpu, batch[:CHECK_QUERIES],
                  tuple(a[:CHECK_QUERIES] for a in thr), "dense API (split)")
    log(f"get_probabilities_batch: {DENSE_QUERIES / dense_s:.1f} q/s "
        f"({DENSE_QUERIES} queries x {N_DOCS} docs, {dense_s:.3f} s incl. "
        f"the float64 host copy) [{card}]")
    log(f"retrieve_thresholded: {len(batch) / thr_s:.1f} q/s ({len(batch)} "
        f"queries, threshold {THRESHOLD}, k={K_TOP}, passing per query "
        f"median {int(np.median(thr[2]))} max {int(thr[2].max())}) [{card}]")
    return counts


def phase_tail(corpus, batch, card) -> dict:
    """The bench corpus with its rare postings refused: retrieve through
    the dense compare tail."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import split_index as sidx
    from bayesian_bm25_tpu_torch.utils import convert

    budget = sidx._POSTINGS_MAX_ENTRIES
    sidx._POSTINGS_MAX_ENTRIES = 0    # explicit set-up: no postings table
    try:
        tail = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8",
                                  device="cuda")
        tail.index(corpus, show_progress=False)
    finally:
        sidx._POSTINGS_MAX_ENTRIES = budget
    s = tail._split
    if s.post_doc_ids is not None:
        fail("compare-tail set-up still built a postings table")
    log(f"compare-tail index: tail table {tuple(s.tail_term_ids.shape)}, "
        f"overflow {None if s.over_term_ids is None else tuple(s.over_term_ids.shape)}")
    qs = batch[:DENSE_QUERIES]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, probs = tail.retrieve(qs, k=K_TOP)
    tail_s = time.perf_counter() - t0
    counts = read_counts()
    require_launched(counts, ["bm25_compare", "block_max", "topk"],
                     "compare-tail retrieve")
    check_ranked(ids, probs, len(qs), K_TOP, "compare-tail retrieve")
    t = tail.transform
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    compare_retrieve(tail, cpu, qs[:CHECK_QUERIES], "compare-tail retrieve")
    log(f"compare-tail retrieve: {len(qs) / tail_s:.1f} q/s ({len(qs)} "
        f"queries, k={K_TOP}, first call) [{card}]")
    del tail, cpu
    torch.cuda.empty_cache()
    return counts


def phase_doc_major(card) -> tuple[dict, dict]:
    """A 200-term vocabulary: no split index, the doc-major compare.
    Returns (counts, the K5 check entry at its table)."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.utils import convert

    rng = np.random.default_rng(1)
    corpus = make_corpus(rng, n_docs=N_DOCS, vocab=DM_VOCAB)
    batches = [make_queries(rng, n=BATCH, vocab=DM_VOCAB)
               for _ in range(DM_BATCHES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm = BayesianBM25Scorer(base_rate=0.01, device="cuda")
    t0 = time.perf_counter()
    dm.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    if dm._split is not None:
        fail("doc-major corpus built a split index")
    idx, t = dm._index, dm.transform
    log(f"doc-major index: {index_s:.3f} s [{card}]; table "
        f"{tuple(idx.term_ids.shape)}, {idx.n_terms} terms; alpha "
        f"{t.alpha:.6f} beta {t.beta:.6f}")

    index_peak = torch.cuda.max_memory_allocated()
    calls = record_compares(lambda: dm.retrieve(batches[0], k=K_TOP))
    entry = check_compare("doc-major", calls[0], idx.n_terms, card)
    del calls
    # The peak below covers index and the path's runs, not the K5 check.
    torch.cuda.reset_peak_memory_stats()

    reset_counts()
    outs = dm.retrieve_many(batches, k=K_TOP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thr = dm.retrieve_thresholded(batches[0], THRESHOLD, k=K_TOP)
    thr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = dm.get_probabilities_batch(batches[0][:DENSE_QUERIES])
    dense_s = time.perf_counter() - t0
    counts = read_counts()
    log(f"doc-major retrieve_thresholded: {thr_s * 1e3:.2f} ms ({BATCH} "
        f"queries, threshold {THRESHOLD}, k={K_TOP}); get_probabilities_batch"
        f": {dense_s * 1e3:.2f} ms ({DENSE_QUERIES} queries x {N_DOCS} docs, "
        f"float64 host copy included); first calls [{card}]")
    require_launched(counts, ["bm25_compare", "topk", "block_max"],
                     "doc-major path")
    for ids, probs in outs:
        check_ranked(ids, probs, BATCH, K_TOP, "doc-major retrieve_many")
    check_thresholded(thr, BATCH, "doc-major retrieve_thresholded")
    if dense.shape != (DENSE_QUERIES, N_DOCS) or not (
            (dense >= 0) & (dense < 1)).all():
        fail("doc-major get_probabilities_batch: bad output")

    qs = batches[0][:CHECK_QUERIES]
    cpu = convert.scorer_from_numpy(convert.index_to_numpy(idx), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    g_ids = compare_retrieve(dm, cpu, qs, "doc-major retrieve")
    if not np.array_equal(g_ids, outs[0][0][:CHECK_QUERIES]):
        fail("doc-major retrieve and retrieve_many disagree")
    compare_dense(dm, cpu, qs, tuple(a[:CHECK_QUERIES] for a in thr),
                  "doc-major dense API")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dm.retrieve_many(batches, k=K_TOP)
        runs.append(DM_BATCHES * BATCH / (time.perf_counter() - t0))
    peak = max(index_peak, torch.cuda.max_memory_allocated())
    log(f"doc-major retrieve_many: {sorted(runs)[1]:.1f} q/s median of 3 "
        f"runs {[round(r, 1) for r in runs]} ({DM_BATCHES} x {BATCH} "
        f"queries, k={K_TOP}) [{card}]")
    log(f"doc-major peak device memory: {peak / 2**30:.3f} GiB [{card}]")
    log(f"doc-major index seconds: {index_s:.3f} [{card}]")
    return counts, entry


def k4_synthetic(gen, mode: str, nq: int, D: int, K: int):
    """K4 edge-case operands on the card: sparse count rows with every 7th
    row all zero, and signed impact values, so totals can be negative."""
    import torch

    q = torch.randint(0, 4, (nq, K), generator=gen, device="cuda").float()
    q[torch.rand((nq, K), generator=gen, device="cuda") < 0.9] = 0.0
    q[::7] = 0.0
    if mode == "int8":
        pair = [torch.randint(-127, 128, (D, K), generator=gen, device="cuda",
                              dtype=torch.int8) for _ in range(2)]
        scale = torch.rand((2, D), generator=gen, device="cuda") * 0.05
        return q, pair[0], pair[1], scale
    w = (torch.rand((D, K), generator=gen, device="cuda") - 0.5) * 8.0
    w[torch.rand((D, K), generator=gen, device="cuda") < 0.8] = 0.0
    hi = w.to(torch.bfloat16)
    if mode == "pair":
        return q, hi, (w - hi.float()).to(torch.bfloat16), None
    return q, hi, None, None


def batch_qvec(scorer, batch):
    """The frequent-term count matrix the sparse path builds for ``batch``
    (a column slice of the densified (nq, K + 1) matrix, as the path
    passes it)."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx
    from bayesian_bm25_tpu_torch.engine.index import to_device

    s = scorer._split
    fslots, fcnt = sidx.encode_queries_split(batch, s)[:2]
    qvec, _ = sidx._densify_queries(to_device(fslots, "cuda"),
                                    to_device(fcnt, "cuda"), s.n_frequent)
    nnz = (qvec != 0).sum(dim=1)
    log(f"batch qvec {tuple(qvec.shape)}: nonzeros per row mean "
        f"{float(nnz.float().mean()):.3f} max {int(nnz.max())}; "
        f"{1 - float(nnz.sum()) / qvec.numel():.5f} of entries zero")
    return qvec


def check_k4(mode: str, q, cols, scale, n_docs: int, label: str,
             real: bool) -> dict:
    """K4 on the counts ``q`` and the column-major impact matrices
    ``cols`` (hi, lo) against its plain version: maxima equal to the
    masked maxima of the kernel's own scores (-inf for blocks wholly
    past n_docs); int8 bit-exact; hilo and bf16 within 1 ulp of the
    plain score on the path's operands (``real``: its counts, and
    impact values from an index or random), and within nnz ulps of the
    terms' magnitude on signed synthetic ones (the order of a dot's
    nonzero terms)."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_matmul, cuda_reduce

    got_s, got_b = cuda_matmul.impact_matmul_bmax(q, *cols, scale, n_docs)
    want_s, want_b = cuda_matmul.impact_matmul_bmax_plain(q, *cols, scale,
                                                          n_docs)
    torch.cuda.synchronize()
    if not torch.equal(got_b, cuda_reduce.block_max_plain(got_s, 256, n_docs)):
        fail(f"K4 {label}: maxima differ from the masked maxima of its scores")
    first_dead = -(-n_docs // 256)
    if not bool((got_b[:, first_dead:] == float("-inf")).all()):
        fail(f"K4 {label}: a block past n_docs is not -inf")
    inf = torch.tensor(float("inf"), device="cuda")
    if mode == "int8":
        if not (torch.equal(got_s, want_s) and torch.equal(got_b, want_b)):
            fail(f"K4 {label}: int8 scores are not bit-exact "
                 f"({int((got_s != want_s).sum())} differ)")
        ulps = 0.0
    else:
        gap = (got_s.double() - want_s.double()).abs()
        ulp = (torch.nextafter(want_s.abs(), inf) - want_s.abs()).double()
        ulps = float((gap / ulp).max())
        if real and ulps > 1.0:
            fail(f"K4 {label}: {ulps} ulps from the plain version")
        if not real:
            hi_t, lo_t = cols
            absw = hi_t.float().abs() + (
                0.0 if lo_t is None else lo_t.float().abs())
            mag = q.abs() @ absw
            nnz = (q != 0).sum(dim=1, keepdim=True).clamp(min=1).double()
            ulp_mag = (torch.nextafter(mag, inf) - mag).double()
            if not bool((gap <= nnz * ulp_mag).all()):
                fail(f"K4 {label}: beyond the rounding of its nonzero terms")
            del absw, mag, ulp_mag
        del gap, ulp
    err = max(max_abs_err(got_s, want_s), max_abs_err(got_b, want_b))
    log(f"K4 {label}: scores {tuple(got_s.shape)}, max gap {ulps} ulps, max "
        f"|diff| {err}, maxima = masked max of its own scores")
    del got_s, got_b, want_s, want_b
    torch.cuda.empty_cache()
    return dict(ulps=ulps, err=err)


def time_k4(mode: str, q, cols, scale, n_docs: int, label: str, card,
            rows) -> dict:
    """K4 on the column-major ``cols``, its plain version and the
    unfused route (library product on the row-major matrices ``rows``,
    then K1) timed with CUDA events; the bound from the bytes and the
    operations these inputs need."""
    from bayesian_bm25_tpu_torch.engine import (cuda_matmul, cuda_reduce,
                                                split_index as sidx)

    ms = cuda_ms(lambda: cuda_matmul.impact_matmul_bmax(q, *cols, scale,
                                                        n_docs))
    plain_ms = cuda_ms(lambda: cuda_matmul.impact_matmul_bmax_plain(
        q, *cols, scale, n_docs))
    unfused_ms = cuda_ms(lambda: cuda_reduce.block_max(
        sidx._impact_matmul(q, *rows, scale=scale), 256, n_docs))
    nq, K = q.shape
    D = cols[0].shape[1]
    passes = 1 if cols[1] is None else 2
    n_bytes = (nq * K * 4 + passes * cols[0].numel() * cols[0].element_size()
               + (0 if scale is None else scale.numel() * 4)
               + nq * D * 4 + nq * (D // 256) * 4)
    n_ops = 2 * int((q != 0).sum()) * D * passes
    b = bound(n_bytes, n_ops,
              INT8_OPS_PER_S if mode == "int8" else BF16_OPS_PER_S)
    log(f"K4 {label} {(nq, K)} x {(K, D)}: {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms, unfused route {unfused_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({n_bytes / 1e9:.3f} GB, "
        f"{n_ops:.3e} operations) [{card}]")
    return dict(mode=mode, shape=[[nq, K], [K, D]], ms=ms,
                plain_ms=plain_ms, unfused_ms=unfused_ms, n_bytes=n_bytes,
                n_ops=n_ops, **b)


def kept_columns(split, label: str, card):
    """The split index's column-major copy of its impact matrices (the
    layout K4 reads), built here on first use: its bytes and build
    time."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols = split.impact_columns()
    torch.cuda.synchronize()
    n_bytes = sum(c.numel() * c.element_size() for c in cols if c is not None)
    shapes = [tuple(c.shape) for c in cols if c is not None]
    log(f"K4 column-major copy ({label}): {shapes} {cols[0].dtype}, "
        f"{n_bytes / 1e6:.1f} MB, built in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
    return cols


def k4_edges(gen) -> float:
    """K4 on synthetic edge cases in every storage mode; the largest
    max |diff| against the plain version."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    errs = []
    for mode in ("int8", "pair", "single"):
        for nq, D, K, n_docs in ((777, 4096, 1024, 3000), (33, 2560, 104, 2049),
                                 (300, 512, 64, 0)):
            q, hi, lo, scale = k4_synthetic(gen, mode, nq, D, K)
            errs.append(check_k4(mode, q, sidx._column_major(hi, lo), scale,
                                 n_docs, f"{mode} edge nq={nq} D={D} K={K} "
                                 f"n_docs={n_docs}", real=False)["err"])
    return max(errs)


def k4_path_sparsity(gen) -> float:
    """K4's bf16 modes held to 1 ulp on the main path's shape, (8192,
    2048) x (2048, 51200), with counts of the path's sparsity (8
    Zipf(1.3) tokens a query, as the bench queries draw them) and random
    non-negative impact values, not an index's; the largest max
    |diff|."""
    import torch

    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    nq, D, K = 8192, 51200, 2048
    rng = np.random.default_rng(0)
    tok = rng.zipf(1.3, size=(nq, 8)) - 1
    q = np.zeros((nq, K), np.float32)
    for j in range(8):
        ok = tok[:, j] < K
        np.add.at(q, (np.nonzero(ok)[0], tok[ok, j]), 1.0)
    q = torch.from_numpy(q).cuda()
    log(f"K4 path-sparsity counts {tuple(q.shape)}: nonzeros per row mean "
        f"{float((q != 0).sum(dim=1).float().mean()):.3f}")
    w = torch.rand((D, K), generator=gen, device="cuda") * 4.0
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    del w
    errs = []
    for mode, pair in (("pair", (hi, lo)), ("single", (hi, None))):
        errs.append(check_k4(mode, q, sidx._column_major(*pair), None,
                             D - 100, f"{mode} (path sparsity, random "
                             "impact values)", real=True)["err"])
    del q, hi, lo
    torch.cuda.empty_cache()
    return max(errs)


def retrieve_many_qps(scorer, batches, fused: bool) -> tuple[float, list]:
    """Median q/s of 3 timed retrieve_many runs with FUSED_MM set as
    given."""
    import torch

    with fused_mm(fused):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer.retrieve_many(batches, k=K_TOP)
            runs.append(len(batches) * len(batches[0])
                        / (time.perf_counter() - t0))
    return sorted(runs)[1], runs


def phase_fused(scorer, cpu, batches, label: str, card,
                tie_ulps: int = 0) -> tuple[dict, dict]:
    """FUSED_MM on: retrieve_many over the batches, counted (K4 > 0),
    checked against the CPU; then the A/B in turns (unfused, fused,
    fused, unfused). Returns (counts, A/B medians)."""
    import torch

    with fused_mm(True):
        reset_counts()
        torch.cuda.synchronize()
        outs = scorer.retrieve_many(batches, k=K_TOP)
        counts = read_counts()
        require_launched(counts, ["impact_matmul_bmax", "row_gather", "topk"],
                         f"fused retrieve_many ({label})")
        log(f"fused retrieve_many ({label}): K1 block_max launched "
            f"{counts['block_max']} times (leader selection takes K4's maxima)")
        for ids, probs in outs:
            check_ranked(ids, probs, len(batches[0]), K_TOP,
                         f"fused retrieve_many ({label})")
        compare_retrieve(scorer, cpu, batches[0][:CHECK_QUERIES],
                         f"fused retrieve ({label})", tie_ulps)
    with fused_mm(False):
        compare_retrieve(scorer, cpu, batches[0][:CHECK_QUERIES],
                         f"unfused retrieve ({label})", tie_ulps)
    ab = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        qps, runs = retrieve_many_qps(scorer, batches, route == "fused")
        ab[route].append(qps)
        log(f"A/B {label} {route}: {qps:.1f} q/s median of 3 runs "
            f"{[round(r, 1) for r in runs]} ({len(batches)} x "
            f"{len(batches[0])} queries, k={K_TOP}) [{card}]")
    return counts, ab


def phase_ctor(corpus, batches, card):
    """The constructor's default configuration on the bench corpus: hilo
    storage. K4 in hilo and single-bf16 mode at the path's widths, then
    the fused A/B. Returns (scorer, counts, K4 timings)."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.utils import convert

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctor = BayesianBM25Scorer(base_rate=0.01, device="cuda")
    t0 = time.perf_counter()
    ctor.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    s, t = ctor._split, ctor.transform
    if (s is None or s.dense_impact.dtype != torch.bfloat16
            or s.dense_impact_lo is None or s.impact_scale is not None):
        fail("BayesianBM25Scorer() did not build hilo storage")
    log(f"ctor-default index: {index_s:.3f} s [{card}]; hilo bf16 pair "
        f"{tuple(s.dense_impact.shape)}, postings {tuple(s.post_doc_ids.shape)}; "
        f"alpha {t.alpha:.6f} beta {t.beta:.6f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")

    qvec = batch_qvec(ctor, batches[0])
    cols = kept_columns(s, "ctor default hilo", card)
    timings, errs = [], []
    for mode, c, rows in (
            ("pair", cols, (s.dense_impact, s.dense_impact_lo)),
            ("single", (cols[0], None), (s.dense_impact, None))):
        errs.append(check_k4(mode, qvec, c, None, s.n_docs, f"{mode} "
                             "(ctor-default operands)", real=True)["err"])
        timings.append(time_k4(mode, qvec, c, None, s.n_docs,
                               f"{mode} (ctor default)", card, rows))
    del qvec, cols
    torch.cuda.empty_cache()
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    torch.cuda.reset_peak_memory_stats()
    counts, ab = phase_fused(ctor, cpu, batches, "ctor default hilo", card,
                             tie_ulps=1)
    log(f"ctor-default peak device memory (retrieval): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    log(f"ctor-default index seconds: {index_s:.3f} [{card}]")
    return ctor, counts, timings, max(errs), ab


def phase_lifecycle(scorer, corpus, batches, card) -> list[dict]:
    """Tombstones, restore, add_documents and retrieve_stream on the
    ctor-default scorer with FUSED_MM on; each step counted."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer

    victims = np.arange(0, N_DOCS, 100)            # 1% of the ids
    qs = batches[0]
    with fused_mm(True):
        scorer.delete_documents(victims)
        reset_counts()
        ids, probs = scorer.retrieve(qs, k=K_TOP)
        del_counts = read_counts()
        if del_counts["impact_matmul_bmax"] != 0:
            fail("K4 ran on a batch with tombstones")
        require_launched(del_counts, ["row_gather", "topk", "block_max"],
                         "retrieve with tombstones")
        check_ranked(ids, probs, len(qs), K_TOP, "retrieve with tombstones")
        if np.isin(ids, victims).any():
            fail("a deleted id was returned")
        dense = scorer.get_probabilities_batch(qs[:DENSE_QUERIES])
        if (dense[:, victims] != 0).any() or not (dense > 0).any():
            fail("dense probabilities of deleted docs are not 0")
        del dense
        scorer.restore_documents(victims)
        if scorer.deleted_mask is not None:
            fail("restore_documents left tombstones")
        reset_counts()
        scorer.retrieve(qs, k=K_TOP)
        res_counts = read_counts()
        require_launched(res_counts, ["impact_matmul_bmax"],
                         "retrieve after restore_documents")
        log(f"lifecycle: {len(victims)} docs deleted: no deleted id in "
            f"{len(qs)} x {K_TOP} results, dense probabilities 0 on their "
            f"columns; restored: K4 launched again")

        new_docs = make_corpus(np.random.default_rng(2), n_docs=ADD_DOCS)
        cpu = BayesianBM25Scorer(base_rate=0.01, device="cpu")
        t0 = time.perf_counter()
        cpu.index(corpus, show_progress=False)
        cpu.add_documents(new_docs, show_progress=False)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scorer.add_documents(new_docs, show_progress=False)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        n_all = N_DOCS + ADD_DOCS
        if scorer.num_docs != n_all or cpu.num_docs != n_all:
            fail("add_documents: wrong document count")
        reset_counts()
        grown = scorer.retrieve_many(batches, k=K_TOP)
        add_counts = read_counts()
        require_launched(add_counts, ["impact_matmul_bmax", "row_gather"],
                         "retrieve_many after add_documents")
        for g_ids, g_probs in grown:
            check_ranked(g_ids, g_probs, len(qs), K_TOP,
                         "retrieve_many after add_documents", n_docs=n_all)
        if not (np.concatenate([g[0] for g in grown]) >= N_DOCS).any():
            fail("no added document was ever retrieved")
        compare_retrieve(scorer, cpu, qs[:CHECK_QUERIES],
                         "retrieve after add_documents", tie_ulps=1)
        log(f"add_documents: {ADD_DOCS} docs in {add_s:.3f} s [{card}] (CPU "
            f"index + add {cpu_s:.1f} s); alpha {scorer.transform.alpha:.6f} "
            f"vs CPU {cpu.transform.alpha:.6f}, beta "
            f"{scorer.transform.beta:.6f} vs CPU {cpu.transform.beta:.6f}")
        del cpu

        reset_counts()
        streamed = list(scorer.retrieve_stream(batches, k=K_TOP, lookahead=4))
        stream_counts = read_counts()
        require_launched(stream_counts, ["impact_matmul_bmax"],
                         "retrieve_stream")
        if len(streamed) != len(grown) or not all(
                np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(streamed, grown)):
            fail("retrieve_stream differs from retrieve_many")
        log(f"retrieve_stream(lookahead=4): {len(streamed)} batches equal to "
            "retrieve_many")
    return [del_counts, res_counts, add_counts, stream_counts]


def make_corpus_1m(rng, n_docs=N_1M, doc_len=LEN_1M, vocab=VOCAB_1M):
    """The corpus of the JAX package's 1M profile
    (benchmarks/profiles/profile_1m_stages.py): Zipf(1.3) draws mod
    ``vocab``. Each term is one interned string, so 120M tokens cost
    about 1 GB of host lists."""
    names = [f"t{i}" for i in range(vocab)]
    zipf = rng.zipf(1.3, size=(n_docs, doc_len)) % vocab
    corpus = []
    for lo in range(0, n_docs, 10_000):
        corpus.extend(list(map(names.__getitem__, row))
                      for row in zipf[lo:lo + 10_000].tolist())
    return corpus


def merge_kind(kw) -> str:
    """The pass a split_index._sparse_merge call makes, from its keyword
    arguments: "tier-2" (group B's postings2), "heavy" (the heavy rows'
    base_tail_tf) or "tier-1"."""
    if kw.get("postings2") is not None:
        return "tier-2"
    return "heavy" if kw.get("base_tail_tf") is not None else "tier-1"


STAGE = "stage: "


def staged(sidx, on_range=None):
    """Wrap the split path's stages in profiler ranges (this process
    only): the frequent-term matmul (the unfused product or K4), leader
    selection (blockwise with K1, or from K4's maxima), each merge pass
    by kind, and tf at the winners with the transform ("tf +
    transform"). ``on_range(label)``, if given, is a context manager
    entered around each stage call that no other stage call holds.
    Returns a function that restores the originals."""
    from torch.profiler import record_function

    from bayesian_bm25_tpu_torch.engine import cuda_matmul
    from bayesian_bm25_tpu_torch.ops import transform as T

    orig = (sidx._impact_matmul, sidx.exact_topk_blockwise, sidx._sparse_merge,
            cuda_matmul.impact_matmul_bmax, sidx._topk_from_bmax,
            sidx._winner_tf_freq, T.score_to_probability)
    depth = [0]

    def wrap(fn, name, outermost=False):
        def run(*a, **kw):
            if outermost and depth[0]:
                return fn(*a, **kw)
            label = name(kw) if callable(name) else name
            outer = on_range is not None and depth[0] == 0
            depth[0] += 1
            try:
                with record_function(STAGE + label), (
                        on_range(label) if outer else contextlib.nullcontext()):
                    return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    sidx._impact_matmul = wrap(orig[0], "matmul")
    sidx.exact_topk_blockwise = wrap(orig[1], "leader selection")
    sidx._sparse_merge = wrap(orig[2], lambda kw: "merge " + merge_kind(kw))
    cuda_matmul.impact_matmul_bmax = wrap(orig[3], "matmul")
    # Fused, leader selection calls _topk_from_bmax directly; unfused,
    # exact_topk_blockwise's range already holds it.
    sidx._topk_from_bmax = wrap(orig[4], "leader selection", outermost=True)
    sidx._winner_tf_freq = wrap(orig[5], "tf + transform")
    T.score_to_probability = wrap(orig[6], "tf + transform")

    def restore():
        (sidx._impact_matmul, sidx.exact_topk_blockwise, sidx._sparse_merge,
         cuda_matmul.impact_matmul_bmax, sidx._topk_from_bmax,
         sidx._winner_tf_freq, T.score_to_probability) = orig
    return restore


def kernel_bucket(name: str) -> str:
    if any(k in name for k in ("impact_matmul", "compact_kernel",
                               "int8_kernel", "bf16_kernel")):
        return "K4 impact_matmul_bmax"
    if "bm25_hash_kernel" in name or "bm25_scan_kernel" in name:
        return "K5 bm25_compare"
    if "row_gather" in name:
        return "K2 row_gather"
    if "topk" in name:
        return "K3 topk"
    if "block_max" in name:
        return "K1 block_max"
    if "sort" in name.lower():
        return "sort"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "gemm"
    return "other"


def stage_device_ms(events) -> tuple[dict, dict]:
    """Device ms by kernel bucket of each ``staged`` range in a profiler's
    events, with the range's count under "calls", and of the device
    events outside every range. A device event belongs to the range
    whose CPU span holds the runtime call that launched it (the two share
    a correlation id); one whose call was not traced, to the range's
    span on the device that holds its start."""
    import bisect

    import torch

    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def spans(device_type):
        return sorted((e.time_range.start, e.time_range.end,
                       e.name[len(STAGE):]) for e in events
                      if e.device_type == device_type
                      and e.name.startswith(STAGE))

    def holding(sp, t):
        j = bisect.bisect_right([x[0] for x in sp], t) - 1
        return sp[j][2] if j >= 0 and t < sp[j][1] else None

    on_cpu, on_dev = spans(cpu), spans(dev)
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    stages: dict[str, dict[str, float]] = {}
    for _, _, name in on_cpu:
        d = stages.setdefault(name, {})
        d["calls"] = d.get("calls", 0) + 1
    rest: dict[str, float] = {}
    for e in events:
        if e.device_type != dev or e.name.startswith(STAGE):
            continue
        t = launched.get(e.id)
        name = (holding(on_cpu, t) if t is not None
                else holding(on_dev, e.time_range.start))
        d = rest if name is None else stages.setdefault(name, {})
        b = kernel_bucket(e.name)
        d[b] = d.get(b, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return stages, rest


def launch_lag_ms(events) -> float:
    """The least time, in ms, from a runtime call to the start of the
    device event it launched, over a profiler's events: a few
    microseconds when the trace's device clock agrees with the host's,
    below 0 when it runs behind."""
    import torch

    launched = {e.id: e.time_range.start for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("cu")}
    return min((e.time_range.start - launched[e.id] for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.id in launched), default=float("nan")) / 1e3


def record_passes(fn):
    """Run ``fn()`` with the merge schedule recorded per chunk (one
    split_tail_groups call each): whether it has a group B, whether
    split_light_heavy and split_light_heavy_b engaged, and its
    _sparse_merge passes in order, each [kind, K2's sid shape] with kind
    "tier-1", "heavy" or "tier-2". Returns (fn's result, chunks)."""
    from bayesian_bm25_tpu_torch.engine import cuda_gather
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    chunks = []
    orig = (sidx.split_tail_groups, sidx.split_light_heavy,
            sidx.split_light_heavy_b, sidx._sparse_merge,
            cuda_gather.row_gather)

    def groups(*a, **kw):
        out = orig[0](*a, **kw)
        chunks.append(dict(group_b=out[1] is not None, light_heavy=False,
                           light_heavy_b=False, passes=[]))
        return out

    def lh(*a, **kw):
        out = orig[1](*a, **kw)
        chunks[-1]["light_heavy"] = out is not None
        return out

    def lhb(*a, **kw):
        out = orig[2](*a, **kw)
        chunks[-1]["light_heavy_b"] = out is not None
        return out

    def merge(*a, **kw):
        chunks[-1]["passes"].append([merge_kind(kw)])
        return orig[3](*a, **kw)

    def gather(scores, sid, trows):
        chunks[-1]["passes"][-1].append(list(sid.shape))
        return orig[4](scores, sid, trows)

    (sidx.split_tail_groups, sidx.split_light_heavy, sidx.split_light_heavy_b,
     sidx._sparse_merge, cuda_gather.row_gather) = (groups, lh, lhb, merge,
                                                     gather)
    try:
        out = fn()
    finally:
        (sidx.split_tail_groups, sidx.split_light_heavy,
         sidx.split_light_heavy_b, sidx._sparse_merge,
         cuda_gather.row_gather) = orig
    return out, chunks


def require_passes(chunks, what: str) -> None:
    """Fail unless some chunk split group A into light and heavy rows,
    some ran a group-B (tier-2) pass and some split group B."""
    for name, test in (
            ("the group-A light/heavy split", lambda c: c["light_heavy"]),
            ("a group-B (tier-2) pass",
             lambda c: any(p[0] == "tier-2" for p in c["passes"])),
            ("the group-B light/heavy split", lambda c: c["light_heavy_b"])):
        n = sum(1 for c in chunks if test(c))
        if n == 0:
            fail(f"{what}: no chunk ran {name}")
        log(f"{what}: {name} in {n} of {len(chunks)} chunks")


def csr_turns(corpus, card) -> dict:
    """A fresh vocabulary's corpus CSR build, the step ``build_index``
    moved to C++, both ways (native, then the Python twin), one build
    each. Both must give the same vocabulary and arrays. Returns the
    seconds of each build by route."""
    from bayesian_bm25_tpu_torch.engine import index as tidx
    from bayesian_bm25_tpu_torch.engine import native

    secs = {"python": [], "native": []}
    ref = None
    for route in ("native", "python"):
        t0 = time.perf_counter()
        if route == "python":
            vocab = {}
            arrays = tidx._corpus_to_csr(corpus, vocab)
        else:
            built = native.build_corpus_tokens_native(corpus)
            if built is None:
                fail("corpus CSR turns: the native build declined the corpus")
            vocab, *arrays = built
        secs[route].append(time.perf_counter() - t0)
        if ref is None:
            ref = (vocab, arrays)
        elif vocab != ref[0] or not all(
                np.array_equal(a, b) for a, b in zip(arrays, ref[1])):
            fail(f"corpus CSR turns: the {route} build differs")
        del vocab, arrays
    nnz = int(ref[1][0][-1])
    log(f"split 1M corpus CSR both ways (native, then Python): "
        f"python {[round(x, 3) for x in secs['python']]} s, native "
        f"{[round(x, 3) for x in secs['native']]} s; {len(ref[0])} terms, "
        f"{nnz} (doc, term) pairs, equal both ways [{card}]")
    return secs


def phase_split_1m(card, flush):
    """The 1M-document configuration: the constructor's default scorer
    (int8 storage past 2^18 padded docs), tier-2 postings, 1,024-query
    chunks. A counted retrieve_many with its merge passes recorded, the
    kernels on the richest chunk's own operands, 32 queries against the
    CPU, q/s, peak memory and index seconds; then FUSED_MM on for one
    counted retrieve_many (equal to the unfused run, 32 queries against
    the CPU), K4 bit-exact and timed on the richest chunk's operands, and
    the unfused/fused A/B in turns. Returns (unfused counts, fused
    counts, K1, K2, K3 and K4 records, K4's max |diff|, the A/B, and for
    phase 19 the corpus, the batches and the unfused results on the
    host; the scorer itself is freed; for phase 20 the richest chunk's
    stage times, unfused and fused, with D_pad and K, and the tier-1 and
    tier-2 postings widths)."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.models.scorer import _chunks
    from bayesian_bm25_tpu_torch.utils import convert

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    corpus = make_corpus_1m(rng)
    batches = [make_queries(rng, n=BATCH, vocab=VOCAB_1M)
               for _ in range(BATCHES_1M)]
    log(f"1M corpus: {N_1M} docs x {LEN_1M} tokens over {VOCAB_1M} terms "
        f"and {BATCHES_1M} x {BATCH} queries made in "
        f"{time.perf_counter() - t0:.1f} s; first doc "
        f"{' '.join(corpus[0][:6])}, first query {' '.join(batches[0][0])}")
    csr_s = csr_turns(corpus, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scorer = BayesianBM25Scorer(base_rate=0.01, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    scorer.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_peak = torch.cuda.max_memory_allocated()
    require_native(read_counts(), "split 1M index", ["corpus_tokens"])
    s, t = scorer._split, scorer.transform
    if s is None or s.impact_scale is None:
        fail("split 1M: BayesianBM25Scorer() did not build int8 storage")
    if s.post_doc_ids is None or s.post2_doc_ids is None:
        fail("split 1M: the index has no tier-2 postings")
    chunk = scorer._auto_batch_size()
    log(f"split 1M index: {index_s:.3f} s [{card}]; D_pad "
        f"{s.dense_impact.shape[0]}, K {s.n_frequent}, storage int8, "
        f"postings {tuple(s.post_doc_ids.shape)}, tier-2 "
        f"{tuple(s.post2_doc_ids.shape)}, tail table "
        f"{tuple(s.tail_term_ids.shape)}, overflow "
        f"{None if s.over_term_ids is None else tuple(s.over_term_ids.shape)}"
        f", chunks of {chunk} queries; alpha {t.alpha:.6f} beta "
        f"{t.beta:.6f}; peak {index_peak / 2**30:.3f} GiB [{card}]")

    # The library route first: its counted run and K1-K3 on its operands.
    with fused_mm(False):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, chunks = record_passes(lambda: scorer.retrieve_many(batches,
                                                                  k=K_TOP))
        first_s = time.perf_counter() - t0
        counts = read_counts()
        require_launched(counts, ["block_max", "row_gather", "topk"],
                         "split 1M retrieve_many")
        for ids, probs in outs:
            check_ranked(ids, probs, BATCH, K_TOP, "split 1M retrieve_many",
                         n_docs=N_1M)
        flat = [p for qb in batches for p in _chunks(qb, chunk)]
        if len(chunks) != len(flat):
            fail(f"split 1M: {len(chunks)} chunks recorded, {len(flat)} sent")
        for i, c in enumerate(chunks):
            log(f"split 1M chunk {i}: {json.dumps(c)}")
        require_passes(chunks, "split 1M")
        log(f"split 1M counted retrieve_many: {first_s:.3f} s for "
            f"{BATCHES_1M} x {BATCH} queries (first call) [{card}]")
        enc = {route: encode_ms(s, flat, route == "python")
               for route in ("native", "python")}
        log(f"split 1M host encode per {chunk}-query chunk: native "
            f"{enc['native']:.3f} ms, Python twin {enc['python']:.3f} ms "
            f"(mean of {len(flat)} chunks) [{card}]")

        j = max(range(len(chunks)), key=lambda i: len(chunks[i]["passes"]))
        shapes = record_shapes(scorer, flat[j], K_TOP)
        if [list(g[1]) for g in shapes["row_gather"]] != [
                p[1] for p in chunks[j]["passes"]]:
            fail(f"split 1M: chunk {j} gave other K2 shapes when run again")
        log(f"split 1M kernel shapes (chunk {j}): {json_shapes(shapes)}")
        label = f"split 1M chunk {j}"
        x, block, vu = shapes["block_max_inputs"]
        k1 = check_block_max(x, block, (vu,), label, card)
        k2 = [check_k2(ops, f"{label} call {i}", card, flush)
              for i, ops in enumerate(shapes["row_gather_inputs"])]
        k3 = [check_topk(xk, kk, label, card) for ((_, kk), xk) in
              sorted(shapes["topk_inputs"].items(), key=lambda kv: kv[0])]
        del shapes, x
        # K2 also at the run's widest call, when another chunk gives it.
        w = max(range(len(chunks)), key=lambda i: max(
            p[1][0] * p[1][1] for p in chunks[i]["passes"]))
        if w != j:
            wide = record_shapes(scorer, flat[w], K_TOP)
            ops = max(wide["row_gather_inputs"], key=lambda o: o[1].numel())
            k2.append(check_k2(ops, f"split 1M chunk {w} widest call", card,
                               flush))
            del wide, ops
        torch.cuda.empty_cache()

        qs = batches[0][:CHECK_QUERIES]
        cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s),
                                        t.alpha, t.beta, t.base_rate,
                                        device="cpu")
        g_ids = compare_retrieve(scorer, cpu, qs, "split 1M retrieve")
        if not np.array_equal(g_ids, outs[0][0][:CHECK_QUERIES]):
            fail("split 1M: retrieve and retrieve_many disagree")

    # K4 at 1M: FUSED_MM on for one counted retrieve_many, equal to the
    # unfused run (int8 is bit-exact), and 32 queries against the CPU.
    cols = kept_columns(s, "split 1M", card)
    with fused_mm(True):
        reset_counts()
        torch.cuda.synchronize()
        fused_outs = scorer.retrieve_many(batches, k=K_TOP)
        fused_counts = read_counts()
        require_launched(fused_counts, ["impact_matmul_bmax", "row_gather",
                                        "topk"], "split 1M fused retrieve_many")
        for (fi, fp), (ui, up) in zip(fused_outs, outs):
            if not (np.array_equal(fi, ui) and np.array_equal(fp, up)):
                fail("split 1M: fused and unfused retrieve_many differ")
        log(f"split 1M fused retrieve_many: equal to the unfused run "
            f"({BATCHES_1M} x {BATCH} queries)")
        compare_retrieve(scorer, cpu, qs, "split 1M fused retrieve")
    del cpu, fused_outs

    # K4 on the richest chunk's own operands: its (1024, K) counts and
    # the index's int8 pair.
    qvec = batch_qvec(scorer, flat[j])
    k4_err = check_k4("int8", qvec, cols, s.impact_scale, s.n_docs,
                      f"int8 ({label} operands)", real=True)["err"]
    k4 = time_k4("int8", qvec, cols, s.impact_scale, s.n_docs,
                 f"int8 ({label})", card, (s.dense_impact, s.dense_impact_lo))
    del qvec, cols
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    ab = {"unfused": [], "fused": []}
    for route in ("unfused", "fused", "fused", "unfused"):
        qps, runs = retrieve_many_qps(scorer, batches, route == "fused")
        ab[route].append(qps)
        log(f"split 1M retrieve_many {route}: {qps:.1f} q/s median of 3 "
            f"runs {[round(r, 1) for r in runs]} ({BATCHES_1M} x {BATCH} "
            f"queries, k={K_TOP}) [{card}]")
    peak = max(index_peak, torch.cuda.max_memory_allocated())
    log(f"A/B split 1M: unfused {[round(x, 1) for x in ab['unfused']]} q/s, "
        f"fused {[round(x, 1) for x in ab['fused']]} q/s [{card}]")
    log(f"split 1M peak device memory: {peak / 2**30:.3f} GiB (index "
        f"{index_peak / 2**30:.3f}; K4's column-major copy included) [{card}]")
    log(f"split 1M index seconds: {index_s:.3f} (native corpus CSR; "
        f"the CSR alone {min(csr_s['native']):.3f} s native, "
        f"{min(csr_s['python']):.3f} s Python) [{card}]")
    # Phase 20's 1M point: the richest chunk's stages, unfused and fused.
    t0 = time.perf_counter()
    stages = {route: stage_ms(scorer, flat[j], route == "fused")
              for route in ("unfused", "fused")}
    log(f"phase 20, the 1M chunk's stages: {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    point = (s.dense_impact.shape[0], s.n_frequent, stages)
    widths = (s.post_doc_ids.shape[1], s.post2_doc_ids.shape[1])
    del scorer
    torch.cuda.empty_cache()
    return (counts, fused_counts, k1, k2, k3, k4, k4_err, ab,
            (corpus, batches, outs), point, widths)


@contextlib.contextmanager
def fused_mm(value):
    """Within it, ``split_index.FUSED_MM`` is ``value`` (True: K4; False:
    the library product and K1); on leaving, the value it found (None by
    default: K4 on the card)."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    found = sidx.FUSED_MM
    sidx.FUSED_MM = value
    try:
        yield
    finally:
        sidx.FUSED_MM = found


@contextlib.contextmanager
def python_encoder():
    """Within it, the port's encoders find no native library and run
    their Python twins (the index module's ``get_native_encoder`` patched
    to return None, here only)."""
    from bayesian_bm25_tpu_torch.engine import index as eidx

    orig = eidx.get_native_encoder
    eidx.get_native_encoder = lambda index: None
    try:
        yield
    finally:
        eidx.get_native_encoder = orig


def encode_ms(split, batches, python: bool) -> float:
    """Mean host milliseconds of split_index.encode_queries_split over
    ``batches``, native or (``python``) its Python twin."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    with python_encoder() if python else contextlib.nullcontext():
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            sidx.encode_queries_split(qb, split)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times))


# Raw text (phase 13): generated words over consonant-vowel syllables with
# English suffixes, the stopwords first (the most frequent Zipf ranks),
# and capitalized and upper-case variants, so lowercasing, stopword
# removal and both stemmers all act.
SYLLABLES = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
SUFFIXES = ("", "s", "ing", "ies", "ational", "ness", "ed", "ly", "ation",
            "ful", "izer", "ement")
TEXT_STOPWORDS = ("the of and a to in is it that with for as on was by be "
                  "at this are not or such their then there").split()


def make_words(vocab=30_000) -> np.ndarray:
    n = len(SYLLABLES)
    words = [SYLLABLES[i // (n * n)] + SYLLABLES[(i // n) % n]
             + SYLLABLES[i % n] + SUFFIXES[i % len(SUFFIXES)]
             for i in range(vocab)]
    variants = ([w.capitalize() for w in words[::7]]
                + [w.upper() for w in words[::31]])
    return np.array(TEXT_STOPWORDS + words + variants, dtype=object)


def make_texts(rng, words, n, length):
    draws = rng.zipf(1.3, size=(n, length)) % len(words)
    return [" ".join(words[row]) + "." for row in draws]


def write_corpus_jsonl(path, texts) -> None:
    with open(path, "w") as f:
        for i, text in enumerate(texts):
            f.write(json.dumps({"_id": f"doc{i}", "title": text[:24],
                                "text": text}) + "\n")


def text_config(label, kw, stem, tie_ulps, path, query_texts, card):
    """index_jsonl under ``kw`` and ``stem``, counted; retrieve_texts on
    the query texts, counted; 32 queries against the same state on the
    CPU. Returns (scorer, index counts, retrieve counts)."""
    import torch

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts
    from bayesian_bm25_tpu_torch.utils import convert

    scorer = BayesianBM25Scorer(base_rate=0.01, device="cuda", **kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = scorer.index_jsonl(path, stem=stem)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    idx_counts = read_counts()
    require_launched(idx_counts, ["bm25_compare"], f"{label} index_jsonl",
                     ["jsonl", "corpus", "tokenize", "encode_split"])
    s, t = scorer._split, scorer.transform
    if len(ids) != N_DOCS or ids[1] != "doc1" or scorer.num_docs != N_DOCS:
        fail(f"{label}: index_jsonl returned {len(ids)} ids")
    if scorer._corpus_tokens.n_tokenized != 50:
        fail(f"{label}: index_jsonl tokenized "
             f"{scorer._corpus_tokens.n_tokenized} documents, not the 50 "
             "calibration reads")
    log(f"{label} index_jsonl: {index_s:.3f} s [{card}]; {s.base.n_terms} "
        f"terms, K {s.n_frequent}, {s.dense_impact.dtype} impacts, postings "
        f"{tuple(s.post_doc_ids.shape)}; alpha {t.alpha:.6f} beta "
        f"{t.beta:.6f}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_ids, got_probs = scorer.retrieve_texts(query_texts, k=K_TOP)
    ret_s = time.perf_counter() - t0
    ret_counts = read_counts()
    require_launched(ret_counts, ["impact_matmul_bmax", "row_gather",
                                  "topk"], f"{label} retrieve_texts",
                     ["tokenize", "encode_split"])
    check_ranked(got_ids, got_probs, len(query_texts), K_TOP,
                 f"{label} retrieve_texts")
    log(f"{label} retrieve_texts: {len(query_texts) / ret_s:.1f} q/s "
        f"({len(query_texts)} texts, k={K_TOP}, one call, tokenizing "
        f"included) [{card}]")
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    qs = tokenize_texts(query_texts[:CHECK_QUERIES], **scorer._tok_opts)
    g_ids = compare_retrieve(scorer, cpu, qs, f"{label} retrieve_texts",
                             tie_ulps)
    if not np.array_equal(g_ids, got_ids[:CHECK_QUERIES]):
        fail(f"{label}: retrieve_texts and retrieve disagree")
    return scorer, idx_counts, ret_counts


def phase_text(card) -> list[dict]:
    """The raw-text path at 50k: a generated BEIR corpus.jsonl indexed
    under the constructor's default (hilo, Porter) and under int8 with
    Porter2; retrieve_texts on 8,192 query texts each; then
    add_documents of 2,048 token lists, which must tokenize no document
    beyond the two calibration samples."""
    import tempfile

    import torch

    from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts
    from bayesian_bm25_tpu_torch.models.scorer import _ChainedTokens
    from bayesian_bm25_tpu_torch.utils import convert

    rng = np.random.default_rng(3)
    words = make_words()
    t0 = time.perf_counter()
    texts = make_texts(rng, words, N_DOCS, 150)
    query_texts = make_texts(rng, words, BATCH, 8)
    new_texts = make_texts(rng, words, ADD_DOCS, 150)
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.jsonl"
        write_corpus_jsonl(path, texts)
        log(f"text corpus: {N_DOCS} docs x 150 words over {len(words)} "
            f"words ({len(TEXT_STOPWORDS)} stopwords, suffixes, case "
            f"variants), {BATCH} query texts of 8 words, written as "
            f"corpus.jsonl in {time.perf_counter() - t0:.1f} s; first doc "
            f"'{texts[0][:60]}'")
        del texts
        scorer, c1, c2 = text_config("text ctor default (porter)", {}, True,
                                     1, path, query_texts, card)
        counts += [c1, c2]
        del scorer
        torch.cuda.empty_cache()
        scorer, c1, c2 = text_config(
            "text int8 (snowball)", dict(impact_storage="int8"), "snowball",
            0, path, query_texts, card)
        counts += [c1, c2]

    new_tokens = tokenize_texts(new_texts, stem="snowball")
    t0 = time.perf_counter()
    scorer.add_documents(new_tokens, show_progress=False)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    view = scorer._corpus_tokens
    n_all = N_DOCS + ADD_DOCS
    first = set(np.random.default_rng(42).choice(N_DOCS, 50, replace=False))
    again = np.random.default_rng(42).choice(n_all, 50, replace=False)
    allowed = first | {int(i) for i in again if i < N_DOCS}
    lazy = view._parts[0] if isinstance(view, _ChainedTokens) else None
    if lazy is None or len(view) != n_all or not set(lazy._cache) <= allowed:
        fail("add_documents after index_jsonl tokenized documents beyond "
             "the calibration samples")
    s, t = scorer._split, scorer.transform
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    qs = tokenize_texts(query_texts[:CHECK_QUERIES], stem="snowball")
    compare_retrieve(scorer, cpu, qs, "text int8 after add_documents")
    log(f"text add_documents: {ADD_DOCS} token lists in {add_s:.3f} s "
        f"[{card}]; {lazy.n_tokenized} of {N_DOCS} documents ever "
        f"tokenized (the 50 of index_jsonl's sample and "
        f"{len(allowed) - 50} more of the grown corpus's)")
    del scorer, cpu
    torch.cuda.empty_cache()
    return counts


def calibration_samples(scorer, batch, n_samples, rng):
    """About ``n_samples`` (score, tf, doc-length ratio) triples drawn
    from the nonzero entries of get_scores_batch on the card, with
    labels from a seeded logistic of the scores."""
    scores, tfs, m = [], [], 0
    dl_ratio = scorer.doc_lengths / scorer.avgdl
    for lo in range(0, len(batch), 16):
        qs = batch[lo:lo + 16]
        sc = scorer.get_scores_batch(qs)
        tf = scorer._dense_scores_tfs_device(qs)[1].cpu().numpy()
        nz = sc > 0
        scores.append(sc[nz])
        tfs.append(np.stack([tf[nz], np.broadcast_to(dl_ratio, sc.shape)[nz]]))
        m += int(nz.sum())
        if m >= 2 * n_samples:
            break
    s = np.concatenate(scores)
    tf, dlr = np.concatenate(tfs, axis=1)
    pick = np.sort(rng.choice(len(s), size=min(n_samples, len(s)),
                              replace=False))
    s, tf, dlr = s[pick], tf[pick].astype(np.float64), dlr[pick]
    z = (s - np.percentile(s, 75)) / s.std()
    labels = (rng.uniform(size=len(s)) < 1 / (1 + np.exp(-2.0 * z))
              ).astype(np.float64)
    return s, tf, dlr, labels


def phase_calibration(corpus, batches, card):
    """The bench split int8 scorer, rebuilt: transform.fit in the three
    modes on ~250,000 judged (score, tf, length) triples from the card,
    on the card and on the CPU in turns, online updates, a temporal fit,
    each held against the CPU; then retrieval through the fitted
    prior-free transform on the card against the CPU. Returns (scorer,
    counted retrieval, the judged triples (s, tf, dlr, labels))."""
    import copy

    import torch

    from bayesian_bm25_tpu_torch import (BayesianBM25Scorer,
                                         BayesianProbabilityTransform,
                                         TemporalBayesianTransform)
    from bayesian_bm25_tpu_torch.utils import convert

    scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8",
                                device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    scorer.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    require_native(read_counts(), "bench index (rebuilt)", ["corpus_tokens"])
    log(f"bench index (rebuilt, native corpus CSR): {index_s:.3f} s [{card}]")

    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    s, tf, dlr, y = calibration_samples(scorer, batches[1], CAL_SAMPLES, rng)
    log(f"calibration samples: {len(s)} (score, tf, length ratio) triples "
        f"from get_scores_batch on the card in {time.perf_counter() - t0:.2f}"
        f" s; {int(y.sum())} labelled relevant")
    a0, b0 = scorer.transform.alpha, scorer.transform.beta
    for mode in ("balanced", "prior_aware", "prior_free"):
        kw = dict(tfs=tf, doc_len_ratios=dlr) if mode == "prior_aware" else {}

        def fit(dev):
            tr = BayesianProbabilityTransform(a0, b0, base_rate=0.01,
                                              device=dev)
            tr.fit(s, y, mode=mode, learning_rate=0.05, max_iterations=1000,
                   **kw)
            return tr

        fits, secs = in_turns(fit)
        check_fit(f"fit ({mode})", fits, ("alpha", "beta"))
        g = fits["cuda"]
        log(f"fit {mode} on {len(s)} samples (float64, 1,000 steps at "
            f"most): card {g._fit_iterations} steps, CPU "
            f"{fits['cpu']._fit_iterations}; seconds in turns (CPU, card, "
            f"card, CPU) {secs} -> alpha {g.alpha:.9f} beta {g.beta:.9f} "
            f"[{card}]")

    def update(dev):
        tr = BayesianProbabilityTransform(a0, b0, base_rate=0.01, device=dev)
        for lo in range(0, len(s), 2500):
            tr.update(s[lo:lo + 2500], y[lo:lo + 2500], learning_rate=0.05)
        return tr

    fits, secs = in_turns(update, ("cpu", "cuda"))
    check_fit("update", fits, ("alpha", "beta", "_alpha_avg", "_beta_avg",
                               "_grad_alpha_ema", "_grad_beta_ema"))
    tr = fits["cuda"]
    log(f"update: {tr._n_updates} mini-batches of 2,500, seconds (CPU, "
        f"card) {secs} -> alpha {tr.alpha:.6f} beta {tr.beta:.6f}, "
        f"averaged {tr.averaged_alpha:.6f} {tr.averaged_beta:.6f} [{card}]")

    def temporal(dev):
        tt = TemporalBayesianTransform(a0, b0, base_rate=0.01,
                                       decay_half_life=len(s) / 4,
                                       device=dev)
        tt.fit(s, y, timestamps=np.arange(len(s)), learning_rate=0.05,
               max_iterations=1000)
        return tt

    fits, secs = in_turns(temporal, ("cpu", "cuda"))
    check_fit("temporal fit", fits, ("alpha", "beta"))
    tt = fits["cuda"]
    log(f"temporal fit: seconds (CPU, card) {secs} for {len(s)} samples -> "
        f"alpha {tt.alpha:.6f} beta {tt.beta:.6f} [{card}]")

    # The scorer's own transform, fitted prior-free, then retrieval.
    kept = scorer._transform
    scorer._transform = copy.deepcopy(kept)
    scorer.transform.fit(s, y, mode="prior_free", learning_rate=0.05,
                         max_iterations=1000)
    reset_counts()
    outs = scorer.retrieve_many([batches[0]], k=K_TOP)
    counts = read_counts()
    require_launched(counts, ["impact_matmul_bmax", "row_gather", "topk"],
                     "prior-free retrieve_many", ["encode_split"])
    check_ranked(*outs[0], BATCH, K_TOP, "prior-free retrieve_many")
    cpu = convert.scorer_from_numpy(
        convert.split_index_to_numpy(scorer._split), 1.0, 0.0, device="cpu")
    cpu._transform = convert.transform_from_numpy(
        convert.transform_to_numpy(scorer.transform), "cpu")
    compare_retrieve(scorer, cpu, batches[0][:CHECK_QUERIES],
                     "prior-free retrieve (fitted transform)")
    scorer._transform = kept
    return scorer, counts, (s, tf, dlr, y)


def check_never_run(scorer, corpus, batch, card) -> list[dict]:
    """Three configurations tested only on the CPU before, each on the
    card against the same state on the CPU: the unpacked candidate build
    (split_index.PACKED_BUILD off), the three-operand tf sort
    (tf_from_sign off: postings weights not all positive), and
    calibration scoring through an overflow table."""
    import torch

    from bayesian_bm25_tpu_torch.engine import split_index as sidx
    from bayesian_bm25_tpu_torch.utils import convert

    s, t = scorer._split, scorer.transform
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(s), t.alpha,
                                    t.beta, t.base_rate, device="cpu")
    qs = batch[:CHECK_QUERIES]
    counts = []
    sidx.PACKED_BUILD = False
    try:
        reset_counts()
        scorer.retrieve(batch, k=K_TOP)
        counts.append(read_counts())
        require_launched(counts[-1], ["row_gather", "topk"],
                         "retrieve, unpacked candidate build")
        compare_retrieve(scorer, cpu, qs, "retrieve, unpacked candidate "
                         "build (PACKED_BUILD=False)")
    finally:
        sidx.PACKED_BUILD = True
    s.post_w_positive = cpu._split.post_w_positive = False
    try:
        reset_counts()
        scorer.retrieve(batch, k=K_TOP)
        counts.append(read_counts())
        require_launched(counts[-1], ["row_gather", "topk"],
                         "retrieve, tf co-sorted (tf_from_sign=False)")
        compare_retrieve(scorer, cpu, qs, "retrieve, tf co-sorted "
                         "(tf_from_sign=False)")
    finally:
        s.post_w_positive = cpu._split.post_w_positive = True
    del cpu

    ov = sidx.build_split_index(scorer._index, n_frequent=s.n_frequent,
                                storage="int8", enable_overflow=True,
                                device="cuda")
    if ov.over_term_ids is None:
        fail("an overflow table was asked for and not built")
    gpu = convert.scorer_from_numpy(convert.split_index_to_numpy(ov), 1.0,
                                    0.0, device="cuda", base_rate=0.01)
    cpu = convert.scorer_from_numpy(convert.split_index_to_numpy(ov), 1.0,
                                    0.0, device="cpu", base_rate=0.01)
    for model in (gpu, cpu):
        model._corpus_tokens = corpus
    reset_counts()
    g = gpu._sample_pseudo_query_scores(corpus)
    gpu._calibrate()
    counts.append(read_counts())
    require_launched(counts[-1], ["bm25_compare"],
                     "calibration through the overflow table")
    c = cpu._sample_pseudo_query_scores(corpus)
    cpu._calibrate()
    err = max((float(np.abs(a - b).max()) for a, b in zip(g, c)), default=0)
    if len(g) != len(c) or any(a.shape != b.shape for a, b in zip(g, c)):
        fail("calibration through the overflow table: card and CPU keep "
             "different scores")
    ga, gb = gpu.transform.alpha, gpu.transform.beta
    ca, cb = cpu.transform.alpha, cpu.transform.beta
    if err > 1e-5 * max(float(np.abs(np.concatenate(c)).max()), 1.0) or not (
            np.isclose(ga, ca, rtol=1e-6) and np.isclose(gb, cb, rtol=1e-6)):
        fail(f"calibration through the overflow table: card and CPU differ "
             f"(max |dscore| {err}, alpha {ga} vs {ca}, beta {gb} vs {cb})")
    log(f"calibration through the overflow table "
        f"{tuple(ov.over_term_ids.shape)} (tail "
        f"{tuple(ov.tail_term_ids.shape)}): card vs CPU on {len(g)} pseudo-queries: max |dscore| {err}, "
        f"alpha {ga:.9f} vs {ca:.9f}, beta {gb:.9f} vs {cb:.9f} [{card}]")
    del gpu, cpu, ov
    torch.cuda.empty_cache()
    return counts


def phase_explain(bench, cpu, batch, card) -> dict:
    """retrieve(explain=True) on one batch, counted: ids and
    probabilities bit-equal to retrieve, a trace exactly where the score
    is positive, the first 256 queries' traces against the CPU; explain
    and plain retrieve timed in turns."""
    import torch

    from bayesian_bm25_tpu_torch import RetrievalResult

    reset_counts()
    res = bench.retrieve(batch, k=K_TOP, explain=True)
    counts = read_counts()
    require_launched(counts, ["impact_matmul_bmax", "row_gather", "topk"],
                     "retrieve(explain=True)", ["encode_split"])
    ids, probs = bench.retrieve(batch, k=K_TOP)
    if not (isinstance(res, RetrievalResult)
            and np.array_equal(res.doc_ids, ids)
            and np.array_equal(res.probabilities, probs)):
        fail("retrieve(explain=True): ids or probabilities differ from "
             "retrieve's")
    scores = bench._retrieve_launch(batch, K_TOP, False, None)[3]
    has = scores.cpu().numpy() > 0
    got = np.array([[tr is not None for tr in row]
                    for row in res.explanations])
    if got.shape != (len(batch), K_TOP) or not np.array_equal(got, has):
        fail("retrieve(explain=True): traces are not exactly where the "
             "score is positive")
    n = PLAIN_ROWS
    c_res = cpu.retrieve(batch[:n], k=K_TOP, explain=True)
    worst = 0.0
    for q in range(n):
        for r in range(K_TOP):
            a, b = res.explanations[q][r], c_res.explanations[q][r]
            if (a is None) != (b is None):
                fail(f"explain: query {q} rank {r} traced on one side only")
            if a is None:
                continue
            if res.doc_ids[q, r] != c_res.doc_ids[q, r]:
                if a.raw_score != b.raw_score:
                    fail(f"explain: ids differ outside ties (query {q})")
                continue
            for f in ("raw_score", "tf", "doc_len_ratio", "likelihood",
                      "tf_prior", "norm_prior", "composite_prior",
                      "logit_likelihood", "logit_prior", "posterior"):
                x, z = getattr(a, f), getattr(b, f)
                err = abs(x - z) / max(abs(z), 1e-300)
                worst = max(worst, err)
                if err > 1e-6:
                    fail(f"explain: {f} {x} on the card against {z} on "
                         f"the CPU (query {q}, rank {r})")
    times = {"plain": [], "explain": []}
    for kind in ("plain", "explain", "explain", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.retrieve(batch, k=K_TOP, explain=kind == "explain")
        times[kind].append(round(time.perf_counter() - t0, 4))
    log(f"retrieve(explain=True): {int(has.sum())} traces of "
        f"{has.size} ranks ({len(batch)} x {K_TOP}), ids and probabilities "
        f"equal to retrieve; {n} queries against the CPU, max rel. field "
        f"error {worst:.3g}; seconds in turns (plain, explain, explain, "
        f"plain): plain {times['plain']}, explain {times['explain']} "
        f"[{card}]")
    return counts


def phase_dense_fusion(bench, batch, card) -> None:
    """The fusion algebra at dense width on the card: get_probabilities
    of 2,048 queries x 50,000 documents beside a seeded cosine matrix,
    each operation timed, its first 64 rows against the CPU."""
    import torch

    from bayesian_bm25_tpu_torch.ops import fusion as F

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qs = batch[:DENSE_QUERIES]
    probs = bench._dense_probs_device(qs).double()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    cos = torch.rand(probs.shape, generator=gen, dtype=torch.float64,
                     device="cuda") * 2.0 - 1.0
    stack = torch.stack([probs, F.cosine_to_probability(cos)], dim=-1)
    w = torch.tensor([0.6, 0.4], dtype=torch.float64, device="cuda")
    ops = {"log_odds_conjunction": lambda x, c: F.log_odds_conjunction(x),
           "weighted": lambda x, c: F.log_odds_conjunction(x, weights=w),
           "max_logit": lambda x, c: F.log_odds_conjunction(x, max_logit=3.0)}
    for g in ("relu", "swish", "gelu", "softplus"):
        ops[f"gating {g}"] = (lambda g: lambda x, c: F.log_odds_conjunction(
            x, gating=g, gating_beta=1.5))(g)
    ops["balanced_log_odds_fusion"] = lambda x, c: F.balanced_log_odds_fusion(
        x[..., 0], c)
    ops["prob_and"] = lambda x, c: F.prob_and(x)
    ops["prob_or"] = lambda x, c: F.prob_or(x)
    rows = 64
    head = stack[:rows].cpu(), cos[:rows].cpu()
    # Bytes each call must move: the (nq, D, 2) stack read once (the
    # balanced fusion: both (nq, D) inputs), the (nq, D) result written.
    n_bytes = probs.numel() * 8 * 3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    lines = []
    for name, op in ops.items():
        out = op(stack, cos)
        if out.shape != probs.shape or not bool(torch.isfinite(out).all()):
            fail(f"dense fusion {name}: bad output {tuple(out.shape)}")
        # The balanced fusion normalizes over the whole array: both
        # sides compute it on the same 64 rows.
        card_head = (op(stack[:rows], cos[:rows]) if name.startswith(
            "balanced") else out[:rows]).cpu()
        err = float((card_head - op(*head)).abs().max())
        if err > 1e-12:
            fail(f"dense fusion {name}: card and CPU differ by {err}")
        ms = cuda_ms(lambda: op(stack, cos), reps=5)
        lines.append(f"{name} {ms:.4f} ms ({t_bytes / ms:.3f} of the bytes "
                     f"bound, max |d| {err:.3g})")
    peak = torch.cuda.max_memory_allocated()
    log(f"dense fusion on ({', '.join(map(str, stack.shape))}) float64, "
        f"bytes bound {t_bytes:.4f} ms at 3.35 TB/s: {'; '.join(lines)}; "
        f"peak device memory {peak / 2**30:.3f} GiB [{card}]")
    del probs, cos, stack, head
    torch.cuda.empty_cache()


def phase_weights(bench, batch, card) -> dict:
    """The three fusion weight models fitted on 81,920 rows (the top 10
    of one batch: the card's BM25 probability and a seeded dense
    probability; seeded logistic labels; 8 seeded features a query) on
    the card and on the CPU in turns, then mini-batch updates and prune,
    each held against the CPU. Returns the card's models by name."""
    from bayesian_bm25_tpu_torch import (AttentionLogOddsWeights,
                                         LearnableLogOddsWeights,
                                         MultiHeadAttentionLogOddsWeights)

    ids, bm25 = bench.retrieve_many([batch], k=K_TOP)[0]
    rng = np.random.default_rng(17)
    n = bm25.size
    dense = rng.uniform(0.02, 0.98, n)
    lg = np.log(np.clip(bm25.ravel(), 1e-6, 1 - 1e-6) / (1 - np.clip(
        bm25.ravel(), 1e-6, 1 - 1e-6)))
    z = 1.5 * lg + np.log(dense / (1 - dense)) + 1.0
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    probs = np.stack([bm25.ravel(), dense], axis=1)
    qids = np.repeat(np.arange(len(batch)), K_TOP)
    qf = rng.normal(0.0, 1.0, (len(batch), 8))[qids]
    fit_kw = dict(learning_rate=0.5, max_iterations=300, tolerance=1e-6)
    models = {
        "learnable": (lambda dev: LearnableLogOddsWeights(2, device=dev),
                      lambda m: m.fit(probs, labels, **fit_kw),
                      lambda m, sl: m.update(probs[sl], labels[sl]),
                      ("_logits", "_weights_avg", "_grad_logits_ema")),
        "attention": (lambda dev: AttentionLogOddsWeights(
            2, 8, normalize=True, device=dev),
            lambda m: m.fit(probs, labels, qf, query_ids=qids, **fit_kw),
            lambda m, sl: m.update(probs[sl], labels[sl], qf[sl]),
            ("_W", "_b", "_W_avg", "_b_avg", "_grad_W_ema")),
        "4-head attention": (lambda dev: MultiHeadAttentionLogOddsWeights(
            4, 2, 8, normalize=True, device=dev),
            lambda m: m.fit(probs, labels, qf, query_ids=qids, **fit_kw),
            lambda m, sl: m.update(probs[sl], labels[sl], qf[sl]), None),
    }
    fitted = {}
    for name, (make, fit, update, fields) in models.items():
        def run(dev):
            m = make(dev)
            fit(m)
            return m

        fits, secs = in_turns(run)
        fitted[name] = fits["cuda"]
        heads = ([(fits["cuda"], fits["cpu"])] if fields else
                 list(zip(fits["cuda"].heads, fits["cpu"].heads)))
        names = fields or ("_W", "_b")
        for g, c in heads:
            check_fit(f"{name} fit", {"cuda": g, "cpu": c}, names)
        for lo in range(0, n, 2048):
            for m in fits.values():
                update(m, slice(lo, lo + 2048))
        for g, c in heads:
            check_fit(f"{name} update", {"cuda": g, "cpu": c}, names)
        ub = np.clip(probs + 0.05, 0.0, 0.99)
        args = (probs,) if name == "learnable" else (probs, qf)
        if name != "learnable":
            # A threshold at the median fused bound: about half survive.
            thr = float(np.median(fits["cuda"].compute_upper_bounds(ub, qf)))
            (gs, gp), (cs, cp) = (m.prune(probs, qf, thr, ub)
                                  for m in (fits["cuda"], fits["cpu"]))
            if not (np.array_equal(gs, cs) and np.allclose(gp, cp,
                                                           rtol=1e-8)):
                fail(f"{name} prune: card and CPU differ")
            pruned = f", prune at {thr:.6f} keeps {len(gs)} of {n}"
        else:
            pruned = ""
        out = [fits[d](*args) for d in ("cuda", "cpu")]
        if not np.allclose(out[0], out[1], rtol=1e-8, atol=0):
            fail(f"{name}: fused probabilities differ between card and CPU")
        g = heads[0][0]
        log(f"{name} on {n} rows: fit {g._fit_iterations} steps card, "
            f"{heads[0][1]._fit_iterations} CPU; seconds in turns (CPU, "
            f"card, card, CPU) {secs}; {n // 2048 + (n % 2048 > 0)} updates "
            f"of 2,048 equal{pruned} [{card}]")
    return fitted


def phase_calibrators(bench, samples, card) -> dict:
    """Platt and isotonic calibration and the metrics of the scorer's
    probabilities on phase 14's judged triples, card against CPU.
    Returns the card's calibrators by name."""
    import bayesian_bm25_tpu_torch as tbb

    s, tf, dlr, y = samples

    def platt(dev):
        cal = tbb.PlattCalibrator(device=dev)
        cal.fit(s, y, learning_rate=0.1, max_iterations=1000)
        return cal

    def isotonic(dev):
        cal = tbb.IsotonicCalibrator(device=dev)
        cal.fit(s, y)
        return cal

    fits, secs = in_turns(platt, ("cpu", "cuda"))
    check_fit("Platt fit", fits, ("a", "b"))
    iso, secs_iso = in_turns(isotonic, ("cpu", "cuda"))
    grid = np.linspace(s.min() - 1.0, s.max() + 1.0, 4096)
    for what, cal in (("Platt", fits), ("isotonic", iso)):
        err = float(np.abs(cal["cuda"](grid) - cal["cpu"](grid)).max())
        if err > 1e-12:
            fail(f"{what} calibrate: card and CPU differ by {err}")
    p = bench.transform.score_to_probability(s, tf, dlr)
    report = {d: tbb.calibration_report(p, y, device=d)
              for d in ("cuda", "cpu")}
    g, c = report["cuda"], report["cpu"]
    d_ece = abs(g.ece - c.ece)
    if d_ece > 1e-12:
        fail(f"ECE: card {g.ece} against CPU {c.ece}")
    for d in ("cuda", "cpu"):
        if abs(tbb.expected_calibration_error(p, y, device=d) - g.ece) > 1e-12:
            fail("ECE differs from the report's")
    if not (np.isclose(g.brier, c.brier, rtol=1e-12)
            and np.isclose(g.logloss, c.logloss, rtol=1e-12)
            and [b[2] for b in g.reliability] == [b[2] for b in c.reliability]
            and np.allclose(g.reliability, c.reliability, rtol=1e-12)
            and np.allclose(tbb.reliability_diagram(p, y, device="cuda"),
                            g.reliability, rtol=1e-12)
            and np.isclose(tbb.brier_score(p, y, device="cuda"), g.brier,
                           rtol=1e-12)
            and np.isclose(tbb.log_loss(p, y, device="cuda"), g.logloss,
                           rtol=1e-12)):
        fail("calibration metrics: card and CPU differ")
    log(f"calibrators on {len(s)} judged scores: Platt a {fits['cuda'].a:.9f}"
        f" b {fits['cuda'].b:.9f}, {fits['cuda']._fit_iterations} steps "
        f"(CPU {fits['cpu']._fit_iterations}), seconds (CPU, card) {secs}; "
        f"isotonic {iso['cuda']._x.shape[0]} blocks, seconds (CPU, card) "
        f"{secs_iso}; scorer's probabilities: ECE {g.ece:.9f} (|d| "
        f"{d_ece:.3g}), Brier {g.brier:.9f}, log loss {g.logloss:.9f} "
        f"[{card}]")
    return {"Platt": fits["cuda"], "isotonic": iso["cuda"]}


def phase_block_max(bench, cpu, batch, card) -> None:
    """BlockMaxIndex.from_bm25_index on the bench index (blocks of 128)
    bit-equal to np.maximum.at over the host copy; prune masks of 256
    queries at threshold 0.5 equal to the CPU's; the documents at or
    above 0.5 that lie in pruned blocks, counted."""
    import torch

    from bayesian_bm25_tpu_torch import BlockMaxIndex

    idx = bench._index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bmi = BlockMaxIndex.from_bm25_index(idx, block_size=128, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tids, w = idx.term_ids_host, idx.weights_host
    D, n_blocks = idx.n_docs, bmi.n_blocks
    rows = np.arange(tids.shape[0])
    valid = (tids >= 0) & (rows < D)[:, None]
    bm = np.zeros((idx.n_terms, n_blocks), dtype=np.float64)
    t0 = time.perf_counter()
    np.maximum.at(bm, (tids[valid], np.broadcast_to(
        (rows // 128)[:, None], tids.shape)[valid]),
        w[valid].astype(np.float64))
    host_s = time.perf_counter() - t0
    got = bmi.block_maxes
    if got.dtype != np.float64 or not np.array_equal(got, bm):
        fail("BlockMaxIndex.from_bm25_index differs from np.maximum.at")
    c_bmi = BlockMaxIndex.from_bm25_index(cpu._index, 128, device="cpu")
    if not np.array_equal(c_bmi.block_maxes, bm):
        fail("BlockMaxIndex on the CPU differs from np.maximum.at")
    qs = batch[:PLAIN_ROWS]
    t = bench.transform
    c_t = cpu.transform
    vocab = idx.vocab
    masks = []
    for q in qs:
        terms = [vocab[tok] for tok in q if tok in vocab]
        m = bmi.prune_mask(terms, t, THRESHOLD)
        if not np.array_equal(m, c_bmi.prune_mask(terms, c_t, THRESHOLD)):
            fail("prune_mask: card and CPU differ")
        masks.append(m)
    masks = np.array(masks)
    dense = bench.get_probabilities_batch(qs)
    keep_doc = np.repeat(masks, 128, axis=1)[:, :D]
    missed = int(((dense >= THRESHOLD) & ~keep_doc).sum())
    log(f"BlockMaxIndex: {tuple(got.shape)} float64 ({got.nbytes / 1e6:.1f}"
        f" MB) from the (D_pad, T) = {tuple(tids.shape)} table in "
        f"{build_s:.4f} s on the card, equal to np.maximum.at "
        f"({host_s:.3f} s); prune masks of {len(qs)} queries at "
        f"{THRESHOLD} equal to the CPU's, keeping {masks.mean():.4f} of "
        f"the blocks; documents with posterior >= {THRESHOLD} in pruned "
        f"blocks: {missed} of {int((dense >= THRESHOLD).sum())} [{card}]")


def phase_encoder_ab(scorer, batches, card) -> None:
    """retrieve_many on the bench split int8 scorer, unfused and fused,
    with the host encoder in turns: Python twin, native, native, Python
    (median of 3 runs each), and the host encode ms per 8,192-query
    batch of each turn."""
    for fused in (False, True):
        route = "fused" if fused else "unfused"
        ab = {"python": [], "native": []}
        for enc in ("python", "native", "native", "python"):
            py = enc == "python"
            with python_encoder() if py else contextlib.nullcontext():
                qps, runs = retrieve_many_qps(scorer, batches, fused)
            ms = encode_ms(scorer._split, batches, py)
            ab[enc].append((qps, ms))
            log(f"encoder A/B {route} {enc}: {qps:.1f} q/s median of 3 runs "
                f"{[round(r, 1) for r in runs]}; host encode {ms:.3f} ms per "
                f"{BATCH}-query batch ({len(batches)} x {BATCH} queries, "
                f"k={K_TOP}) [{card}]")
        log(f"encoder A/B {route}: Python "
            f"{[round(q, 1) for q, _ in ab['python']]} q/s, native "
            f"{[round(q, 1) for q, _ in ab['native']]} q/s; encode ms Python "
            f"{[round(m, 3) for _, m in ab['python']]}, native "
            f"{[round(m, 3) for _, m in ab['native']]} [{card}]")


# Dense vectors (phase 17): the width of the common MiniLM sentence
# encoders, one cluster per IVF cell of the 50k corpus, and the
# harness's VPT protocol (benchmarks/hybrid_beir.py:435-509): a sample
# of each query's R nearest dense neighbours, an eval set that adds its
# BM25 top R.
VEC_DIM, VEC_CLUSTERS, VEC_NOISE = 384, 224, 0.03
VPT_QUERIES, VPT_R = 256, 1000
DIAG_QUERIES = 256
N_VEC_1M, VEC_CHECK_1M = 1_000_000, 32
SCORE_TOL = 1e-6              # one float32 cosine, summed in another order


def make_vectors(seed, n, centers) -> np.ndarray:
    """``n`` float32 vectors, each a unit-sphere cluster centre plus
    Gaussian noise, drawn on the card from ``seed`` and returned on the
    host."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    c = torch.from_numpy(centers).to("cuda")
    labels = torch.randint(0, len(centers), (n,), generator=gen,
                           device="cuda")
    out = torch.randn((n, centers.shape[1]), generator=gen, device="cuda")
    out.mul_(VEC_NOISE).add_(c[labels])
    return out.cpu().numpy()


def unit_centers(rng, n_clusters=VEC_CLUSTERS, dim=VEC_DIM):
    c = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def compare_ranked(g_ids, g_s, c_ids, c_s, what: str) -> tuple[int, float]:
    """Card against CPU search results: -inf at the same ranks, finite
    scores within SCORE_TOL, ids equal except where the CPU's score lies
    within SCORE_TOL of another score in the row (a tie either side may
    order first; the tied ids must then be the same set). Returns (tie
    swaps, max |dscore|)."""
    g_ids, g_s, c_ids, c_s = (np.atleast_2d(a) for a in (g_ids, g_s, c_ids,
                                                         c_s))
    if g_ids.shape != c_ids.shape:
        fail(f"{what}: shapes {g_ids.shape} and {c_ids.shape}")
    if not np.array_equal(np.isinf(g_s), np.isinf(c_s)):
        fail(f"{what}: -inf at other ranks on the card and the CPU")
    fin = np.isfinite(c_s)
    err = float(np.abs(g_s[fin] - c_s[fin]).max()) if fin.any() else 0.0
    if err > SCORE_TOL:
        fail(f"{what}: scores differ by {err} > {SCORE_TOL}")
    swaps = 0
    for r in np.nonzero((g_ids != c_ids).any(axis=1))[0]:
        with np.errstate(invalid="ignore"):  # -inf - -inf
            d = np.abs(c_s[r][:, None] - c_s[r][None, :])
        np.fill_diagonal(d, np.inf)
        tied = fin[r] & (d.min(axis=1) <= SCORE_TOL)
        if (not np.array_equal(g_ids[r][~tied], c_ids[r][~tied])
                or sorted(g_ids[r][tied]) != sorted(c_ids[r][tied])):
            fail(f"{what}: ids differ outside ties (query {r})")
        swaps += int((g_ids[r] != c_ids[r]).sum())
    return swaps, err


def vpt_guidance(lex_probs, lex_active, density_prior):
    """The harness's blended sample guidance (hybrid_beir.py:120-138):
    silent BM25 evidence neutral, active evidence floored at 0.5, mixed
    with the IVF density prior in logit space."""
    def logit_clip(p, m=10.0):
        p = np.clip(np.asarray(p, dtype=np.float64), 1e-10, 1 - 1e-10)
        return np.clip(np.log(p / (1 - p)), -m, m)

    g = np.full(len(lex_probs), 0.5)
    g[lex_active] = np.maximum(lex_probs[lex_active], 0.5)
    mix = float(np.clip(0.35 + 0.5 * float(np.mean(lex_active)), 0.35, 0.85))
    blended = mix * logit_clip(g) + (1.0 - mix) * logit_clip(density_prior)
    return 1.0 / (1.0 + np.exp(-np.clip(blended, -10.0, 10.0)))


def vpt_inputs(bench, ivf, queries, token_queries):
    """Per query: (eval distances over the union of the dense top R and
    the BM25 top R, sample distances of the dense top R, the sample's
    BM25 probabilities and activity, the union's BM25 probabilities and
    cosines). The dense top R comes from an exhaustive search_batch."""
    s_ids, s_sims = ivf.search_batch(queries, VPT_R, nprobe=ivf.n_cells)
    scores = bench.get_scores_batch(token_queries)
    probs = bench.get_probabilities_batch(token_queries)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    out = []
    for i in range(len(queries)):
        bm_top = np.argsort(-scores[i], kind="stable")[:VPT_R]
        union = np.union1d(s_ids[i], bm_top)
        u_sim = (ivf.embeddings[union] @ qn[i]).astype(np.float64)
        out.append(dict(u_dist=1.0 - u_sim, s_dist=1.0 - s_sims[i],
                        s_lex=probs[i][s_ids[i]],
                        s_active=scores[i][s_ids[i]] > 0,
                        s_cells=ivf.assignments[s_ids[i]],
                        u_probs=probs[i][union], u_sim=u_sim))
    return out


def run_vpt(ivf, inputs, dev):
    """The VPT protocol on ``dev`` for every query: auto with the
    blended guidance, kde with sharpened BM25 weights at four bandwidth
    factors, gmm with the IVF density prior, and the balanced fusion of
    the BM25 probabilities with the cosines. Returns one list of arrays
    per query."""
    from bayesian_bm25_tpu_torch import (VectorProbabilityTransform,
                                         balanced_log_odds_fusion,
                                         ivf_density_prior)

    vpt = VectorProbabilityTransform.fit_background(
        ivf.background_distances, device=dev)
    out = []
    for x in inputs:
        prior = ivf_density_prior(ivf.cell_populations[x["s_cells"]],
                                  ivf.avg_population, device=dev)
        guide = vpt_guidance(x["s_lex"], x["s_active"], prior)
        row = [vpt.calibrate_with_sample(x["u_dist"], x["s_dist"],
                                         weights=guide)]
        w_bw = vpt._sharpen_weights(np.where(x["s_active"], x["s_lex"], 0.0))
        for bw in (0.2, 0.5, 1.0, 2.0):
            row.append(vpt.calibrate_with_sample(
                x["u_dist"], x["s_dist"], weights=w_bw, method="kde",
                bandwidth_factor=bw))
        row.append(vpt.calibrate_with_sample(x["u_dist"], x["s_dist"],
                                             weights=prior, method="gmm"))
        row.append(balanced_log_odds_fusion(
            np.clip(x["u_probs"], 1e-10, 1 - 1e-10), x["u_sim"], 0.5,
            device=dev))
        out.append(row)
    return out


def phase_vectors(bench, token_batch, card) -> list[dict]:
    """Phase 17: SimpleIVF on 50,000 x 384 seeded embeddings, built on
    the card and the CPU; search_batch of 8,192 queries, counted, against
    the CPU on the card's state; search, diagnostics and the gate for
    256 queries against the CPU; the VPT protocol for 256 queries on the
    card and the CPU in turns; then 1,000,000 x 384: build, chunked
    search_batch, peak memory, 32 queries against a CPU search."""
    import torch

    from bayesian_bm25_tpu_torch.engine.ivf import SimpleIVF
    from bayesian_bm25_tpu_torch.utils import convert
    from bayesian_bm25_tpu_torch.utils.diagnostics import (
        build_ivf_search_diagnostics, separability_gate)

    centers = unit_centers(np.random.default_rng(21))
    t0 = time.perf_counter()
    emb = make_vectors(21, N_DOCS, centers)
    queries = make_vectors(23, BATCH, centers)
    log(f"vectors: {emb.shape} float32 ({VEC_CLUSTERS} clusters on the unit"
        f" sphere, noise {VEC_NOISE} a dimension) and {len(queries)} "
        f"queries, drawn on the card, in {time.perf_counter() - t0:.2f} s")
    builds, build_s = in_turns(lambda dev: SimpleIVF.build(emb, device=dev),
                               ("cpu", "cuda"))
    ivf, c_built = builds["cuda"], builds["cpu"]
    agree = float(np.mean(ivf.assignments == c_built.assignments))
    c_err = float(np.abs(ivf.centroids - c_built.centroids).max())
    if agree < 0.99 or ivf.n_cells != VEC_CLUSTERS:
        fail(f"IVF build: card and CPU assignments agree on {agree}")
    log(f"IVF build 50k: {ivf.n_cells} cells, nprobe {ivf.default_nprobe}, "
        f"seconds (CPU, card) {build_s}; assignments agree on {agree:.6f}, "
        f"centroids max |d| {c_err:.3g} [{card}]")
    del c_built
    cpu = convert.ivf_from_numpy(convert.ivf_to_numpy(ivf), "cpu")

    reset_counts()
    g_ids, g_s = ivf.search_batch(queries, K_TOP)
    counts = read_counts()
    log(f"IVF search_batch launches: {counts}")
    for name in ("block_max", "topk"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by IVF search_batch")
    if g_ids.shape != (BATCH, K_TOP) or not (
            (g_ids >= 0) & (g_ids < N_DOCS)).all():
        fail("IVF search_batch: bad ids")
    t0 = time.perf_counter()
    c_ids, c_s = cpu.search_batch(queries, K_TOP)
    cpu_s = time.perf_counter() - t0
    swaps, err = compare_ranked(g_ids, g_s, c_ids, c_s, "IVF search_batch")
    log(f"IVF search_batch 50k, {BATCH} queries: card vs CPU ids equal "
        f"({swaps} tie swaps), max |dscore| {err:.3g}")
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf.search_batch(queries, K_TOP)
        runs.append(BATCH / (time.perf_counter() - t0))
    log(f"IVF search_batch 50k: {sorted(runs)[1]:.1f} q/s median of 3 "
        f"{[round(r, 1) for r in runs]} ({BATCH} queries, k={K_TOP}, nprobe "
        f"{ivf.default_nprobe}); CPU {BATCH / cpu_s:.1f} q/s [{card}]")

    gates, t_search, swaps = [], {"cuda": 0.0, "cpu": 0.0}, 0
    for q in queries[:DIAG_QUERIES]:
        pair = []
        for dev, index in (("cuda", ivf), ("cpu", cpu)):
            t0 = time.perf_counter()
            r = index.search(q, 50)
            t_search[dev] += time.perf_counter() - t0
            pair.append((r, separability_gate(build_ivf_search_diagnostics(
                r.scores, r.cell_ids, r, index))))
        (rg, gg), (rc, gc) = pair
        if not np.array_equal(rg.candidate_indices, rc.candidate_indices):
            fail("IVF search: card and CPU probe other cells")
        swaps += compare_ranked(rg.indices, rg.scores, rc.indices, rc.scores,
                                "IVF search")[0]
        gates.append((gg, gc))
    gates = np.array(gates)
    g_err = float(np.abs(gates[:, 0] - gates[:, 1]).max())
    if g_err > 1e-5:
        fail(f"separability gate: card and CPU differ by {g_err}")
    log(f"IVF search + diagnostics + gate, {DIAG_QUERIES} queries: "
        f"seconds card {t_search['cuda']:.3f}, CPU {t_search['cpu']:.3f}; "
        f"ids equal ({swaps} tie swaps); gates mean "
        f"{gates[:, 0].mean():.6f}, max |d| {g_err:.3g} [{card}]")

    inputs = vpt_inputs(bench, ivf, queries[:VPT_QUERIES],
                        token_batch[:VPT_QUERIES])
    sizes = [len(x["u_dist"]) for x in inputs]
    res, secs = in_turns(lambda dev: run_vpt(ivf, inputs, dev))
    worst = 0.0
    for g_row, c_row in zip(res["cuda"], res["cpu"]):
        for a, b in zip(g_row, c_row):
            if a.shape != b.shape or not np.isfinite(a).all():
                fail("VPT: bad output on the card")
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-300))))
    if worst > 1e-9:
        fail(f"VPT: card and CPU differ by rtol {worst} > 1e-9")
    log(f"VPT protocol, {VPT_QUERIES} queries (sample R={VPT_R}, eval "
        f"union {min(sizes)}-{max(sizes)}): auto, kde x 4 bandwidths, gmm "
        f"with the IVF density prior, balanced fusion; seconds in turns "
        f"(CPU, card, card, CPU) {secs}; max rel. |d| {worst:.3g} [{card}]")
    del cpu, ivf, builds, inputs, res
    torch.cuda.empty_cache()

    # The 1M-vector configuration: default 1,000 cells, nprobe 32.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emb = make_vectors(22, N_VEC_1M, centers)
    log(f"vectors 1M: {emb.shape} float32 ({emb.nbytes / 1e9:.2f} GB), "
        f"drawn on the card, in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = SimpleIVF.build(emb, device="cuda")
    torch.cuda.synchronize()
    build_1m = time.perf_counter() - t0
    del emb
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_ids, g_s = ivf.search_batch(queries, K_TOP)
    first_s = time.perf_counter() - t0
    counts_1m = read_counts()
    for name in ("block_max", "topk"):
        if counts_1m[name] <= 0:
            fail(f"kernel {name} was not launched by IVF search_batch at 1M")
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ivf.search_batch(queries, K_TOP)
        runs.append(BATCH / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    cpu = convert.ivf_from_numpy(convert.ivf_to_numpy(ivf), "cpu")
    rows = [cpu.search(q, K_TOP) for q in queries[:VEC_CHECK_1M]]
    swaps, err = compare_ranked(
        g_ids[:VEC_CHECK_1M], g_s[:VEC_CHECK_1M],
        np.stack([r.indices for r in rows]),
        np.stack([r.scores for r in rows]), "IVF 1M")
    log(f"IVF 1M: search_batch on the card vs search on the CPU, "
        f"{VEC_CHECK_1M} queries: ids equal ({swaps} tie swaps), max "
        f"|dscore| {err:.3g}")
    log(f"IVF 1M: {ivf.n_cells} cells, nprobe {ivf.default_nprobe}, chunks "
        f"of {ivf._chunk_rows()} queries; build {build_1m:.3f} s; "
        f"search_batch {BATCH} queries: first {first_s:.3f} s, "
        f"{sorted(runs)[1]:.1f} q/s median of 3 "
        f"{[round(r, 1) for r in runs]}; launches {counts_1m}; peak device "
        f"memory {peak / 2**30:.3f} GiB [{card}]")
    del ivf, cpu
    torch.cuda.empty_cache()
    return [counts, counts_1m]


# Fields and checkpoints (phase 18).
MF_DENSE, MF_RETRIEVE, MF_CHECK = 2048, 256, 64


def mf_on_cpu(mf):
    """A CPU MultiFieldScorer holding the same state as ``mf``: each
    field's index, transform, tokenizer options and tombstones."""
    from bayesian_bm25_tpu_torch import MultiFieldScorer
    from bayesian_bm25_tpu_torch.utils import convert

    out = MultiFieldScorer(mf.fields, mf.field_weights, device="cpu")
    for f, sc in mf.scorers.items():
        t = sc.transform
        state = (convert.split_index_to_numpy(sc._split) if sc._split
                 is not None else convert.index_to_numpy(sc._index))
        c = convert.scorer_from_numpy(state, t.alpha, t.beta, t.base_rate,
                                      device="cpu")
        c._tok_opts = dict(sc._tok_opts)
        c._deleted = None if sc._deleted is None else sc._deleted.copy()
        out._scorers[f] = c
    out._num_docs = mf.num_docs
    return out


def compare_mf(mf, cpu, qs, what: str, n_retrieve: int = CHECK_QUERIES
               ) -> None:
    """Fused probabilities within PROB_TOL of the CPU's; retrieve's ids
    on the first ``n_retrieve`` queries equal except between documents
    whose fused probabilities lie within PROB_TOL."""
    g, c = mf.get_probabilities_batch(qs), cpu.get_probabilities_batch(qs)
    err = float(np.abs(g - c).max())
    if g.shape != (len(qs), mf.num_docs) or err > PROB_TOL:
        fail(f"{what}: fused probabilities differ by {err}")
    swaps = 0
    for q, row in zip(qs[:n_retrieve], g):
        (gi, gp), (ci, cp) = mf.retrieve(q, k=K_TOP), cpu.retrieve(q, k=K_TOP)
        for a, b in zip(gi[gi != ci], ci[gi != ci]):
            if abs(row[a] - row[b]) > 2 * PROB_TOL:
                fail(f"{what}: retrieve ids differ outside ties")
            swaps += 1
        if float(np.abs(gp - cp).max()) > PROB_TOL:
            fail(f"{what}: retrieve probabilities differ")
    log(f"{what}: card vs CPU on {len(qs)} queries: fused max |dprob| "
        f"{err:.3g}; retrieve ids equal on {n_retrieve} ({swaps} tie "
        f"swaps)")


def phase_fields(card) -> list[dict]:
    """Phase 18, first half: MultiFieldScorer(["title", "body"]) on phase
    13's generated corpus with an 8-word title a document, through
    index_jsonl, counted; get_probabilities_batch of 2,048 queries and
    retrieve of 256, counted, against a CPU MultiFieldScorer on the same
    state; 1% of the documents deleted and restored; add_documents of
    2,048."""
    import tempfile

    import torch

    from bayesian_bm25_tpu_torch import MultiFieldScorer
    from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts

    rng = np.random.default_rng(3)   # phase 13's bodies
    words = make_words()
    bodies = make_texts(rng, words, N_DOCS, 150)
    trng = np.random.default_rng(31)
    titles = make_texts(trng, words, N_DOCS, 8)
    query_texts = make_texts(trng, words, MF_DENSE, 8)
    counts = []
    mf = MultiFieldScorer(["title", "body"], base_rate=0.01, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.jsonl"
        with open(path, "w") as f:
            for i, (title, body) in enumerate(zip(titles, bodies)):
                f.write(json.dumps({"_id": f"doc{i}", "title": title,
                                    "text": body}) + "\n")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = mf.index_jsonl(path)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
    c = read_counts()
    require_launched(c, ["bm25_compare"], "multi-field index_jsonl",
                     ["jsonl", "corpus", "tokenize", "encode_split"])
    counts.append(c)
    if len(ids) != N_DOCS or mf.num_docs != N_DOCS:
        fail(f"multi-field index_jsonl returned {len(ids)} ids")
    qs = tokenize_texts(query_texts, **mf.scorers["body"]._tok_opts)
    shapes = {f: tuple(sc._split.dense_impact.shape) if sc._split is not None
              else None for f, sc in mf.scorers.items()}
    log(f"multi-field index_jsonl: {index_s:.3f} s [{card}]; "
        f"{N_DOCS} docs, titles of 8 words, bodies of 150; split impacts "
        f"{shapes}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = mf.get_probabilities_batch(qs)
    dense_s = time.perf_counter() - t0
    c = read_counts()
    require_launched(c, ["bm25_compare"],
                     "multi-field get_probabilities_batch",
                     ["encode_split"])
    counts.append(c)
    if dense.shape != (MF_DENSE, N_DOCS) or not (
            (dense > 0) & (dense < 1)).all():
        fail("multi-field get_probabilities_batch: bad output")
    reset_counts()
    t0 = time.perf_counter()
    for q in qs[:MF_RETRIEVE]:
        mf.retrieve(q, k=K_TOP)
    ret_s = time.perf_counter() - t0
    c = read_counts()
    require_launched(c, ["bm25_compare"], "multi-field retrieve",
                     ["encode_split"])
    counts.append(c)
    cpu = mf_on_cpu(mf)
    compare_mf(mf, cpu, qs[:MF_CHECK], "multi-field")
    log(f"multi-field get_probabilities_batch: {MF_DENSE / dense_s:.1f} q/s "
        f"({MF_DENSE} x {N_DOCS}, two fields fused on the card); retrieve: "
        f"{MF_RETRIEVE / ret_s:.1f} q/s ({MF_RETRIEVE} queries one at a "
        f"time, k={K_TOP}) [{card}]")

    dead = np.random.default_rng(32).choice(N_DOCS, N_DOCS // 100,
                                            replace=False)
    mf.delete_documents(dead)
    gone = mf.get_probabilities_batch(qs[:MF_CHECK])
    if (gone[:, dead] != 0).any():
        fail("multi-field delete: deleted documents keep a probability")
    compare_mf(mf, mf_on_cpu(mf), qs[:MF_CHECK], "multi-field after delete",
               8)
    mf.restore_documents(dead)
    if not np.array_equal(mf.get_probabilities_batch(qs[:MF_CHECK]),
                          dense[:MF_CHECK]):
        fail("multi-field restore: probabilities differ from before")
    new_t = make_texts(trng, words, ADD_DOCS, 8)
    new_b = make_texts(trng, words, ADD_DOCS, 150)
    opts = mf.scorers["body"]._tok_opts
    new = [{"title": t, "body": b} for t, b in zip(
        tokenize_texts(new_t, **opts), tokenize_texts(new_b, **opts))]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mf.add_documents(new, show_progress=False)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    c = read_counts()
    require_launched(c, ["bm25_compare"], "multi-field add_documents")
    counts.append(c)
    compare_mf(mf, mf_on_cpu(mf), qs[:MF_CHECK], "multi-field after "
               "add_documents", 8)
    log(f"multi-field delete/restore of {len(dead)} docs: exact; "
        f"add_documents of {ADD_DOCS}: {add_s:.3f} s [{card}]")
    del mf, cpu
    torch.cuda.empty_cache()
    return counts


MULTIHEAD_SAVED = ("_n_signals", "_n_query_features", "_alpha", "_normalize",
                   "_W", "_b", "_W_avg", "_b_avg")


def model_state(model, dev: str) -> dict:
    """What an archive keeps of a fitted model, as numpy and Python
    values; on the CPU without the logit of the base rate, which each
    device derives from the archived rate."""
    from bayesian_bm25_tpu_torch.utils import convert

    if hasattr(model, "_training_mode"):
        state = convert.transform_to_numpy(model)
    elif hasattr(model, "_heads") or hasattr(model, "_W") or hasattr(
            model, "_logits"):
        state = convert.weights_to_numpy(model)
    elif hasattr(model, "a"):
        state = {"a": model.a, "b": model.b}
    else:
        state = {"x": convert.array_to_numpy(model._x),
                 "y": convert.array_to_numpy(model._y)}
    # A multi-head archive holds each head's parameters and averages,
    # not its online state (the JAX package's format).
    if "heads" in state:
        state["heads"] = [{k: h[k] for k in MULTIHEAD_SAVED}
                          for h in state["heads"]]
    if dev == "cpu":
        state.pop("_logit_base_rate", None)
    return state


def same_state(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(same_state, a, b))
    return bool(np.array_equal(a, b))


def phase_checkpoints(bench, cpu, batches, models, card) -> dict:
    """Phase 18, second half: save_scorer of the bench int8 scorer,
    load_scorer on the card and on the CPU, retrieve_many equal to the
    original's (the card) and to the CPU scorer on the same state (the
    CPU); save_model / load_model of every model phase 16 fitted and of
    the scorer's transform, on the card and the CPU."""
    import tempfile

    import torch

    from bayesian_bm25_tpu_torch.utils.io import (load_model, load_scorer,
                                                  save_model, save_scorer)

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/bench.npz"
        t0 = time.perf_counter()
        save_scorer(path, bench)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_scorer(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        c_loaded = load_scorer(path, device="cpu")
        reset_counts()
        got = loaded.retrieve_many(batches[:2], k=K_TOP)
        counts = read_counts()
        require_launched(counts, ["impact_matmul_bmax", "row_gather",
                                  "topk"],
                         "retrieve_many of the loaded scorer",
                         ["encode_split"])
        ref = bench.retrieve_many(batches[:2], k=K_TOP)
        for (gi, gp), (ri, rp) in zip(got, ref):
            if not (np.array_equal(gi, ri) and np.array_equal(gp, rp)):
                fail("checkpoint: the loaded scorer's retrieve_many differs "
                     "from the original's")
        qs = batches[0][:CHECK_QUERIES]
        (ci, cp), = c_loaded.retrieve_many([qs], k=K_TOP)
        (ri, rp), = cpu.retrieve_many([qs], k=K_TOP)
        if not (np.array_equal(ci, ri) and np.array_equal(cp, rp)):
            fail("checkpoint: the CPU-loaded scorer differs from the CPU "
                 "scorer on the same state")
        compare_retrieve(loaded, c_loaded, qs, "checkpoint loaded on the "
                         "card vs loaded on the CPU")
        log(f"checkpoint: save_scorer {save_s:.3f} s ({size / 1e6:.1f} MB "
            f"compressed), load_scorer on the card {load_s:.3f} s "
            f"(the split index rebuilt); retrieve_many of 2 x {BATCH} "
            f"equal to the original's [{card}]")
        del loaded, c_loaded
        models = dict(models, transform=bench.transform)
        for name, model in models.items():
            mpath = f"{tmp}/{name.replace(' ', '_')}.npz"
            save_model(mpath, model)
            for dev in ("cuda", "cpu"):
                back = load_model(mpath, device=dev)
                if (type(back) is not type(model)
                        or back.device.type != dev
                        or not same_state(model_state(model, dev),
                                          model_state(back, dev))):
                    fail(f"save_model / load_model {name} on {dev}: the "
                         "state differs")
        log(f"save_model / load_model: {', '.join(models)} on the card and "
            f"the CPU, state equal [{card}]")
    return counts


# Sharded scorer (phase 19): four shards of one index on the one card.


def held_bytes(scorer) -> int:
    """Bytes of the distinct CUDA storages a scorer holds: its index, its
    split index, its shards and the copies it keeps."""
    import torch

    seen, total = set(), 0

    def visit(v):
        nonlocal total
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            if v.is_cuda and st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)

    for obj in (scorer, scorer._index, scorer._split):
        if obj is not None:
            # The token lists and the vocabulary hold no tensor, and at 1M
            # documents walking them takes a minute.
            visit({k: v for k, v in vars(obj).items()
                   if k not in ("_corpus_tokens", "vocab")})
    return total


def profiled(fn) -> tuple[float, float, int]:
    """(wall ms, device busy ms, device events) of fn() under
    torch.profiler, the busy time the union of the device events'
    spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return wall, busy / 1e3, len(spans)


def same_outside_ties(ref_outs, outs, scorer, batches, what: str) -> int:
    """Two retrieve_many results: probabilities within PROB_TOL where the
    ids agree, and every differing slot a tie (the two docs' scores for
    that query, from ``scorer.get_scores_batch``, within one ulp).
    Returns the number of tie swaps."""
    swaps, p_err = 0, 0.0
    for (ri, rp), (gi, gp), qb in zip(ref_outs, outs, batches):
        if ri.shape != gi.shape:
            fail(f"{what}: shapes {ri.shape} and {gi.shape}")
        same = ri == gi
        if same.any():
            p_err = max(p_err, float(np.abs(rp - gp)[same].max()))
        rows = np.nonzero(~same.all(axis=1))[0]
        if len(rows) > 256:
            fail(f"{what}: ids differ in {len(rows)} queries")
        if len(rows):
            dense = scorer.get_scores_batch([qb[r] for r in rows])
            for j, r in enumerate(rows):
                for c in np.nonzero(~same[r])[0]:
                    a, b = int(ri[r, c]), int(gi[r, c])
                    if a < 0 or b < 0 or abs(dense[j, a] - dense[j, b]) > (
                            np.spacing(np.float32(dense[j, a]))):
                        fail(f"{what}: ids differ outside ties (query {r}, "
                             f"rank {c}: {a} against {b})")
                    swaps += 1
    if p_err > PROB_TOL:
        fail(f"{what}: probabilities differ by {p_err} > {PROB_TOL}")
    n = sum(len(o[0]) for o in outs)
    log(f"{what}: ids equal on {n} queries outside ties ({swaps} tie "
        f"swaps), max |dprob| {p_err}")
    return swaps


def sharded_dense(sh, single, qs, what: str) -> dict:
    """get_probabilities_batch of the sharded scorer, counted (K5 on the
    shard tails or tables), against the single scorer's."""
    reset_counts()
    t0 = time.perf_counter()
    got = sh.get_probabilities_batch(qs)
    secs = time.perf_counter() - t0
    counts = read_counts()
    require_launched(counts, ["bm25_compare"], f"{what} dense")
    err = float(np.abs(got - single.get_probabilities_batch(qs)).max())
    if got.shape != (len(qs), single.num_docs) or err > PROB_TOL:
        fail(f"{what}: dense probabilities {got.shape} differ by {err}")
    log(f"{what}: get_probabilities_batch of {len(qs)} in {secs:.3f} s, "
        f"max |dprob| {err} against the single scorer")
    return counts


def sharded_ab(single, sh, batches, what: str, card) -> dict:
    """retrieve_many q/s in turns (single, sharded, sharded, single;
    median of 3 each), then each under the profiler: wall and device
    busy ms and device events a batch, and the retrieval's transient
    peak above the resident memory."""
    import torch

    ab = {"single": [], "sharded": []}
    for who in ("single", "sharded", "sharded", "single"):
        qps, runs = retrieve_many_qps(single if who == "single" else sh,
                                      batches, False)
        ab[who].append(qps)
        log(f"{what} {who}: {qps:.1f} q/s median of 3 runs "
            f"{[round(r, 1) for r in runs]} [{card}]")
    n = len(batches)
    for who, sc in (("single", single), ("sharded", sh)):
        wall, busy, events = profiled(lambda: sc.retrieve_many(batches,
                                                               k=K_TOP))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sc.retrieve_many(batches, k=K_TOP)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"{what} {who} a batch: wall {wall / n:.3f} ms, device busy "
            f"{busy / n:.3f} ms (idle share {1 - busy / wall:.3f}), "
            f"{events / n:.1f} device events; held "
            f"{held_bytes(sc) / 2**30:.3f} GiB, retrieval peak "
            f"+{peak / 2**30:.3f} GiB [{card}]")
    return ab


def phase_sharded(corpus, batches, single, samples, run_1m, outs_3,
                  card) -> list:
    """Phase 19: ShardedBayesianBM25Scorer with SHARDS shards on the card,
    held to single scorers (see the module docstring); ``single`` is the
    bench configuration rebuilt in phase 14, whose retrieve_many must equal
    phase 3's scorer's (``outs_3``, phase 5's run). Returns the counted
    paths' launch counts, and the 1M index's tier-1 and tier-2 postings
    widths a shard (phase 20)."""
    import torch

    from bayesian_bm25_tpu_torch import (BayesianBM25Scorer,
                                         BayesianProbabilityTransform,
                                         ShardedBayesianBM25Scorer)
    from bayesian_bm25_tpu_torch.engine import split_index as sidx
    from bayesian_bm25_tpu_torch.models.scorer import _chunks
    from bayesian_bm25_tpu_torch.ops import transform as T
    from bayesian_bm25_tpu_torch.parallel import sharded

    paths = []
    mark = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        log(f"phase 19, {what}: {now - mark[0]:.1f} s [{card}]")
        mark[0] = now

    mesh = sharded.make_mesh(SHARDS, device="cuda")
    ref = single.retrieve_many(batches, k=K_TOP)
    if not all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(ref, outs_3)):
        fail("phase 19: the rebuilt bench scorer differs from phase 3's")

    # Split int8, 50k: the bench configuration over the mesh.
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sh = ShardedBayesianBM25Scorer(base_rate=0.01, impact_storage="int8",
                                   mesh=mesh)
    t0 = time.perf_counter()
    sh.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_peak = torch.cuda.max_memory_allocated() - before
    if (sh.transform.alpha, sh.transform.beta) != (single.transform.alpha,
                                                   single.transform.beta):
        fail("sharded 50k: calibration differs from the single scorer")
    pid = sh._post_sh[0]
    log(f"sharded 50k index: {index_s:.3f} s, {SHARDS} shards of "
        f"{sh._sh['dense_impact'][0].shape[0]} docs, postings per shard "
        f"{tuple(pid[0].shape)}; held {held_bytes(sh) / 2**30:.3f} GiB "
        f"(single {held_bytes(single) / 2**30:.3f}), index peak "
        f"+{index_peak / 2**30:.3f} GiB [{card}]")
    with fused_mm(False):
        reset_counts()
        outs = sh.retrieve_many(batches, k=K_TOP)
        counts = read_counts()
        require_launched(counts, ["block_max", "row_gather", "topk"],
                         "sharded retrieve_many (50k)")
        paths.append(counts)
        for ids, probs in outs:
            check_ranked(ids, probs, BATCH, K_TOP, "sharded retrieve_many")
        same_outside_ties(ref, outs, sh, batches,
                          "sharded 50k retrieve_many")
    with fused_mm(True):
        reset_counts()
        f_outs = sh.retrieve_many(batches, k=K_TOP)
        f_counts = read_counts()
        require_launched(f_counts, ["impact_matmul_bmax", "row_gather",
                                    "topk"], "sharded fused retrieve_many")
        if f_counts["impact_matmul_bmax"] != SHARDS * len(batches):
            fail("sharded fused: K4 did not run once per shard a batch")
        paths.append(f_counts)
        same_outside_ties(ref, f_outs, sh, batches,
                          "sharded 50k fused retrieve_many")
    paths.append(sharded_dense(sh, single, batches[0][:DENSE_QUERIES],
                               "sharded 50k"))
    lap("50k index and checks")
    ab = sharded_ab(single, sh, batches, "sharded 50k A/B", card)
    log(f"A/B sharded 50k: single {[round(x, 1) for x in ab['single']]} "
        f"q/s, sharded {[round(x, 1) for x in ab['sharded']]} q/s [{card}]")
    lap("50k A/B and profiles")

    # Sharded fits: float32 on the card against transform.fit there.
    s, tf, dlr, y = samples
    n = len(s) - len(s) % SHARDS
    a0, b0 = single.transform.alpha, single.transform.beta
    for mode in ("balanced", "prior_aware"):
        kw = dict(tfs=tf[:n], doc_len_ratios=dlr[:n]) if (
            mode == "prior_aware") else {}
        tr = BayesianProbabilityTransform(a0, b0, device="cuda")
        t0 = time.perf_counter()
        tr.fit(s[:n], y[:n], mode=mode, learning_rate=0.05,
               max_iterations=1000, dtype=torch.float32, **kw)
        fit_s = time.perf_counter() - t0
        priors = (T.composite_prior(
            torch.as_tensor(tf[:n], dtype=torch.float32, device="cuda"),
            torch.as_tensor(dlr[:n], dtype=torch.float32, device="cuda"),
            torch.float32) if kw else None)
        t0 = time.perf_counter()
        a, b, it = sharded.sharded_fit_transform(
            mesh, s[:n].astype(np.float32), y[:n].astype(np.float32),
            alpha0=a0, beta0=b0, prior_aware=bool(kw), priors=priors,
            learning_rate=0.05, max_iterations=1000)
        shard_s = time.perf_counter() - t0
        got = np.array([float(a), float(b)])
        want = np.array([tr.alpha, tr.beta])
        err = float(np.abs(got / want - 1).max())
        if not np.isfinite(got).all() or err > FIT_RTOL or abs(
                it - tr._fit_iterations) > 1:
            fail(f"sharded fit ({mode}): {got}, {it} steps against "
                 f"{want}, {tr._fit_iterations}")
        log(f"sharded_fit_transform ({mode}, float32, {n} samples over "
            f"{SHARDS} shards): {it} steps, {shard_s:.3f} s; transform.fit "
            f"on the card {tr._fit_iterations} steps, {fit_s:.3f} s; "
            f"max rel |d| {err:.3g} [{card}]")

    # One training step on the split tables, the card against the CPU.
    qs = batches[0][:64]
    enc = sidx.encode_queries_split(qs, sh._split)
    D_pad = sh.bm25_index.term_ids_host.shape[0]
    labels = (np.random.default_rng(19).uniform(size=(len(qs), D_pad))
              < 0.01).astype(np.float32)
    names = ("dense_impact", "dense_presence", "tail_term_ids",
             "tail_weights", "dense_impact_lo", "impact_scale")
    steps = {}
    for dev, m in (("cuda", mesh),
                   ("cpu", sharded.make_mesh(SHARDS, device="cpu"))):
        parts = [[p.to(dev) for p in sh._sh[name]] for name in names]
        steps[dev] = [float(x) for x in sharded.sharded_train_step_split(
            m, *parts[:4], *enc, labels, a0, b0, learning_rate=0.05,
            impact_lo=parts[4], impact_scale=parts[5])]
    if not np.allclose(steps["cuda"], steps["cpu"], rtol=1e-5, atol=0):
        fail(f"sharded_train_step_split: card {steps['cuda']} against the "
             f"CPU {steps['cpu']}")
    log(f"sharded_train_step_split (64 queries x {D_pad} docs): card "
        f"{steps['cuda']}, CPU {steps['cpu']} (alpha, beta, loss)")
    del sh, outs, f_outs
    torch.cuda.empty_cache()
    lap("fits and the training step")

    # A (2, 2) mesh: the q x d split path (compare tail, no postings).
    sh2 = ShardedBayesianBM25Scorer(
        base_rate=0.01, impact_storage="int8",
        mesh=sharded.make_mesh_2d(2, 2, device="cuda"))
    sh2.index(corpus, show_progress=False)
    reset_counts()
    t0 = time.perf_counter()
    o2 = sh2.retrieve(batches[0], k=K_TOP)
    secs = time.perf_counter() - t0
    counts = read_counts()
    require_launched(counts, ["block_max", "topk", "bm25_compare"],
                     "2-D mesh retrieve")
    paths.append(counts)
    same_outside_ties(ref[:1], [o2], sh2, batches[:1],
                      f"2-D (2, 2) retrieve ({secs:.3f} s)")
    paths.append(sharded_dense(sh2, single, batches[0][:DENSE_QUERIES],
                               "2-D (2, 2)"))
    del sh2
    torch.cuda.empty_cache()
    lap("2-D mesh")

    # The doc-major corpus (phase 9's) over the mesh.
    rng = np.random.default_rng(1)
    dm_corpus = make_corpus(rng, n_docs=N_DOCS, vocab=DM_VOCAB)
    dm_batch = make_queries(rng, n=BATCH, vocab=DM_VOCAB)
    dm = BayesianBM25Scorer(base_rate=0.01, device="cuda")
    dm.index(dm_corpus, show_progress=False)
    sdm = ShardedBayesianBM25Scorer(base_rate=0.01, mesh=mesh)
    sdm.index(dm_corpus, show_progress=False)
    if sdm._split is not None:
        fail("sharded doc-major corpus built a split index")
    reset_counts()
    odm = sdm.retrieve(dm_batch, k=K_TOP)
    counts = read_counts()
    require_launched(counts, ["bm25_compare", "topk", "block_max"],
                     "sharded doc-major retrieve")
    paths.append(counts)
    same_outside_ties([dm.retrieve(dm_batch, k=K_TOP)], [odm], sdm,
                      [dm_batch], "sharded doc-major retrieve")
    paths.append(sharded_dense(sdm, dm, dm_batch[:DENSE_QUERIES],
                               "sharded doc-major"))
    del dm, sdm, dm_corpus
    torch.cuda.empty_cache()
    lap("doc-major")

    # Phase 12's 1M corpus over the mesh (phase 12's scorer is freed).
    corpus_1m, batches_1m, ref_1m = run_1m
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sh1 = ShardedBayesianBM25Scorer(base_rate=0.01, mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    sh1.index(corpus_1m, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_peak = torch.cuda.max_memory_allocated() - before
    require_native(read_counts(), "sharded 1M index", ["corpus_tokens"])
    if sh1._post2_sh is None or sh1._sh["impact_scale"][0] is None:
        fail("sharded 1M: no int8 storage or no sharded tier-2 postings")
    log(f"sharded 1M index: {index_s:.3f} s (index(), the corpus kept "
        f"from phase 12), {SHARDS} shards of "
        f"{sh1._sh['dense_impact'][0].shape[0]} docs, postings per shard "
        f"{tuple(sh1._post_sh[0][0].shape)}, tier-2 per shard "
        f"{tuple(sh1._post2_sh[0][0].shape)}; held "
        f"{held_bytes(sh1) / 2**30:.3f} GiB, index peak "
        f"+{index_peak / 2**30:.3f} GiB [{card}]")
    lap("1M index")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, chunks = record_passes(lambda: sh1.retrieve_many(batches_1m,
                                                           k=K_TOP))
    first_s = time.perf_counter() - t0
    counts = read_counts()
    require_launched(counts, ["impact_matmul_bmax", "row_gather", "topk"],
                     "sharded 1M retrieve_many")
    paths.append(counts)
    n_chunks = sum(len(_chunks(qb, sh1._auto_batch_size()))
                   for qb in batches_1m)
    if len(chunks) != n_chunks:
        fail(f"sharded 1M: {len(chunks)} chunks recorded, {n_chunks} sent")
    for i, c in enumerate(chunks):
        kinds = [p[0] for p in c["passes"]]
        per_shard = len(kinds) // SHARDS
        if len(kinds) % SHARDS or any(
                kinds[j * per_shard:(j + 1) * per_shard] != kinds[:per_shard]
                for j in range(SHARDS)):
            fail(f"sharded 1M chunk {i}: the shards ran other passes {kinds}")
        log(f"sharded 1M chunk {i}: group B {c['group_b']}, light/heavy "
            f"{c['light_heavy']}, passes per shard {kinds[:per_shard]}, "
            f"K2 shapes {[p[1] for p in c['passes'][:per_shard]]}")
    for name, test in (("the light/heavy split", lambda c: c["light_heavy"]),
                       ("a group B (rows with tier-2 terms)",
                        lambda c: c["group_b"]),
                       ("a tier-2 pass", lambda c: any(
                           p[0] == "tier-2" for p in c["passes"]))):
        hit = sum(1 for c in chunks if test(c))
        if hit == 0:
            fail(f"sharded 1M: no chunk ran {name}")
        log(f"sharded 1M: {name} in {hit} of {len(chunks)} chunks, in "
            f"every shard")
    for ids, probs in outs:
        check_ranked(ids, probs, BATCH, K_TOP, "sharded 1M retrieve_many",
                     n_docs=N_1M)
    same_outside_ties(ref_1m, outs, sh1, batches_1m,
                      f"sharded 1M retrieve_many ({first_s:.3f} s, first "
                      "call)")
    qps, runs = retrieve_many_qps(sh1, batches_1m, False)
    log(f"sharded 1M retrieve_many: {qps:.1f} q/s median of 3 runs "
        f"{[round(r, 1) for r in runs]} ({len(batches_1m)} x {BATCH} "
        f"queries, k={K_TOP}) [{card}]")
    wall, busy, events = profiled(lambda: sh1.retrieve_many(batches_1m,
                                                            k=K_TOP))
    peak = torch.cuda.max_memory_allocated() - before
    log(f"sharded 1M a chunk: wall {wall / n_chunks:.3f} ms, device busy "
        f"{busy / n_chunks:.3f} ms (idle share {1 - busy / wall:.3f}), "
        f"{events / n_chunks:.1f} device events; peak device memory "
        f"{peak / 2**30:.3f} GiB above the phase's start [{card}]")
    widths = (max(p.shape[1] for p in sh1._post_sh[0]),
              max(p.shape[1] for p in sh1._post2_sh[0]))
    del sh1, outs
    torch.cuda.empty_cache()
    lap("1M retrieval")
    return paths, widths


STAGE_REPS = 3                # profiled retrieves a phase-20 stage time takes
STAGE_TRIES = 8               # at most, while a stage reads no kernel time
# Phase 20's measured stages, each beside the model's field.
MODEL_STAGES = (("matmul", "matmul"), ("leader selection", "selection"),
                ("merge", "merge"), ("tf + transform", "tf_transform"))


def stages_read(sessions) -> bool:
    """Whether phase 20's profiled sessions, each ({stage: kernel ms},
    {stage: CUDA-event span ms}), credit every stage with kernel time in
    STAGE_REPS of them."""
    names = {n for kern, span in sessions for n in (*kern, *span)}
    return all(sum(kern.get(n, 0.0) > 0 for kern, _ in sessions)
               >= STAGE_REPS for n in names)


def pick_stage_ms(sessions) -> tuple[dict, dict, dict]:
    """Phase 20's reading of its sessions (as ``stages_read`` takes
    them): per stage the median kernel ms of the sessions whose profiler
    credited it with any, or, where none did, the median of its CUDA-event
    spans (the device time between events recorded on the stream as the
    stage begins and ends, idle gaps included). Returns ({stage: ms},
    {stage: "kernels" or "spans"}, {stage: median span ms})."""
    names = sorted({n for kern, span in sessions for n in (*kern, *span)})
    spans = {n: float(np.median([span.get(n, 0.0) for _, span in sessions]))
             for n in names}
    ms, source = {}, {}
    for n in names:
        seen = [kern[n] for kern, _ in sessions if kern.get(n, 0.0) > 0]
        ms[n], source[n] = ((float(np.median(seen)), "kernels") if seen
                            else (spans[n], "spans"))
    return ms, source, spans


def stage_ms(scorer, queries, fused: bool) -> dict:
    """Phase 20's measurement: device ms by stage (``staged``) of one
    retrieve of ``queries`` (one batch or one chunk), with FUSED_MM as
    given: after a warm-up that records the merge passes, retrieves,
    each in its own profiler session with CUDA events around each stage,
    until every stage has kernel time in STAGE_REPS sessions or
    STAGE_TRIES sessions ran; read by ``pick_stage_ms``. Returns
    {"stages": {stage: ms}, "source": {stage: "kernels" or "spans"},
    "spans": {stage: CUDA-event span ms}, "lag": ``launch_lag_ms`` of
    each retrieve, "rest": ms outside every stage,
    "buckets": {stage: {kernel bucket: ms}} of the last retrieve,
    "events": device events of each retrieve, "passes": [[kind, [rows,
    cap]], ...] (each merge pass and K2's sid shape), "nq": queries}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    marks = []

    @contextlib.contextmanager
    def on_range(label):
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ends[0].record()
        yield
        ends[1].record()
        marks.append((label, *ends))

    sessions, runs, lags = [], [], []
    with fused_mm(fused):
        _, chunks = record_passes(lambda: scorer.retrieve(queries, k=K_TOP))
        restore = staged(sidx, on_range)
        try:
            while len(sessions) < STAGE_TRIES and (
                    len(sessions) < STAGE_REPS or not stages_read(sessions)):
                marks.clear()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    scorer.retrieve(queries, k=K_TOP)
                    torch.cuda.synchronize()
                events = prof.events()
                stages, rest = stage_device_ms(events)
                lags.append(launch_lag_ms(events))
                buckets = {n: {b: v for b, v in d.items() if b != "calls"}
                           for n, d in stages.items()}
                span = {}
                for label, a, b in marks:
                    span[label] = span.get(label, 0.0) + a.elapsed_time(b)
                sessions.append(({n: sum(d.values())
                                  for n, d in buckets.items()}, span))
                n_dev = sum(1 for e in events if e.device_type ==
                            torch.autograd.DeviceType.CUDA and
                            not e.name.startswith(STAGE))
                runs.append((buckets, rest, n_dev))
        finally:
            restore()
    if len(chunks) != 1:
        fail(f"phase 20: {len(queries)} queries ran as {len(chunks)} chunks")
    ms, source, spans = pick_stage_ms(sessions)
    return {"stages": ms, "source": source, "spans": spans, "lag": lags,
            "rest": float(np.median([sum(r[1].values()) for r in runs])),
            "buckets": runs[-1][0], "events": [r[2] for r in runs],
            "passes": chunks[0]["passes"], "nq": len(queries)}


def model_inputs(cm, st, K: int) -> dict:
    """retrieval_cost's keyword arguments for a measured point: the
    unfused int8 product, the first (tier-1) merge pass as the primary
    merge, every later pass as an extra pass, at its K2 shape."""
    passes = st["passes"]
    if not passes or passes[0][0] != "tier-1" or any(
            len(p) < 2 for p in passes):
        fail(f"phase 20: no tier-1 pass first, or a pass without K2: "
             f"{passes}")
    rows, cap = passes[0][1]
    return dict(nq=st["nq"], K=K, k=K_TOP, matmul_passes=2,
                peak_flops=cm.PEAK_INT8_OPS, tail_row_frac=rows / st["nq"],
                cand_cap=cap,
                extra_passes=tuple(tuple(p[1]) for p in passes[1:]))


def phase_cost_model(points, widths, card) -> None:
    """Phase 20: the cost model (parallel/cost_model.py) beside the
    card's stage times. ``points``: {label: (n_docs, K, {"unfused": st,
    "fused": st})} with each st from ``stage_ms``; ``widths``: the 1M
    index's tier-1 and tier-2 postings widths, single and per shard of
    phase 19. Prints measured ms, model ms and their ratio per stage and
    per merge pass (each route's own passes), the model's 1/2/4/8-shard
    table at 1M and its cap shrink beside the measured one. Fatal only on
    a missing stage or a non-finite number, not on the model's ratio to
    the measurement."""
    from bayesian_bm25_tpu_torch.parallel import cost_model as cm

    numbers = []
    for label, (n_docs, K, runs) in points.items():
        kw = model_inputs(cm, runs["unfused"], K)
        model = cm.retrieval_cost(n_docs, **kw)
        for route, st in runs.items():
            rows1, cap1 = st["passes"][0][1]
            by_pass = {"merge tier-1": cm.MERGE_REF_S * rows1 * cap1
                       / cm.MERGE_REF_CELLS}
            for kind, (rows, cap) in st["passes"][1:]:
                by_pass["merge " + kind] = by_pass.get("merge " + kind,
                                                       0.0) + \
                    cm.merge_pass_cost(rows, cap, 1, K_TOP)
            got = dict(st["stages"])
            for need in ("matmul", "leader selection", "tf + transform",
                         *by_pass):
                if need not in got:
                    fail(f"phase 20 {label} {route}: no '{need}' stage "
                         f"(stages {sorted(got)})")
            got["merge"] = sum(v for n, v in got.items()
                               if n.startswith("merge "))
            rows = [(name, got[name], getattr(model, field) * 1e3)
                    for name, field in MODEL_STAGES]
            rows += [(name, got[name], ms * 1e3)
                     for name, ms in sorted(by_pass.items())]
            rows.append(("total", sum(got[n] for n, _ in MODEL_STAGES),
                         model.total * 1e3))
            for name, meas, mod in rows:
                ratio = mod / meas if meas > 0 else float("inf")
                numbers += [(f"{label} {route} {name} {what}", x) for what, x
                            in (("measured", meas), ("model", mod),
                                ("ratio", ratio))]
                log(f"phase 20 {label} {route}, {name}: measured "
                    f"{meas:.4f} ms, model {mod:.4f} ms, model/measured "
                    f"{ratio:.4f} [{card}]")
            log(f"phase 20 {label} {route}: outside the stages "
                f"{st['rest']:.4f} ms; device events a retrieve "
                f"{st['events']}; by kernel (last retrieve) " + json.dumps(
                    {n: {b: round(v, 4) for b, v in d.items()}
                     for n, d in sorted(st["buckets"].items())}))
            log(f"phase 20 {label} {route}: read from " + json.dumps(
                st["source"]) + "; CUDA-event spans, ms " + json.dumps(
                {n: round(v, 4) for n, v in st["spans"].items()}) +
                "; launch to device start, least a retrieve, ms "
                f"{[round(x, 4) for x in st['lag']]}")
            log(f"phase 20 {label} {route}: merge passes {st['passes']}; "
                f"model inputs {json.dumps(kw)}")
        if label == "1M":
            table = cm.scaling_table(N_1M, shards=(1, 2, 4, 8), **kw)
            for r in table:
                numbers += [(f"1M model over {r['n_shards']} shards {k}", v)
                            for k, v in r.items()]
                log(f"phase 20 model (not a measurement), 1M over "
                    f"{r['n_shards']} shards: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in r.items()
                        if k != "n_shards"))
            log(f"phase 20 model: crossover at "
                f"{cm.crossover_shards(N_1M, **kw)} shards of {N_1M} docs")
    for name, (single, shard) in widths.items():
        mod = K_TOP + max((single - K_TOP) // SHARDS, 1)
        numbers += [(f"{name} width {what}", x) for what, x in
                    (("single", single), ("per shard", shard), ("model", mod))]
        log(f"phase 20 {name} postings width at 1M: single {single}, per "
            f"shard of {SHARDS} (phase 19) {shard}, the model's cap shrink "
            f"k + (cap - k) // S = {mod} (measured/model {shard / mod:.4f})")
    bad = [tag for tag, x in numbers if not np.isfinite(x)]
    if bad:
        fail(f"phase 20: a non-finite number ({', '.join(bad)})")


def phase_examples(card) -> dict:
    """Phase 21: scripts/run_examples_torch.py in its own process: the
    JAX package's examples unchanged (and the port's sharded
    counterpart) on the card, each output compared with the JAX
    package's recorded one. Fatal if one raises or differs. Returns the
    examples' kernel launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "examples_torch")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "run_examples_torch.py"),
         "--out", out], cwd=root, capture_output=True, text=True,
        timeout=900)
    secs = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        log(f"phase 21 {line}")
    if run.returncode != 0:
        fail(f"phase 21: the examples' runner exited {run.returncode}: "
             f"{run.stderr[-3000:]}")
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    n = len(summary["examples"])
    if n != 19 or not all(e["ok"] for e in summary["examples"].values()):
        fail(f"phase 21: {n} examples, not all ok")
    counts = summary["launches"]
    log(f"phase 21: {n} examples on the card in {secs:.1f} s (one process), "
        f"every output equal to the JAX package's under the mask; kernel "
        f"launches {json.dumps(counts)} [{card}]")
    return counts


BENCH_PARTS = 19              # the benchmark runner's default parts


def phase_benchmarks(card) -> dict:
    """Phase 22: scripts/run_benchmarks_torch.py in its own process: the
    benchmark harness on the card (mini BEIR against its frozen NDCGs,
    with the IVF, the one-seed gates, the JAX package's scripts against
    their recorded output, sharded_scaling). Fatal if a part raises,
    differs or fails, or if K3, K4, K5 (and K2 where sharded_scaling
    takes the split merge) did not launch: on the card the split paths'
    leader selection reads K4's maxima, not K1's. Returns the
    launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "benchmarks_torch")
    run = subprocess.run(
        [sys.executable,
         os.path.join(root, "scripts", "run_benchmarks_torch.py"),
         "--out", out], cwd=root, capture_output=True, text=True,
        timeout=600)
    for line in run.stdout.splitlines():
        log(f"phase 22 {line}")
    if run.returncode != 0:
        fail(f"phase 22: the benchmark runner exited {run.returncode}: "
             f"{run.stderr[-3000:]}")
    with open(os.path.join(out, "summary.json")) as f:
        parts = json.load(f)["parts"]
    if len(parts) != BENCH_PARTS or not all(p["ok"] for p in parts.values()):
        fail(f"phase 22: {len(parts)} parts, not all ok")
    for name in ("mini_beir", "mini_beir_ivf"):
        with open(os.path.join(out, f"{name}.txt")) as f:
            log(f"phase 22 {name}: {f.read().splitlines()[-1]}")
    counts = {k: sum(p["launches"][k] for p in parts.values())
              for k in next(iter(parts.values()))["launches"]}
    for name in ("impact_matmul_bmax", "topk", "bm25_compare"):
        if counts[name] <= 0:
            fail(f"phase 22: kernel {name} was not launched")
    with open(os.path.join(out, "sharded_scaling.txt")) as f:
        merge = "split merge: yes" in f.read()
    k2 = parts["sharded_scaling"]["launches"]["row_gather"]
    if merge and k2 <= 0:
        fail("phase 22: sharded_scaling took the split merge without K2")
    log(f"phase 22: sharded_scaling's corpus "
        f"{'takes' if merge else 'does not take'} the split merge, K2 "
        f"{k2}; seconds by part "
        + json.dumps({n: p["seconds"] for n, p in parts.items()})
        + f"; launches {json.dumps(counts)} [{card}]")
    return counts


def phase_jax_suites(card) -> dict:
    """Phase 23: scripts/run_jax_suites_torch.py --device cuda in its own
    process: the JAX package's own test files, unchanged, against the
    port on the card. Fatal if a case fails that the table does not list
    for the card, a listed case does not fail, the process held a module
    of JAX, or K3, K4 or K5 never launched (the split paths take K4 on
    the card, not K1). Returns the launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "jax_suites_torch")
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, os.path.join(root, "scripts",
                                          "run_jax_suites_torch.py"),
             "--device", "cuda", "--out", out, "--timeout", "180"],
            cwd=root, capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        fail("phase 23: the suites' runner ran past 240 s")
    secs = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        log(f"phase 23 {line}")
    if run.returncode != 0:
        fail(f"phase 23: the suites' runner exited {run.returncode}: "
             f"{run.stderr[-3000:]}")
    with open(os.path.join(out, "summary.json")) as f:
        counts = json.load(f)["launches"]
    for name in ("impact_matmul_bmax", "topk", "bm25_compare"):
        if counts[name] <= 0:
            fail(f"phase 23: kernel {name} was not launched")
    log(f"phase 23: the JAX package's suites on the card in {secs:.1f} s "
        f"(one process), every failure listed for the card; kernel "
        f"launches {json.dumps(counts)} [{card}]")
    return counts


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU and has no CPU path")
    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import _cuda_build, native
    from bayesian_bm25_tpu_torch.utils import convert

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}")

    # 2. build
    t0 = time.perf_counter()
    _cuda_build.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda_build.build_seconds} s) -> {_cuda_build.library_path().name}")
    for src, report in sorted(_cuda_build.build_log.items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    t0 = time.perf_counter()
    try:
        native.load()
    except (ImportError, OSError) as exc:
        fail(f"the native library did not build or load: {exc}")
    log(f"native library: {time.perf_counter() - t0:.2f} s (g++ "
        f"{native.build_seconds} s) -> {native.library_path()}")
    check_compare_first_launch()
    k5_wide = check_compare_edges(card)

    # 3. index
    rng = np.random.default_rng(0)
    corpus = make_corpus(rng, n_docs=N_DOCS)
    queries = make_queries(rng, n=BATCH)
    # numpy's zipf draws differ between numpy versions: name the corpus.
    log(f"corpus: numpy {np.__version__}, first doc {' '.join(corpus[0][:6])}, "
        f"first query {' '.join(queries[0])}")
    brng = np.random.default_rng(7)
    batches = [queries] + [[queries[i] for i in brng.permutation(len(queries))]
                           for _ in range(N_BATCHES - 1)]
    torch.cuda.reset_peak_memory_stats()
    scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8",
                                device="cuda")
    t0 = time.perf_counter()
    scorer.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    t = scorer.transform
    s = scorer._split
    log(f"index: {index_s:.3f} s [{card}]; D_pad {s.dense_impact.shape[0]}, "
        f"K {s.n_frequent}, postings {tuple(s.post_doc_ids.shape)}, "
        f"tier-2 {s.post2_doc_ids is not None}, tail table "
        f"{tuple(s.tail_term_ids.shape)}; alpha {t.alpha:.6f} "
        f"beta {t.beta:.6f} base_rate {t.base_rate}")

    # 4. kernels at the main path's shapes and 5. the slice, both on the
    # library route (K1 at its operands); phase 7 takes K4, the card's
    # default route, and the A/B.
    with fused_mm(False):
        shapes = record_shapes(scorer, batches[0], K_TOP)
        log(f"main-path kernel shapes: {json_shapes(shapes)}")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        # Read before each cold K2 launch: five times the 50 MB L2.
        flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
        kernels, k2 = check_kernels(shapes, gen, card, flush)
        del shapes
        check_int8_epilogue(scorer, batches[0][:1024])

        # 5. the slice: counted main-path run, then timed runs
        reset_counts()
        outs = scorer.retrieve_many(batches, k=K_TOP)
        slice_counts = read_counts()
        require_launched(slice_counts, ["block_max", "row_gather", "topk"],
                         "retrieve_many")
        if len(outs) != N_BATCHES:
            fail(f"retrieve_many returned {len(outs)} results")
        for ids, probs in outs:
            check_ranked(ids, probs, BATCH, K_TOP, "retrieve_many")
            if not (ids >= 0).all():
                fail("ids outside [0, n_docs)")
        log(f"outputs: {N_BATCHES} x ({BATCH}, {K_TOP}); ids in "
            f"[0, {N_DOCS}); "
            "probabilities in [0, 1)")

        # Same index state on the CPU, first queries of batch 0.
        qs = batches[0][:CHECK_QUERIES]
        cpu = convert.scorer_from_numpy(
            convert.split_index_to_numpy(s), t.alpha, t.beta, t.base_rate,
            device="cpu")
        g_ids = compare_retrieve(scorer, cpu, qs, "retrieve")
        if not np.array_equal(g_ids, outs[0][0][:CHECK_QUERIES]):
            fail("retrieve and retrieve_many disagree on the first queries")
        check_matmul_branches(scorer, cpu, qs)

        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer.retrieve_many(batches, k=K_TOP)
            runs.append(N_BATCHES * BATCH / (time.perf_counter() - t0))
        qps = sorted(runs)[1]
        peak = torch.cuda.max_memory_allocated()
        log(f"retrieve_many: {qps:.1f} q/s median of 3 runs "
            f"{[round(r, 1) for r in runs]} "
            f"({N_BATCHES} x {BATCH} queries, k={K_TOP}) [{card}]")
        log(f"peak device memory: {peak / 2**30:.3f} GiB [{card}]")
        log(f"index seconds: {index_s:.3f} [{card}]")

    # 6. the dense API on the bench split index (K5 on its tail table)
    calls = record_compares(
        lambda: scorer.get_probabilities_batch(batches[0][:DENSE_QUERIES]))
    tail_ops = next(c for c in calls if c[0].shape == s.tail_term_ids.shape)
    k5_tail = check_compare("split tail", tail_ops, scorer._index.n_terms, card)
    del calls, tail_ops
    dense_counts = phase_dense(scorer, cpu, batches[0], card)

    # 7. K4 and the fused int8 path on the bench scorer
    k4_err = max(k4_edges(gen), k4_path_sparsity(gen))
    qvec = batch_qvec(scorer, batches[0])
    cols = kept_columns(s, "bench int8", card)
    k4_err = max(k4_err, check_k4("int8", qvec, cols, s.impact_scale,
                                  s.n_docs, "int8 (bench operands)",
                                  real=True)["err"])
    k4_times = [time_k4("int8", qvec, cols, s.impact_scale, s.n_docs,
                        "int8 (bench)", card,
                        (s.dense_impact, s.dense_impact_lo))]
    del qvec, cols
    torch.cuda.empty_cache()
    fused_counts, ab_int8 = phase_fused(scorer, cpu, batches, "bench int8",
                                        card)
    # Phase 20's 50k point, on this scorer while it lives.
    t0 = time.perf_counter()
    point_50k = (s.dense_impact.shape[0], s.n_frequent,
                 {route: stage_ms(scorer, batches[0], route == "fused")
                  for route in ("unfused", "fused")})
    log(f"phase 20, the 50k batch's stages: {time.perf_counter() - t0:.1f} s "
        f"[{card}]")

    # 8. the compare tail of an index without postings
    del cpu, scorer, s
    torch.cuda.empty_cache()
    tail_counts = phase_tail(corpus, batches[0], card)

    # 9. the doc-major path
    torch.cuda.empty_cache()
    dm_counts, k5_dm = phase_doc_major(card)

    # 10. the constructor's default configuration (hilo), fused and not
    torch.cuda.empty_cache()
    ctor, ctor_counts, ctor_times, ctor_err, ab_hilo = phase_ctor(
        corpus, batches, card)
    k4_times += ctor_times
    k4_err = max(k4_err, ctor_err)

    # 11. the document lifecycle and retrieve_stream, fused
    life_counts = phase_lifecycle(ctor, corpus, batches, card)
    del ctor
    torch.cuda.empty_cache()
    for name, ab in (("bench int8", ab_int8), ("ctor default hilo", ab_hilo)):
        log(f"A/B {name}: unfused {[round(x, 1) for x in ab['unfused']]} q/s, "
            f"fused {[round(x, 1) for x in ab['fused']]} q/s [{card}]")

    # 12. the 1M-document int8 configuration: tier-2, light/heavy, group B
    (m_counts, m_fused_counts, m_k1, m_k2, m_k3, m_k4, m_k4_err,
     ab_1m, run_1m, point_1m, widths_1m) = phase_split_1m(card, flush)
    del flush

    # 13. the raw-text path at 50k: index_jsonl twice, retrieve_texts
    text_counts = phase_text(card)

    # 14. supervised calibration, and the configurations never run on the
    # card before, on the bench split index rebuilt
    torch.cuda.empty_cache()
    bench, cal_counts, samples = phase_calibration(corpus, batches, card)
    never_counts = check_never_run(bench, corpus, batches[0], card)

    # 15. the host encoder in turns: the Python twin against native
    phase_encoder_ab(bench, batches, card)

    # 16. the fusion and calibration library at the bench's width
    t0 = time.perf_counter()
    t = bench.transform
    cpu = convert.scorer_from_numpy(
        convert.split_index_to_numpy(bench._split), t.alpha, t.beta,
        t.base_rate, device="cpu")
    explain_counts = phase_explain(bench, cpu, batches[0], card)
    phase_dense_fusion(bench, batches[0], card)
    models = phase_weights(bench, batches[1], card)
    models.update(phase_calibrators(bench, samples, card))
    phase_block_max(bench, cpu, batches[0], card)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s [{card}]")

    # 17. dense vectors: the IVF at 50k and 1M, diagnostics, the VPT
    t0 = time.perf_counter()
    vector_counts = phase_vectors(bench, batches[0], card)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s [{card}]")

    # 18. multi-field scoring and checkpoints
    t0 = time.perf_counter()
    field_counts = phase_fields(card)
    ckpt_counts = phase_checkpoints(bench, cpu, batches, models, card)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s [{card}]")
    del cpu, models
    torch.cuda.empty_cache()

    # 19. the sharded scorer, four shards on the card
    t0 = time.perf_counter()
    sharded_counts, widths_sh = phase_sharded(corpus, batches, bench,
                                              samples, run_1m, outs, card)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s [{card}]")
    del bench, run_1m
    torch.cuda.empty_cache()

    # 20. the cost model beside the stage times of the 50k batch (measured
    # after phase 7) and of phase 12's 1M chunk (measured in phase 12)
    t0 = time.perf_counter()
    phase_cost_model({"50k": point_50k, "1M": point_1m},
                     {"tier-1": (widths_1m[0], widths_sh[0]),
                      "tier-2": (widths_1m[1], widths_sh[1])}, card)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s [{card}]")

    # 21. the JAX package's examples on the card
    t0 = time.perf_counter()
    example_counts = phase_examples(card)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s [{card}]")

    # 22. the benchmark harness on the card
    t0 = time.perf_counter()
    bench_counts = phase_benchmarks(card)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s [{card}]")

    # 23. the JAX package's own test suites on the card
    t0 = time.perf_counter()
    suite_counts = phase_jax_suites(card)
    log(f"phase 23: {time.perf_counter() - t0:.1f} s [{card}]")

    k4_times.append(m_k4)
    k4_err = max(k4_err, m_k4_err)
    k1_entry, k3_entry = kernels
    k1_entry["at_1m"], k3_entry["at_1m"] = m_k1, m_k3
    k2 += m_k2
    # No single PyTorch call: ids outside [0, D_pad) read as 0.
    kernels.insert(1, dict(
        name="row_gather", route="cuda",
        source="bayesian_bm25_tpu_torch/csrc/row_gather.cu",
        replaces="bayesian_bm25_tpu/engine/pallas_gather.py:68",
        max_abs_err=max(e["err"] for e in k2),
        ms=sum(e["cold_ms"] for e in k2),
        plain_ms=sum(e["plain_ms"] for e in k2),
        bound_ms=sum(e["bound_ms"] for e in k2), bound_by="bytes",
        library_ms=None, warm_ms=sum(e["warm_ms"] for e in k2),
        sector_bound_ms=sum(e["sector_bound_ms"] for e in k2),
        no_gather_cold_ms=sum(e["no_gather_cold_ms"] for e in k2), shapes=k2))

    paths = [slice_counts, dense_counts, fused_counts, tail_counts, dm_counts,
             ctor_counts, *life_counts, m_counts, m_fused_counts,
             *text_counts, cal_counts, *never_counts, explain_counts,
             *vector_counts, *field_counts, ckpt_counts, *sharded_counts,
             example_counts, bench_counts, suite_counts]
    k5 = [k5_dm, k5_tail]
    kernels.append(dict(
        name="bm25_compare", route="cuda",
        source="bayesian_bm25_tpu_torch/csrc/bm25_compare.cu",
        replaces="bayesian_bm25_tpu/engine/pallas_bm25.py:39",
        max_abs_err=max(e["err"] for e in k5), ms=sum(e["ms"] for e in k5),
        plain_ms=sum(e["plain_ms"] for e in k5),
        **bound(sum(e["n_bytes"] for e in k5), sum(e["n_ops"] for e in k5)),
        # No single PyTorch call computes this function.
        library_ms=None, shapes=[e["shape"] for e in k5], wide=k5_wide))
    kernels.append(dict(
        name="impact_matmul_bmax", route="cuda",
        source="bayesian_bm25_tpu_torch/csrc/impact_matmul.cu",
        replaces="bayesian_bm25_tpu/engine/pallas_matmul.py:79",
        max_abs_err=k4_err, ms=sum(e["ms"] for e in k4_times),
        plain_ms=sum(e["plain_ms"] for e in k4_times),
        bound_ms=sum(e["bound_ms"] for e in k4_times),
        bound_by=("bytes" if all(e["bound_by"] == "bytes" for e in k4_times)
                  else "operations"),
        # No one PyTorch call computes scores and block maxima.
        library_ms=None, modes=k4_times,
        ab_qps={"int8": ab_int8, "hilo": ab_hilo, "int8_1m": ab_1m}))
    for kern in kernels:
        kern["launches"] = sum(p[kern["name"]] for p in paths)
        kern["sharded_launches"] = sum(p[kern["name"]]
                                       for p in sharded_counts)
        if kern["launches"] <= 0 or kern["sharded_launches"] <= 0:
            fail(f"kernel {kern['name']} was not launched by the main paths")
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
