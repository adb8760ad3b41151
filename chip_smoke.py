#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  -- require CUDA; print the card's name and power limit;
  2. build   -- compile the CUDA kernels from bayesian_bm25_tpu_torch/csrc;
  3. index   -- bench.py's headline regime: 50,000-doc Zipf(1.3) corpus,
                BayesianBM25Scorer(base_rate=0.01, impact_storage="int8");
  4. kernels -- each kernel against its plain PyTorch version on the card,
                bit-exact, at the shapes the main path gives it (recorded
                from one retrieve of the first batch), with edge cases;
                both timed with CUDA events;
  5. slice   -- retrieve_many over 5 batches of 8,192 queries at k=10
                with every launch counter reset first and required > 0
                after; ids and probabilities checked; the first 32 queries
                compared with the same index state on the CPU; q/s as the
                median of 3 timed runs.

The second-to-last line of standard output is the kernels' JSON record,
the last line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_DOCS, K_TOP, N_BATCHES, BATCH = 50_000, 10, 5, 8192
CHECK_QUERIES = 32
PROB_TOL = 1e-5


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
    """Mean device milliseconds per call, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b|, where equal entries (infinities included) count 0."""
    import torch

    same = a == b
    if bool(same.all()):
        return 0.0
    return float(torch.where(same, 0.0, (a.double() - b.double()).abs()).max())


def record_shapes(scorer, batch, k):
    """Shapes of every kernel call one retrieve of ``batch`` makes."""
    from bayesian_bm25_tpu_torch.engine import cuda_gather, cuda_reduce, cuda_topk

    shapes = {"block_max": [], "row_gather": [], "topk": []}
    orig = (cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk)

    def bm(scores, block, valid_upto=None):
        shapes["block_max"].append((tuple(scores.shape), block, valid_upto))
        return orig[0](scores, block, valid_upto)

    def rg(scores, sid, trows):
        shapes["row_gather"].append((tuple(scores.shape), tuple(sid.shape)))
        return orig[1](scores, sid, trows)

    def tk(x, kk):
        shapes["topk"].append((tuple(x.shape), kk))
        return orig[2](x, kk)

    cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk = bm, rg, tk
    try:
        scorer.retrieve(batch, k=k)
    finally:
        cuda_reduce.block_max, cuda_gather.row_gather, cuda_topk.topk = orig
    return shapes


def check_kernels(shapes, gen) -> list[dict]:
    """Each kernel vs its plain version at the recorded shapes, with
    -inf rows, a block cut by valid_upto, sentinel ids, repeated rows,
    heavy ties and rows with fewer than k finite entries."""
    import torch

    from bayesian_bm25_tpu_torch.engine import cuda_gather, cuda_reduce, cuda_topk

    dev = "cuda"
    out = []

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev) * 30.0

    # K1: the leader-selection block maxima.
    (nq, d), block, valid_upto = shapes["block_max"][0]
    x = rand((nq, d))
    x[1] = float("-inf")
    x[2, : d // 2] = float("-inf")
    errs = []
    for vu in (valid_upto, d, valid_upto - 1):
        got = cuda_reduce.block_max(x, block, vu)
        want = cuda_reduce.block_max_plain(x, block, vu)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K1 block_max differs from its plain version (valid_upto={vu})")
        errs.append(max_abs_err(got, want))
    ms = cuda_ms(lambda: cuda_reduce.block_max(x, block, valid_upto))
    plain_ms = cuda_ms(lambda: cuda_reduce.block_max_plain(x, block, valid_upto))
    log(f"K1 block_max {(nq, d)} block {block} valid_upto {valid_upto}: "
        f"bit-exact; {ms:.4f} ms vs plain {plain_ms:.4f} ms")
    out.append(dict(name="block_max", route="cuda",
                    source="bayesian_bm25_tpu_torch/csrc/block_max.cu",
                    replaces="bayesian_bm25_tpu/engine/pallas_reduce.py:69",
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms))

    # K2: the merge's base-score gather.
    (nq, d_pad), (nt, cap) = max(shapes["row_gather"],
                                 key=lambda s: s[1][0] * s[1][1])
    scores = rand((nq, d_pad))
    scores[3] = float("-inf")
    sid = torch.sort(torch.randint(0, d_pad + 1, (nt, cap), generator=gen,
                                   device=dev, dtype=torch.int32), dim=1).values
    sid[:, -cap // 4:] = d_pad                       # sentinel tail
    trows = torch.randint(0, nq, (nt,), generator=gen, device=dev,
                          dtype=torch.int32)
    trows[: nt // 8] = 3                             # repeated -inf row
    got = cuda_gather.row_gather(scores, sid, trows)
    want = cuda_gather.row_gather_plain(scores, sid, trows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("K2 row_gather differs from its plain version")
    ms = cuda_ms(lambda: cuda_gather.row_gather(scores, sid, trows))
    plain_ms = cuda_ms(lambda: cuda_gather.row_gather_plain(scores, sid, trows))
    log(f"K2 row_gather scores {(nq, d_pad)} sid {(nt, cap)}: bit-exact; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
    out.append(dict(name="row_gather", route="cuda",
                    source="bayesian_bm25_tpu_torch/csrc/row_gather.cu",
                    replaces="bayesian_bm25_tpu/engine/pallas_gather.py:68",
                    max_abs_err=max_abs_err(got, want), ms=ms,
                    plain_ms=plain_ms))

    # K3: every top-k shape of the path (block selection, leader top-k,
    # merge candidates), with heavy ties and -inf rows.
    errs, times = [], []
    for (rows, c), kk in sorted(set(shapes["topk"])):
        y = torch.randint(0, 5, (rows, c), generator=gen, device=dev).float()
        y[0] = float("-inf")
        y[1, 3:] = float("-inf")                     # < k finite entries
        y[2] = 1.0                                   # one big tie
        got = cuda_topk.topk(y, kk)
        want = cuda_topk.topk_plain(y, kk)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"K3 topk differs from its plain version at {(rows, c)} k={kk}")
        errs.append(max_abs_err(got[0], want[0]))
        ms = cuda_ms(lambda: cuda_topk.topk(y, kk))
        plain_ms = cuda_ms(lambda: cuda_topk.topk_plain(y, kk))
        times.append((ms, plain_ms))
        log(f"K3 topk {(rows, c)} k={kk}: bit-exact; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms")
    out.append(dict(name="topk", route="cuda",
                    source="bayesian_bm25_tpu_torch/csrc/topk.cu",
                    replaces="bayesian_bm25_tpu/engine/pallas_topk.py:54",
                    max_abs_err=max(errs), ms=sum(t[0] for t in times),
                    plain_ms=sum(t[1] for t in times)))
    return out


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU and has no CPU path")
    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import (_cuda_build, cuda_gather,
                                                cuda_reduce, cuda_topk)
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
        f"tier-2 {s.post2_doc_ids is not None}; alpha {t.alpha:.6f} "
        f"beta {t.beta:.6f} base_rate {t.base_rate}")

    # 4. kernels at the main path's shapes
    shapes = record_shapes(scorer, batches[0], K_TOP)
    log(f"main-path kernel shapes: {json.dumps(shapes)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kernels = check_kernels(shapes, gen)
    check_int8_epilogue(scorer, batches[0][:1024])

    # 5. the slice: counted main-path run, then timed runs
    cuda_reduce.launches = cuda_gather.launches = cuda_topk.launches = 0
    outs = scorer.retrieve_many(batches, k=K_TOP)
    counts = {"block_max": cuda_reduce.launches,
              "row_gather": cuda_gather.launches, "topk": cuda_topk.launches}
    log(f"main-path launches: {counts}")
    for kern in kernels:
        kern["launches"] = counts[kern["name"]]
        if kern["launches"] <= 0:
            fail(f"kernel {kern['name']} was not launched by retrieve_many")
    if len(outs) != N_BATCHES:
        fail(f"retrieve_many returned {len(outs)} results")
    for ids, probs in outs:
        if ids.shape != (BATCH, K_TOP) or probs.shape != (BATCH, K_TOP):
            fail(f"bad output shapes {ids.shape} {probs.shape}")
        if ids.dtype != np.int32 or probs.dtype != np.float64:
            fail(f"bad output dtypes {ids.dtype} {probs.dtype}")
        if not ((ids >= 0) & (ids < N_DOCS)).all():
            fail("ids outside [0, n_docs)")
        if not (np.isfinite(probs).all() and (probs >= 0).all()
                and (probs < 1).all()):
            fail("probabilities outside [0, 1)")
    log("outputs: 5 x (8192, 10); ids in [0, 50000); probabilities in [0, 1)")

    # Same index state on the CPU, first queries of batch 0.
    qs = batches[0][:CHECK_QUERIES]
    _, g_ids, g_probs, g_scores, _ = scorer._retrieve_launch(qs, K_TOP, False, None)
    cpu = convert.scorer_from_numpy(
        convert.split_index_to_numpy(s), t.alpha, t.beta, t.base_rate,
        device="cpu")
    _, c_ids, c_probs, c_scores, _ = cpu._retrieve_launch(qs, K_TOP, False, None)
    g_ids, g_probs, g_scores = (a.cpu() for a in (g_ids, g_probs, g_scores))
    if not np.array_equal(g_ids.numpy(), outs[0][0][:CHECK_QUERIES]):
        fail("retrieve and retrieve_many disagree on the first queries")
    differ = g_ids != c_ids
    if bool((differ & (g_scores != c_scores)).any()):
        fail("card and CPU disagree on ids outside exact-score ties")
    p_err = float((g_probs - c_probs).abs().max())
    s_err = float((g_scores - c_scores).abs().max())
    if p_err > PROB_TOL:
        fail(f"card and CPU probabilities differ by {p_err} > {PROB_TOL}")
    log(f"card vs CPU on {CHECK_QUERIES} queries: ids equal "
        f"({int(differ.sum())} tie swaps), max |dscore| {s_err}, "
        f"max |dprob| {p_err}")

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scorer.retrieve_many(batches, k=K_TOP)
        runs.append(N_BATCHES * BATCH / (time.perf_counter() - t0))
    qps = sorted(runs)[1]
    peak = torch.cuda.max_memory_allocated()
    log(f"retrieve_many: {qps:.1f} q/s median of 3 runs {[round(r, 1) for r in runs]} "
        f"({N_BATCHES} x {BATCH} queries, k={K_TOP}) [{card}]")
    log(f"peak device memory: {peak / 2**30:.3f} GiB [{card}]")
    log(f"index seconds: {index_s:.3f} [{card}]")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
