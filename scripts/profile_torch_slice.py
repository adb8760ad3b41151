#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one GPU.

    python3 scripts/profile_torch_slice.py [--path split|doc-major|split-1m]
        [--storage int8|hilo] [--fused | --unfused] [--trace PATH]

Builds chip_smoke.py's regime (50,000-doc Zipf corpus, 5 batches of 8,192
queries, k=10): ``split`` is the 30,000-term vocabulary (the
sparse-candidate path) with int8 storage, or with the constructor's
default hilo storage under ``--storage hilo``. On ``split`` and
``split-1m`` the scoring matmul and its block maxima run in K4, the
card's default route; ``--unfused`` forces the library product and K1
(split_index.FUSED_MM False), ``--fused`` forces K4 (True).
``doc-major`` is the 200-term vocabulary that takes the doc-major
compare (K5). ``split-1m`` is chip_smoke.py's phase 12: the 1M-document
corpus under the constructor's default scorer (int8, tier-2 postings,
1,024-query chunks) and 2 batches of 8,192 queries; its merge passes are
tier-1 (light), heavy, and tier-2 (group B) with its heavy half. It warms
up, then reports:
  * host milliseconds per batch (per 1,024-query chunk for ``split-1m``)
    for the encode (the one-pass native encoder of engine/native.py) and
    for the whole launch (encode + copies + enqueue, no sync), and the
    wall time of one retrieve_many;
  * a torch.profiler trace of one retrieve_many: device time by op or
    kernel, and the device's busy and idle share of the window; on the
    split paths also device time by stage (chip_smoke.staged: matmul,
    leader selection, each merge pass, tf + transform; each with its
    sort, K2, K3 and other kernels; the rest);
  * the index seconds, and for ``doc-major`` the dense API: host ms of
    get_probabilities_batch on 2,048 queries and of retrieve_thresholded
    on 8,192 at threshold 0.5, median of 3 after a warm-up call.
The Chrome trace goes to PATH (default traces/profile_torch_slice.json).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (BATCH, BATCHES_1M, DM_VOCAB, K_TOP, N_BATCHES,  # noqa: E402
                        STAGE, VOCAB_1M, make_corpus, make_corpus_1m,
                        make_queries, stage_device_ms, staged)

def stage_times(events) -> None:
    """Print the device ms of each stage's kernels by bucket
    (chip_smoke.stage_device_ms), the kernels outside every stage under
    "rest"."""
    stages, rest = stage_device_ms(events)
    print("device ms by stage (all batches or chunks):")
    for name, d in sorted(stages.items()) + [("rest: densify, copies",
                                               rest)]:
        parts = {k: v for k, v in d.items() if k != "calls"}
        calls = f"{d['calls']} calls: " if "calls" in d else ""
        print(f"  {sum(parts.values()):9.3f}  {name} ({calls}" + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(parts.items(),
                                               key=lambda kv: -kv[1])) + ")")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("split", "doc-major", "split-1m"),
                    default="split",
                    help="which retrieval path to profile")
    ap.add_argument("--storage", choices=("int8", "hilo"), default="int8",
                    help="impact storage of the split path (hilo: the "
                    "constructor's default)")
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--fused", action="store_const", const=True,
                       dest="fused", help="force K4 on the split path "
                       "(split_index.FUSED_MM True; the card's default)")
    route.add_argument("--unfused", action="store_const", const=False,
                       dest="fused", help="force the library product and "
                       "K1 on the split path (split_index.FUSED_MM False)")
    ap.add_argument("--trace", default="traces/profile_torch_slice.json",
                    help="where to write the Chrome trace")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)

    rng = np.random.default_rng(0)
    if args.path == "split-1m":
        # chip_smoke.py's phase 12: the same corpus and batches.
        corpus = make_corpus_1m(rng)
        batches = [make_queries(rng, n=BATCH, vocab=VOCAB_1M)
                   for _ in range(BATCHES_1M)]
    else:
        vocab = DM_VOCAB if args.path == "doc-major" else 30_000
        corpus = make_corpus(rng, vocab=vocab)
        queries = make_queries(rng, n=BATCH, vocab=vocab)
        brng = np.random.default_rng(7)
        batches = [queries] + [[queries[i] for i in brng.permutation(BATCH)]
                               for _ in range(N_BATCHES - 1)]
    storage = args.storage if args.path == "split" else None
    sidx.FUSED_MM = args.fused
    scorer = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scorer.index(corpus, show_progress=False)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    del corpus
    if (scorer._split is None) != (args.path == "doc-major"):
        sys.exit(f"profile_torch_slice: the corpus did not take the "
                 f"{args.path} path")
    if args.path == "split-1m" and (scorer._split.impact_scale is None or
                                    scorer._split.post2_doc_ids is None):
        sys.exit("profile_torch_slice: the 1M index is not int8 with tier-2")
    scorer.retrieve_many(batches, k=K_TOP)              # warm-up
    # One host batch: a 1,024-query chunk at 1M, a whole batch otherwise.
    unit = batches[1][:scorer._auto_batch_size()]
    unit_name = "chunk" if len(unit) < len(batches[1]) else "batch"
    if args.path != "doc-major":
        def encode(batch):
            return sidx.encode_queries_split(batch, scorer._split)
    else:
        encode = scorer._encode
    print(f"path {args.path}, storage {storage}, fused {sidx.FUSED_MM}; "
          f"index {index_s:.3f} s [{card}]", flush=True)
    if args.path == "doc-major":
        for name, call in (
                ("get_probabilities_batch (2048 queries)",
                 lambda: scorer.get_probabilities_batch(batches[1][:2048])),
                ("retrieve_thresholded (8192 queries, 0.5)",
                 lambda: scorer.retrieve_thresholded(batches[1], 0.5,
                                                     k=K_TOP))):
            call()
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                runs.append((time.perf_counter() - t0) * 1e3)
            print(f"{name}: {sorted(runs)[1]:.2f} ms median of 3 "
                  f"{[round(r, 2) for r in runs]} [{card}]", flush=True)

    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        encode(unit)
    enc_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        scorer._retrieve_launch(unit, K_TOP, False, None)
    launch_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"host per {unit_name} of {len(unit)} queries: encode "
          f"{enc_ms:.2f} ms, launch (encode + copies + enqueue) "
          f"{launch_ms:.2f} ms; launch + drain {drain_ms:.2f} ms [{card}]",
          flush=True)

    restore = staged(sidx) if args.path != "doc-major" else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.retrieve_many(batches, k=K_TOP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if restore is not None:
        restore()
    print(f"retrieve_many under the profiler: {wall_ms:.2f} ms for "
          f"{len(batches)} x {BATCH} queries [{card}]", flush=True)

    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # The stage ranges' spans on the device are not kernels.
    kernels = [e for e in device if not e.name.startswith(STAGE)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_ms = busy / 1e3
    print(f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall: "
          f"idle share {1 - busy_ms / wall_ms:.3f} [{card}]", flush=True)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    print("device ms by kernel (all batches):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:30]:
        print(f"  {ms:9.3f}  {name[:110]}")
    if restore is not None:
        stage_times(prof.events())
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=25, max_name_column_width=60))
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
