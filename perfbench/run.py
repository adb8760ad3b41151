#!/usr/bin/env python3
"""One run of one benchmark cell of ``bayesian_bm25_tpu_torch`` on the
card it is started on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<mix>.json``); each metric is read by
``perfbench/metrics/<metric>.py`` and the comparison's limits are
``perfbench/limits/<cell>.json``. A run generates the corpus and the
request pool from the seed, indexes and warms up (set-up), drives the
cell's entry for ``--seconds``, compares a sample of the answers with
the plain reference, and prints one JSON line last on standard output.
It needs a CUDA card: without one it exits 3 and prints no result.

Standard error gives the CPUs the run may use and torch's intra-op
threads, and the queries completed in each ``SLOT_S`` seconds of the
window: whether a run was slow throughout or stalled."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)   # the checkout's root, not perfbench/

FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_bm25_tpu")
EXIT_NO_CARD, EXIT_FORBIDDEN, EXIT_FOREIGN_PORT = 3, 4, 5
SLOT_S = 5   # seconds of the window in each slot of the completions log


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules that the benchmark may not
    load, compared whole: ``bayesian_bm25_tpu_torch`` is not
    ``bayesian_bm25_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc); 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def host_line() -> str:
    """The CPUs this process may use and torch's intra-op threads."""
    import torch

    return (f"host: {len(os.sched_getaffinity(0))} CPUs allowed; torch "
            f"intra-op threads {torch.get_num_threads()}")


def pin_caches() -> None:
    """Every cache a run might write, at fixed paths inside the checkout
    (the port builds its own libraries into bayesian_bm25_tpu_torch/_build)."""
    cache = ROOT / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def import_port():
    """The port from this checkout, never a copy installed elsewhere."""
    import bayesian_bm25_tpu_torch as port

    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        log(f"bayesian_bm25_tpu_torch loaded from {where}, outside {ROOT}")
        raise SystemExit(EXIT_FOREIGN_PORT)
    return port


def card_info(chips: int) -> dict:
    import subprocess

    import torch

    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        info["power_limit_w"] = float(out[0].split(",")[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        info["power_limit_w"] = None
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", spec: dict | None = None,
             config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, wrap=None,
             started: float | None = None,
             base: Path | None = None) -> tuple[dict, list]:
    """Set-up, window, comparison: (result line, check lines). Tests
    pass ``device="cpu"``, smaller ``config`` / ``traffic``, a ``wrap``
    that breaks the scorer, and ``base``, a copy of ``perfbench/``
    whose files are found by name; the command checks for the card
    before it calls this."""
    import numpy as np
    import torch

    from perfbench import check, gen, plugins
    from perfbench.reference import Reference

    started = time.perf_counter() if started is None else started
    base = plugins.HERE if base is None else base
    spec = plugins.benchmark() if spec is None else spec
    cell = plugins.cell(name, spec, base)
    config = cell["config"] if config is None else config
    traffic = cell["traffic"] if traffic is None else traffic
    limits = (plugins.load_json("limits", name, base) if limits is None
              else limits)
    loop = plugins.load_module("loops", traffic["loop"], base)
    chips = int(cell["workload"]["chips"])
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    r_corpus, r_traffic, r_check = gen.streams(seed)
    t = time.perf_counter()
    corpus = gen.corpus(config, r_corpus)
    pool = gen.pool(config, traffic, r_traffic)
    names = gen.token_names(int(max(corpus.ids.max(),
                                    pool.texts.ids.max())) + 1)
    tokens = gen.to_tokens(corpus, names)
    pool.tokenize(names)
    log(f"setup: generation {time.perf_counter() - t:.3f} s "
        f"({len(corpus)} docs, {len(corpus.ids)} tokens, "
        f"mean length {corpus.lengths().mean():.3f}; {len(pool)} requests, "
        f"{len(pool.texts)} queries, mean query length "
        f"{pool.texts.lengths().mean():.3f})")

    t = time.perf_counter()
    import_port()
    from bayesian_bm25_tpu_torch import BayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import native
    log(f"setup: import {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    native.load()
    if cuda:
        from bayesian_bm25_tpu_torch.engine import _cuda_build
        _cuda_build.lib()
        torch.cuda.reset_peak_memory_stats()
    log(f"setup: libraries {time.perf_counter() - t:.3f} s")

    scorer = BayesianBM25Scorer(**config["scorer"], device=device)
    t = time.perf_counter()
    scorer.index(tokens)
    sync()
    index_s = time.perf_counter() - t
    log(f"setup: index {index_s:.3f} s")
    if wrap is not None:
        scorer = wrap(scorer)
    t = time.perf_counter()
    loop.warm(scorer, pool, traffic)
    sync()
    log(f"setup: warm-up {time.perf_counter() - t:.3f} s")

    tracer = None
    if trace:
        from perfbench.tracing import Tracer
        tracer = Tracer(scorer, traffic, seconds, device)
        tracer.install()
    setup_s = time.perf_counter() - started
    win = loop.run(scorer, pool, traffic, seconds,
                   tick=tracer.tick if tracer else None)
    sync()
    if tracer is not None:
        tracer.finish()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {win.attempted()} requests handed, "
        f"{len(win.completed())} completed in {seconds} s, "
        f"{len(win.hand) - len(win.completed())} after the close")
    log(f"window: queries completed in each {SLOT_S} s: "
        + " ".join(str(n) for n in win.completed_per(SLOT_S)))
    bad = forbidden_modules()
    if bad:
        log(f"modules the benchmark may not load: {', '.join(bad)}")
        raise SystemExit(EXIT_FORBIDDEN)

    rec = dict(window=win, setup_s=setup_s, index_s=index_s,
               peak_bytes=peak,
               trace=tracer.record(win) if tracer is not None else None)
    if rec["trace"] is not None:
        t_rec = rec["trace"]
        log(f"trace: slice {t_rec['slice_s']!r} s, {t_rec['requests']} "
            f"requests, {t_rec['queries']} queries, busy "
            f"{t_rec['busy_s']!r} s; device ms by stage: " + "; ".join(
                f"{st} x{d.get('calls', 0)} "
                f"{sum(v for b, v in d.items() if b != 'calls'):.3f}"
                for st, d in sorted(t_rec["stages"].items())))

    # The sample of answers, then the program's state is freed and the
    # reference runs in its place.
    sizes = np.array(win.sizes, dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(sizes)])
    pick = check.sample_rows(int(first[-1]), int(traffic["check_rows"]),
                             r_check)
    req = np.searchsorted(first, pick, side="right") - 1
    queries, got_ids, got_probs = [], [], []
    for i, j in zip(req.tolist(), (pick - first[req]).tolist()):
        queries.append(pool.texts.row(int(pool.starts[win.pool_index[i]]) + j))
        ans = win.answers[i]
        got_ids.append(None if ans is None else ans[0][j])
        got_probs.append(None if ans is None else ans[1][j])
    k = int(traffic["k"])
    del scorer, tokens, tracer
    win.answers = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    sc = config["scorer"]
    ref = Reference(corpus, k1=sc.get("k1", 1.2), b=sc.get("b", 0.75),
                    device=device)
    cal = ref.calibration(corpus, base_rate_auto=sc.get("base_rate") == "auto",
                          stored=config.get("reference", {}).get("base_rate"))
    numbers = check.compare(ref, cal, queries, got_ids, got_probs, k)
    log(f"reference: {time.perf_counter() - t:.3f} s for {len(queries)} "
        f"answers; alpha {cal[0]!r}, beta {cal[1]!r}, base rate {cal[2]!r}")
    log("numbers: " + ", ".join(f"{n} {v!r}" for n, v in numbers.items()))
    correct = (check.verdict(numbers, limits) and win.failed() == 0
               and len(win.completed()) > 0)

    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        reader = plugins.load_module("metrics", m["name"], base)
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = card_info(chips) if cuda else dict(platform="cpu", kind="cpu",
                                             count=1)
    dev["memory_peak_bytes"] = int(peak)
    result = dict(correct=bool(correct), attempted=win.attempted(),
                  failed=win.failed(), metrics=metrics, device=dev)
    t_rec = rec["trace"]
    if trace and t_rec is not None:
        dev["busy_s"] = t_rec["busy_s"]
        dev["window_s"] = t_rec["slice_s"]
        result["breakdown"] = dict(
            device_ops=[[n, v] for n, v in t_rec["device_ops"]],
            idle_gaps=[[n, v] for n, v in t_rec["idle_gaps"]])
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                        for n in check.compared(limits)}
    return result, check.lines(numbers, limits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = time.perf_counter() - process_age_s()
    pin_caches()

    from perfbench import plugins
    chips = int(plugins.cell(args.workload, plugins.benchmark())
                ["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return EXIT_NO_CARD
    log(host_line())

    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), started=started)
    bad = forbidden_modules()
    if bad:
        log(f"modules the benchmark may not load: {', '.join(bad)}")
        return EXIT_FORBIDDEN
    info = result["device"]
    log(f"card: {info['kind']}, power limit {info.get('power_limit_w')} W")
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
