#!/usr/bin/env python3
"""Run the benchmark harness of ``benchmarks/`` on the PyTorch port and
hold it to the JAX package's results.

    python3 scripts/run_benchmarks_torch.py [--only NAME ...] [--out DIR]
        [--device {cuda,cpu}] [--gates]

The import alias of ``benchmarks_torch/_alias.py`` maps
``bayesian_bm25_tpu[.sub]`` to ``bayesian_bm25_tpu_torch[.sub]`` and
``benchmarks.hybrid_beir`` to ``benchmarks_torch.hybrid_beir`` in this
process, so the JAX package's scripts run unchanged on the port. The
parts, each run once in this process:

  * the 12 scripts of ``benchmarks_torch.SCRIPTS``, and the copy
    ``benchmarks_torch/hybrid_beir.py`` with its defaults: each output is
    held to the JAX package's recorded one
    (``tests/data/benchmarks_jax/<name>.txt``,
    ``scripts/record_jax_benchmarks.py``) by
    ``run_examples_torch.compare``, under its masks and ``VOLATILE``'s;
    a script with no recording must exit 0;
  * ``sharded_scaling``: ``benchmarks_torch/sharded_scaling.py``, its
    shards on the one device; must exit 0;
  * ``mini_beir``: ``run_dataset`` on ``benchmarks/data/mini_beir`` at
    the frozen test's arguments (k=5, R=50), every method's NDCG@5 within
    ``FROZEN_TOL`` of ``tests/data/mini_beir_frozen.json``;
    ``mini_beir_ivf``: the same with ``use_ivf`` and
    ``vpt_query_gating``, every NDCG@5 in [0, 1];
  * ``ci_hard``, ``ci_hard_regime``, ``ci_vpt``: the one-seed gates of
    ``tests/test_benchmarks.py``, their own code and assertions;
  * with ``--gates`` (instead of the above): ``ordering_gate``,
    ``attn_gate`` and ``vpt_gate``, ``benchmarks/ordering_study.py``
    (without and with ``--regimes``) and
    ``benchmarks/vpt_ordering_study.py`` unchanged at the configuration
    of their artifacts in ``benchmarks/results/``, each writing
    ``DIR/<name>.json`` with the device added to its ``config`` and
    ``DIR/<name>_rankings.json`` (each method's top-k ids a query, by
    dataset), and printing ``run_dataset``'s stage log.

The synthetic datasets of ``benchmarks/utils.py`` are drawn as numpy 2.0
draws them (``benchmarks_torch/data.py``), as they were for the JAX
package's recordings and artifacts, whatever numpy this machine has.
``--device`` is the device of every part: ``run_dataset`` is bound to it,
and ``cpu`` makes the port's default device the CPU for the scripts that
name none. ``DIR`` (default ``build/benchmarks_torch``) gets each part's
output as ``<name>.txt`` and ``summary.json``: per part its status,
seconds, compared lines and kernel launches. Exits 1 if a part raises,
differs or fails a gate.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import importlib.util
import io
import json
import math
import re
import runpy
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

import run_examples_torch as examples  # noqa: E402

from benchmarks_torch import SCRIPTS  # noqa: E402
from benchmarks_torch._alias import card_means_cpu, install_alias  # noqa: E402
from benchmarks_torch.data import pin_zipf, zipf_is_numpy20  # noqa: E402

REFERENCE = ROOT / "tests" / "data" / "benchmarks_jax"
MINI_BEIR = ROOT / "benchmarks" / "data" / "mini_beir"
FROZEN = ROOT / "tests" / "data" / "mini_beir_frozen.json"
FROZEN_TOL = 1e-6             # tests/test_benchmarks.py's tolerance
# tests/test_benchmarks.py's one-seed gates: part -> test class.
CI_GATES = {"ci_hard": "TestHardFamilyOrderingGate",
            "ci_hard_regime": "TestHardRegimeAttentionGate",
            "ci_vpt": "TestVPTDiscriminativeGate"}
# The gate studies at their artifacts' configuration: part -> argv.
GATES = {
    "ordering_gate": ["benchmarks/ordering_study.py", "--docs", "20000",
                      "--queries", "256", "-R", "1000"],
    "attn_gate": ["benchmarks/ordering_study.py", "--regimes", "--docs",
                  "10000", "--queries", "192", "-R", "500"],
    # Its default --device is cpu, which imports jax: "auto" names none.
    "vpt_gate": ["benchmarks/vpt_ordering_study.py", "--device", "auto",
                 "--docs", "6000", "--queries", "96", "--topics", "48",
                 "-R", "1000"],
}
GATE_ARGS = ["--seeds", "7", "8", "9", "-k", "10"]
DEFAULT_PARTS = (*SCRIPTS, "hybrid_beir", "sharded_scaling", "mini_beir",
                 "mini_beir_ivf", *CI_GATES)
# Timings the scripts print without a unit, masked in both outputs before
# run_examples_torch.compare (which masks a time with its unit, and q/s):
# the decimals of a table titled "Timing" (benchmarks/common.print_table;
# its rows' spacing, which follows the widest cell, is collapsed), and a
# speedup ratio of two times.
TIMING_TABLE = re.compile(r"=== Timing\b")
DECIMAL = re.compile(r"\d+\.\d+")
RATIO = re.compile(r"\(\d+\.\d+x\)")


def mask_timings(text: str) -> str:
    lines, timing = [], False
    for line in text.splitlines():
        if line.startswith("=== "):
            timing = bool(TIMING_TABLE.match(line))
        elif not line.strip():
            timing = False
        elif timing:
            line = " ".join(DECIMAL.sub("<time>", line).split())
        lines.append(RATIO.sub("(<ratio>)", line))
    return "\n".join(lines) + "\n"


def script_path(name: str) -> str:
    """A script of ``SCRIPTS``, or its counterpart in ``benchmarks_torch/``
    where it reads what the port holds in another type."""
    mine = f"benchmarks_torch/{name}.py"
    return mine if (ROOT / mine).exists() else f"benchmarks/{name}.py"


def bind_run_dataset(hb, log_stages: bool, **bound_kw) -> dict:
    """Bind ``hb.run_dataset`` (``benchmarks_torch.hybrid_beir``'s, which
    the studies import as ``benchmarks.hybrid_beir``) to ``bound_kw``
    (the device); with ``log_stages`` it prints its stage log whatever
    the caller asks. Returns a dict that holds the last call's results
    and, by dataset name, each method's ranked top-k ids a query."""
    run, evaluate = hb.run_dataset, hb.evaluate_run
    last = {"rankings": {}}
    runs = []

    def evaluate_run(method_run, qrels, k=10):
        runs.append({q: ids[:k] for q, ids in method_run.items()})
        return evaluate(method_run, qrels, k=k)

    @functools.wraps(run)
    def bound(ds, *args, **kw):
        kw.update(bound_kw)
        if log_stages:
            kw["verbose"] = True
        runs.clear()
        last["results"] = run(ds, *args, **kw)
        # run_dataset evaluates its methods in sorted order, and only them
        # unless it tunes.
        if not kw.get("tune"):
            last["rankings"][ds.name] = dict(zip(sorted(last["results"]),
                                                 runs))
        return last["results"]

    hb.run_dataset, hb.evaluate_run = bound, evaluate_run
    return last


def run_main(argv: list[str]) -> None:
    """Run a script as __main__ with ``argv``; a nonzero exit raises."""
    saved = sys.argv
    sys.argv = [str(ROOT / argv[0]), *argv[1:]]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as exc:
        if exc.code not in (None, 0):
            raise RuntimeError(f"{argv[0]} exited {exc.code}") from None
    finally:
        sys.argv = saved


def check_mini_beir(run_dataset) -> None:
    from benchmarks.utils import load_beir_dataset

    frozen = json.loads(FROZEN.read_text())
    res = run_dataset(load_beir_dataset(str(MINI_BEIR)), k=5, R=50,
                      verbose=True)
    missing = sorted(set(frozen) - set(res))
    worst = 0.0
    for method, want in sorted(frozen.items()):
        if method not in res:
            continue
        got = res[method]["ndcg@5"]
        worst = max(worst, abs(got - want))
        print(f"  {method:<28} {got:.12f} frozen {want:.12f} "
              f"|d| {abs(got - want):.3e}")
    print(f"{len(frozen) - len(missing)} of {len(frozen)} methods; largest "
          f"|d| {worst:.3e} (tolerance {FROZEN_TOL:g})")
    if missing or worst > FROZEN_TOL:
        raise AssertionError(f"mini BEIR: missing {missing}, largest |d| "
                             f"{worst:.3e} > {FROZEN_TOL:g}")


def check_mini_beir_ivf(run_dataset) -> None:
    from benchmarks.utils import load_beir_dataset

    res = run_dataset(load_beir_dataset(str(MINI_BEIR)), k=5, R=50,
                      verbose=True, use_ivf=True, vpt_query_gating=True)
    bad = [m for m, v in res.items()
           if not (math.isfinite(v["ndcg@5"]) and 0 <= v["ndcg@5"] <= 1)]
    for method, v in sorted(res.items()):
        print(f"  {method:<28} {v['ndcg@5']:.12f}")
    print(f"{len(res)} methods with the IVF; NDCG@5 outside [0, 1]: {bad}")
    if len(res) < 37 or bad:
        raise AssertionError(f"mini BEIR with the IVF: {len(res)} methods, "
                             f"outside [0, 1]: {bad}")


def check_ci_gate(test_class: str, last: dict) -> None:
    spec = importlib.util.spec_from_file_location(
        "benchmark_tests", ROOT / "tests" / "test_benchmarks.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cls = getattr(mod, test_class)
    (test,) = [n for n in vars(cls) if n.startswith("test_")]
    try:
        getattr(cls(), test)()
    finally:
        for method, v in sorted(last.get("results", {}).items(),
                                key=lambda kv: -kv[1]["ndcg@10"]):
            print(f"  {method:<28} {v['ndcg@10']:.6f}")
    print(f"{test_class}.{test}: passed")


def card_name(device: str) -> str:
    if device != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def run_part(name: str, args, out_dir: Path, last: dict, card: str):
    """(stdout, traceback or None, seconds) of one part."""
    out = io.StringIO()
    t0 = time.perf_counter()
    err = None
    # run_dataset as bind_run_dataset bound it.
    run_dataset = importlib.import_module(
        "benchmarks_torch.hybrid_beir").run_dataset
    last["rankings"].clear()
    try:
        with contextlib.redirect_stdout(out):
            if name in SCRIPTS:
                run_main([script_path(name)])
            elif name == "hybrid_beir":
                # Its --device takes "cpu" or "auto" (the card).
                run_main(["benchmarks_torch/hybrid_beir.py", "--device",
                          "cpu" if args.device == "cpu" else "auto"])
            elif name == "sharded_scaling":
                run_main(["benchmarks_torch/sharded_scaling.py", "--device",
                          args.device])
            elif name == "mini_beir":
                check_mini_beir(run_dataset)
            elif name == "mini_beir_ivf":
                check_mini_beir_ivf(run_dataset)
            elif name in CI_GATES:
                check_ci_gate(CI_GATES[name], last)
            else:
                path = out_dir / f"{name}.json"
                try:
                    run_main([*GATES[name], *GATE_ARGS, "-o", str(path)])
                finally:
                    if path.exists():
                        art = json.loads(path.read_text())
                        art["config"].update(device=args.device, card=card)
                        path.write_text(json.dumps(art, indent=2))
                    (out_dir / f"{name}_rankings.json").write_text(
                        json.dumps(last["rankings"]))
    except Exception:  # a part's failure is reported
        err = traceback.format_exc()
    return out.getvalue(), err, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", metavar="NAME",
                    help="run these parts only")
    ap.add_argument("--out", default=str(ROOT / "build" / "benchmarks_torch"),
                    help="where the outputs and summary.json go")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--gates", action="store_true",
                    help="run the three gate studies instead")
    args = ap.parse_args(argv)
    known = [*DEFAULT_PARTS, *GATES]
    names = args.only or list(GATES if args.gates else DEFAULT_PARTS)
    if set(names) - set(known):
        raise SystemExit(f"run_benchmarks_torch: no part "
                         f"{sorted(set(names) - set(known))}")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    install_alias()
    if args.device == "cpu":
        card_means_cpu()
    import benchmarks.utils

    pin_zipf(benchmarks.utils)
    card = card_name(args.device)
    print(f"numpy {np.__version__}: its zipf draws "
          f"{'as' if zipf_is_numpy20() else 'otherwise than'} numpy 2.0's; "
          "the corpora are drawn with numpy 2.0's", flush=True)
    last = bind_run_dataset(
        importlib.import_module("benchmarks_torch.hybrid_beir"),
        log_stages=bool(set(names) & set(GATES)), device=args.device)
    summary = {"device": args.device, "card": card, "numpy": np.__version__,
               "parts": {}}
    bad = 0
    for name in names:
        before = examples.launches()
        got, err, secs = run_part(name, args, out_dir, last, card)
        launched = {k: v - before[k] for k, v in examples.launches().items()}
        (out_dir / f"{name}.txt").write_text(got)
        ref = REFERENCE / f"{name}.txt"
        differ, last_digit = (
            examples.compare(mask_timings(got), mask_timings(ref.read_text()))
            if ref.exists() else ([], []))
        ok = err is None and not differ
        bad += not ok
        summary["parts"][name] = dict(
            ok=ok, seconds=round(secs, 3), error=err, recorded=ref.exists(),
            differ=differ, last_digit=last_digit, launches=launched)
        print(f"{name}: {'ok' if ok else 'FAILED'}, {secs:.2f} s, "
              f"{len(got.splitlines())} lines, "
              + (f"{len(differ)} differ, {len(last_digit)} last-digit"
                 if ref.exists() else "not recorded")
              + f", launches {json.dumps(launched)}", flush=True)
        if err:
            print(err, file=sys.stderr, flush=True)
        for line in differ:
            print(f"  differs at line {line[0]}: JAX {line[1]!r} / port "
                  f"{line[2]!r}", flush=True)
        for line in last_digit:
            print(f"  last digit at line {line[0]}: JAX {line[1]!r} / "
                  f"port {line[2]!r}", flush=True)
    summary["launches"] = examples.launches()
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"{len(names) - bad} of {len(names)} parts ok on {card}; kernel "
          f"launches {json.dumps(summary['launches'])}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
