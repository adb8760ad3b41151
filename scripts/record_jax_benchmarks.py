#!/usr/bin/env python3
"""Record the JAX package's benchmark output as the reference for the
PyTorch port.

    python3 scripts/record_jax_benchmarks.py [--only NAME ...]

Runs each of ``benchmarks_torch.SCRIPTS`` and ``benchmarks/hybrid_beir.py``
with its defaults in its own subprocess with JAX on the CPU in float64
(``JAX_PLATFORMS=cpu JAX_ENABLE_X64=1``: the precision of the port's
library) and writes its standard output to
``tests/data/benchmarks_jax/<name>.txt``. A run that does not end within
``LIMIT_S`` seconds, or whose numbers are all timings (``UNRECORDED``), is
not recorded: the port's run of it is held to exit 0 only. A machine with
a card but no JAX compares the port's runs with these files
(``scripts/run_benchmarks_torch.py``, ``chip_smoke.py`` phase 22,
``tests/test_torch_benchmarks.py``).

    python3 scripts/record_jax_benchmarks.py --rankings GATE
        [--seeds N ...] --out DIR

runs one gate study of ``scripts/run_benchmarks_torch.py``'s ``GATES``
(unchanged, at its artifact's configuration) in this process on the JAX
package with JAX on the CPU and x64 off, the precision its artifact in
``benchmarks/results/`` was made at (``--x64``: on, the precision of the
port's library), and writes ``DIR/GATE.json`` and
each method's rankings, ``DIR/GATE_rankings.json``, as the port's runner
writes them (``scripts/compare_gate_rankings.py`` compares the two).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks_torch import SCRIPTS, data  # noqa: E402

OUT = ROOT / "tests" / "data" / "benchmarks_jax"
LIMIT_S = 120
# Every number scalability.py prints is a time, a rate or a size that
# follows from one.
UNRECORDED = {"scalability": "prints timings only"}


def record(name: str) -> tuple[str, str, float, str]:
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, str(ROOT / "benchmarks" / f"{name}.py")],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        return name, f"not recorded: over {LIMIT_S} s", LIMIT_S, ""
    secs = time.perf_counter() - t0
    if run.returncode:
        return name, f"exit {run.returncode}", secs, run.stderr
    (OUT / f"{name}.txt").write_text(run.stdout)
    return name, "recorded", secs, ""


def record_rankings(gate: str, seeds: list[str], out: Path,
                    x64: bool) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    sys.path.insert(0, str(ROOT / "scripts"))
    import run_benchmarks_torch as runner

    import benchmarks.hybrid_beir as hb
    import benchmarks.utils

    runner.pin_zipf(benchmarks.utils)
    last = runner.bind_run_dataset(hb, log_stages=True)
    out.mkdir(parents=True, exist_ok=True)
    try:
        runner.run_main([*runner.GATES[gate], "--seeds", *seeds, "-k", "10",
                         "-o", str(out / f"{gate}.json")])
    finally:
        (out / f"{gate}_rankings.json").write_text(
            json.dumps(last["rankings"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", metavar="NAME")
    ap.add_argument("--rankings", metavar="GATE",
                    help="one gate study's rankings instead")
    ap.add_argument("--seeds", nargs="+", default=["7", "8", "9"])
    ap.add_argument("--x64", action="store_true",
                    help="with --rankings: float64, the port's precision")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "gates_jax")
    args = ap.parse_args()
    # The scripts draw their corpora with numpy's own zipf; the port's
    # runner draws them with numpy 2.0's (benchmarks_torch/data.py).
    if not data.zipf_is_numpy20():
        sys.exit(f"record_jax_benchmarks: numpy {np.__version__} draws "
                 "zipf otherwise than numpy 2.0; record under numpy 2.0")
    if args.rankings:
        record_rankings(args.rankings, args.seeds, args.out, args.x64)
        return
    names = [n for n in (*SCRIPTS, "hybrid_beir")
             if n not in UNRECORDED and (not args.only or n in args.only)]
    OUT.mkdir(parents=True, exist_ok=True)
    failed = []
    with ThreadPoolExecutor(max_workers=3) as pool:
        for name, what, secs, err in pool.map(record, names):
            print(f"{name}: {what}, {secs:.1f} s", flush=True)
            if what.startswith("exit"):
                failed.append(name)
                print(err[-4000:], file=sys.stderr)
    if failed:
        sys.exit(f"record_jax_benchmarks: {failed} failed")


if __name__ == "__main__":
    main()
