#!/usr/bin/env python3
"""Run the JAX package's examples, unchanged, against the PyTorch port,
and compare their output with the JAX package's.

    python3 scripts/run_examples_torch.py [--only NAME ...] [--out DIR]

A meta-path finder, installed in this process only
(``benchmarks_torch/_alias.py``), maps ``bayesian_bm25_tpu`` and every
``bayesian_bm25_tpu.<sub>`` to ``bayesian_bm25_tpu_torch.<sub>``. Each
``examples/*.py`` then runs through ``runpy.run_path(..., run_name="__main__")`` with its standard
output captured. ``examples/sharded_retrieval.py`` sets XLA flags and
calls ``jax.devices()`` itself, so the port's counterpart
``scripts/torch_examples/sharded_retrieval.py`` runs in its place. The
examples get the port's defaults: they compute on the card.

Each output is written to ``DIR/<name>.txt`` (default
``build/examples_torch``) and compared with the JAX package's
recorded output, ``tests/data/examples_jax/<name>.txt``
(``scripts/record_jax_examples.py``; JAX on the CPU in float64), by
:func:`compare`. ``DIR/summary.json`` holds, per example, its exit
status, seconds, the lines that differ and the lines whose numbers moved
by their last printed digit, and the port's kernel launches over all
examples. Exits 1 if an example raised or differs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import runpy
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
COUNTERPARTS = Path(__file__).resolve().parent / "torch_examples"
REFERENCE = ROOT / "tests" / "data" / "examples_jax"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch._alias import install_alias  # noqa: E402

# The fields that differ between any two runs, masked before lines are
# compared: (what, pattern, replacement).
VOLATILE = (
    ("wall time", re.compile(r" *\d+\.\d+ ?m?s\b"), " <time>"),
    ("throughput", re.compile(r" *\d+ queries/sec"), " <q/s>"),
    ("temporary path", re.compile(r"(?<![\w/])/(?:[\w.-]+/)+[\w.-]+"),
     "<path>"),
    # JAX's Mesh.shape is an OrderedDict, the port's ShardMesh.shape a dict.
    ("mesh repr", re.compile(r"OrderedDict\((\{[^}]*\})\)"), r"\1"),
    # JAX's virtual CPU mesh against the port's shards on the card.
    ("device platform", re.compile(r"(devices: \d+ x )\w+"), r"\1<platform>"),
)
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def mask(line: str) -> str:
    for _, pat, rep in VOLATILE:
        line = pat.sub(rep, line)
    return line


def _decimals(tok: str) -> int | None:
    """Digits after the point of a printed number; None for an integer."""
    mant = re.split("[eE]", tok)[0]
    return len(mant.split(".")[1]) if "." in mant else None


def _numbers_match(a: str, b: str) -> tuple[bool, bool]:
    """(match, exact) for two printed numbers: integers (ids, counts)
    must be equal; decimals may differ by one unit of the coarser
    printed last digit (a float32 sum order can move it), and are
    reported as not exact then."""
    if a == b:
        return True, True
    da, db = _decimals(a), _decimals(b)
    if da is None or db is None:
        return False, False
    ea = re.split("[eE]", a)[1:] or ["0"]
    eb = re.split("[eE]", b)[1:] or ["0"]
    unit = max(10.0 ** (-da + int(ea[0])), 10.0 ** (-db + int(eb[0])))
    return abs(float(a) - float(b)) <= unit * (1 + 1e-9), False


def compare(got: str, want: str) -> tuple[list, list]:
    """The JAX output ``want`` against the port's ``got``, line by line
    after masking the VOLATILE fields. Returns (lines that differ, lines
    whose numbers moved by their last printed digit), each entry
    [line number, JAX line, port line]."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    differ, last_digit = [], []
    for i in range(max(len(g_lines), len(w_lines))):
        w = w_lines[i] if i < len(w_lines) else None
        g = g_lines[i] if i < len(g_lines) else None
        if w is None or g is None:
            differ.append([i + 1, w, g])
            continue
        wm, gm = mask(w), mask(g)
        if wm == gm:
            continue
        if NUMBER.split(wm) != NUMBER.split(gm):
            differ.append([i + 1, w, g])
            continue
        checks = [_numbers_match(a, b) for a, b in
                  zip(NUMBER.findall(wm), NUMBER.findall(gm))]
        if not all(ok for ok, _ in checks):
            differ.append([i + 1, w, g])
        elif not all(exact for _, exact in checks):
            last_digit.append([i + 1, w, g])
    return differ, last_digit


def example_paths(only=None) -> list[Path]:
    paths = [COUNTERPARTS / p.name if (COUNTERPARTS / p.name).exists()
             else p for p in sorted(EXAMPLES.glob("*.py"))]
    if only:
        missing = set(only) - {p.stem for p in paths}
        if missing:
            raise SystemExit(f"run_examples_torch: no example {sorted(missing)}")
        paths = [p for p in paths if p.stem in only]
    return paths


def launches() -> dict:
    from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                                cuda_matmul, cuda_reduce,
                                                cuda_topk)

    return {"block_max": cuda_reduce.launches,
            "row_gather": cuda_gather.launches, "topk": cuda_topk.launches,
            "bm25_compare": cuda_bm25.launches,
            "impact_matmul_bmax": cuda_matmul.launches}


def run_one(path: Path) -> tuple[str, str | None, float]:
    """Run one example as __main__; (its stdout, the traceback or None,
    seconds)."""
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [str(path)]
    t0 = time.perf_counter()
    err = None
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(path), run_name="__main__")
    except (Exception, SystemExit):  # an example's failure is reported
        err = traceback.format_exc()
    finally:
        sys.argv = argv
    return out.getvalue(), err, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", metavar="NAME",
                    help="run these examples (file stems) only")
    ap.add_argument("--out", default=str(ROOT / "build" / "examples_torch"),
                    help="where the outputs and summary.json go")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    install_alias()
    summary = {"examples": {}}
    bad = 0
    for path in example_paths(args.only):
        name = path.stem
        got, err, secs = run_one(path)
        (out_dir / f"{name}.txt").write_text(got)
        differ, last_digit = compare(got, (REFERENCE / f"{name}.txt")
                                     .read_text())
        ok = err is None and not differ
        bad += not ok
        summary["examples"][name] = dict(
            ok=ok, seconds=round(secs, 3), error=err, differ=differ,
            last_digit=last_digit, source=str(path.relative_to(ROOT)))
        print(f"{name}: {'ok' if ok else 'FAILED'}, {secs:.2f} s, "
              f"{len(got.splitlines())} lines, {len(differ)} differ, "
              f"{len(last_digit)} last-digit", flush=True)
        if err:
            print(err, file=sys.stderr, flush=True)
        for line in differ:
            print(f"  differs at line {line[0]}: JAX {line[1]!r} / port "
                  f"{line[2]!r}", flush=True)
        for line in last_digit:
            print(f"  last digit at line {line[0]}: JAX {line[1]!r} / "
                  f"port {line[2]!r}", flush=True)
    summary["launches"] = launches()
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print(f"{len(summary['examples']) - bad} of {len(summary['examples'])} "
          f"examples ok; kernel launches {json.dumps(summary['launches'])}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
