#!/usr/bin/env python3
"""Run the JAX package's own test files, unchanged, against the PyTorch
port, and hold their failures to a pinned table.

    python3 scripts/run_jax_suites_torch.py [--device cuda|cpu]
        [--set library] [--set scorer] [--out DIR] [--timeout S]

The files that import nothing of JAX but ``bayesian_bm25_tpu`` names,
numpy and pytest run in one child process,
``python -m pytest <files> -p jax_suites_plugin --noconftest``, under the
import alias of ``scripts/jax_suites_plugin.py``: every
``bayesian_bm25_tpu[.sub]`` resolves to the port's module of that name.
``--noconftest`` keeps ``tests/conftest.py`` out (it imports jax). Two
sets: ``library`` (the files that build no index: theorems, fusion,
debug, metrics, calibration, probability, vectors, VPT, compat, cost
model, diagnostics, the native encoder; and the reference-oracle files,
which skip without the reference tree) and ``scorer`` (the files that
index a corpus and retrieve). ``tests/test_benchmarks.py`` is in
neither: ``scripts/run_benchmarks_torch.py`` runs the harness it tests.

``--device cuda`` (the default) gives the files the port's defaults:
every scorer and op they call computes on the card, through the
kernels. Where a test calls ``np.asarray`` on a CUDA tensor, the plugin
copies it to the host, as JAX's device arrays convert, so that the
test's own comparisons run. ``--device cpu`` makes the card mean the
CPU in the child (``card_means_cpu``), with one torch thread.

The table, ``tests/data/jax_suites_torch/differences.json``, names a
test id, the devices it holds on, a class and a reason in each entry.
Class ``T`` entries name the tests that need the host copy (and pass
with it); the plugin marks the others, the tests that fail,
``xfail(strict=True)`` for their devices, so pytest itself fails the
child on a failure the table does not list or a listed test that
passes. ``DIR/summary.json`` (default ``build/jax_suites_torch``) holds,
for each file, its passed, failed, xfailed (listed) and skipped counts,
seconds, failed and xfailed ids and the ids that needed the host copy;
the collected ids; the kernel launches over the run; and the modules of
the real JAX package and of jax the child held (none is allowed). Exits
1 when the child fails, when the host copies differ from the table's
``T`` entries for this device, when an entry names a test the run did
not collect, or when the child held a module of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = Path(__file__).resolve().parent
TABLE = ROOT / "tests" / "data" / "jax_suites_torch" / "differences.json"

SETS = {
    "library": [
        "test_calibration.py", "test_compat.py", "test_cost_model.py",
        "test_debug.py", "test_debug_breadth.py", "test_debug_formatters.py",
        "test_fusion.py", "test_fusion_breadth.py",
        "test_fusion_learners_extra.py", "test_gradients_extra.py",
        "test_metrics.py", "test_metrics_probability_breadth.py",
        "test_native_encoder.py", "test_paper_theorems.py",
        "test_prior_aware.py", "test_probability.py",
        "test_reference_oracle.py", "test_reference_oracle2.py",
        "test_search_diagnostics.py", "test_theorems_extra.py",
        "test_theorems_fusion2.py", "test_theorems_neural.py",
        "test_theorems_pruning2.py", "test_vector_index.py",
        "test_vector_probability.py", "test_vpt_breadth.py",
        "test_vpt_routing.py",
    ],
    "scorer": [
        "test_bm25_golden.py", "test_bm25l_plus.py", "test_coarse_tier.py",
        "test_doc_mask.py", "test_engine_fuzz.py", "test_jsonl_loader.py",
        "test_light_heavy.py", "test_mid_tier.py", "test_multi_field.py",
        "test_multi_field_breadth.py", "test_score_scale.py",
        "test_scorer.py", "test_scorer_breadth.py", "test_scorer_extra.py",
        "test_tokenize.py", "test_wand_bmw.py",
    ],
}


def files_of(sets) -> list[str]:
    return [f"tests/{name}" for s in sets for name in SETS[s]]


def load_table() -> list[dict]:
    return json.loads(TABLE.read_text())["entries"]


def run_child(files, device: str, out: Path, timeout: float):
    """One pytest process over ``files``: its exit code and the plugin's
    record of it."""
    record = out / "child.json"
    record.unlink(missing_ok=True)
    env = dict(os.environ, BB25_SUITES_DEVICE=device,
               BB25_SUITES_OUT=str(record),
               PYTHONPATH=os.pathsep.join(
                   [str(SCRIPTS), str(ROOT),
                    *filter(None, [os.environ.get("PYTHONPATH")])]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "pytest", *files, "-p", "jax_suites_plugin",
           "--noconftest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
           "-p", "no:xdist", "--junitxml", str(out / "junit.xml")]
    try:
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        told = "".join(x.decode() if isinstance(x, bytes) else x
                       for x in (e.stdout or "", e.stderr or ""))
        (out / "pytest.log").write_text(told)
        raise SystemExit(f"run_jax_suites_torch: pytest ran past {timeout} "
                         f"s:\n{told[-3000:]}") from None
    (out / "pytest.log").write_text(run.stdout + run.stderr)
    if run.returncode not in (0, 1) or not record.exists():
        raise SystemExit(f"run_jax_suites_torch: pytest exited "
                         f"{run.returncode}:\n{run.stdout[-3000:]}"
                         f"{run.stderr[-3000:]}")
    return run.returncode, json.loads(record.read_text())


HOST_COPY = "T"    # the table's class of the tests that need the copy


def summarize(record: dict, files, device: str, table) -> dict:
    """Per-file counts and ids; the host copies that the table's ``T``
    entries for the device do not list (``unlisted``) or list but did
    not happen (``stale``); and the entries for these files that name no
    collected test (``uncollected``)."""
    per = {f: {"passed": 0, "failed": 0, "xfailed": 0, "skipped": 0,
               "seconds": 0.0, "failed_ids": [], "xfailed_ids": [],
               "host_copy_ids": []} for f in files}
    for nodeid, outcome in sorted(record["outcomes"].items()):
        f = per[nodeid.split("::")[0]]
        f[outcome] += 1
        if outcome in ("failed", "xfailed"):
            f[f"{outcome}_ids"].append(nodeid)
    for nodeid in record["converted"]:
        per[nodeid.split("::")[0]]["host_copy_ids"].append(nodeid)
    for nodeid, secs in record["seconds"].items():
        per[nodeid.split("::")[0]]["seconds"] += secs
    mine = [e for e in table if e["id"].split("::")[0] in per]
    copies = set(record["converted"])
    listed = {e["id"] for e in mine
              if device in e["devices"] and e["class"] == HOST_COPY}
    return {"device": device, "files": per,
            "unlisted": sorted(copies - listed),
            "stale": sorted(listed - copies),
            "uncollected": sorted({e["id"] for e in mine}
                                  - set(record["collected"])),
            "collected": record["collected"],
            "launches": record["launches"], "held": record["held"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--set", dest="sets", action="append",
                    choices=sorted(SETS),
                    help="library and/or scorer (default: both)")
    ap.add_argument("--out", default=str(ROOT / "build" / "jax_suites_torch"))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds the pytest child may take")
    args = ap.parse_args(argv)
    sets = args.sets or sorted(SETS)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    files = files_of(sets)
    t0 = time.perf_counter()
    rc, record = run_child(files, args.device, out, args.timeout)
    summary = summarize(record, files, args.device, load_table())
    summary["sets"] = sets
    summary["seconds"] = time.perf_counter() - t0
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    for name, f in summary["files"].items():
        print(f"{name}: {f['passed']} passed, {f['failed']} failed, "
              f"{f['xfailed']} listed failures, {f['skipped']} skipped, "
              f"{len(f['host_copy_ids'])} needed the host copy, "
              f"{f['seconds']:.2f} s", flush=True)
        for i in f["failed_ids"]:
            print(f"  failed (not in the table, or listed and passed): {i}",
                  flush=True)
    totals = Counter()
    for f in summary["files"].values():
        totals.update({k: f[k] for k in ("passed", "failed", "xfailed",
                                         "skipped")})
    print(f"{len(files)} files on {args.device}: {dict(totals)} in "
          f"{summary['seconds']:.1f} s; kernel launches "
          f"{json.dumps(summary['launches'])}", flush=True)
    for i in summary["unlisted"]:
        print(f"  needed the host copy, not in the table: {i}", flush=True)
    for i in summary["stale"]:
        print(f"  listed for the host copy, did not need it: {i}",
              flush=True)
    for i in summary["uncollected"]:
        print(f"  in the table, not collected: {i}", flush=True)
    held = summary["held"]
    if held["jax_package"] or held["jax"]:
        print(f"  the child held modules of JAX: {held}", flush=True)
    bad = (rc or summary["unlisted"] or summary["stale"]
           or summary["uncollected"] or any(held.values()))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
