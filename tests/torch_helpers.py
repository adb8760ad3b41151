"""Helpers that the port's test files share.

``one_thread``: imported into a test module, this autouse fixture runs
the module's tests with one torch intra-op thread. The port's tests run
many small ops, several worker processes at once: with torch's default
of one thread a core in each worker, the workers' threads contend. Six
workers on an 8-core CPU ran the port's test files in 362 s with the
default and in 84 s with one thread.

``run_jax_suites``: ``scripts/run_jax_suites_torch.py`` on the CPU over
one set of the JAX package's test files, in a subprocess.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SUITES_RUNNER = ROOT / "scripts" / "run_jax_suites_torch.py"
SUITES_TABLE = ROOT / "tests" / "data" / "jax_suites_torch" / "differences.json"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def suites_runner():
    """``scripts/run_jax_suites_torch.py`` as a module."""
    spec = importlib.util.spec_from_file_location("run_jax_suites_torch",
                                                  SUITES_RUNNER)
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    return runner


def suite_files(set_name: str) -> list[str]:
    """The set's test files, as the runner names them."""
    return suites_runner().files_of([set_name])


def run_jax_suites(set_name: str, out: Path):
    """(exit code, standard output, summary) of the runner on the CPU."""
    run = subprocess.run(
        [sys.executable, str(SUITES_RUNNER), "--device", "cpu", "--set",
         set_name, "--out", str(out), "--timeout", "600"],
        cwd=ROOT, capture_output=True, text=True, timeout=660)
    summary = out / "summary.json"
    return (run.returncode, run.stdout + run.stderr,
            json.loads(summary.read_text()) if summary.exists() else None)


def table_entries(files) -> list[dict]:
    """The table's entries for the tests in ``files``."""
    entries = json.loads(SUITES_TABLE.read_text())["entries"]
    return [e for e in entries if e["id"].split("::")[0] in files]


def check_file(summary, name: str) -> None:
    """The file ran, nothing in it failed unlisted, and the tests that
    failed as listed (strict xfail) are the table's entries for the
    CPU."""
    f = summary["files"][name]
    assert f["passed"] + f["xfailed"] + f["skipped"] > 0, name
    assert f["failed_ids"] == []
    want = sorted(e["id"] for e in table_entries([name])
                  if "cpu" in e["devices"])
    assert f["xfailed_ids"] == want


def check_table_ids(summary, files) -> None:
    """Every entry of the table for ``files``, on any device, names a
    test that the run collected."""
    collected = set(summary["collected"])
    assert [e["id"] for e in table_entries(files)
            if e["id"] not in collected] == []
