"""On the card: one short run of each cell from the command line, which
must print a correct last line. ``python -m pytest perfbench/tests -m
cuda``; skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import plugins

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in plugins.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell,
         "--seed", "4102030405", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
