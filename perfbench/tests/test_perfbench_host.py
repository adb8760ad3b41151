"""What a run logs of its host and its window on standard error: the
CPUs and threads it runs on, in every cell and without changing them,
and the queries completed in each slot of the window."""

import json
import re

import pytest
import torch

from perfbench import plugins, run
from tiny import tiny


@pytest.mark.parametrize(
    "cell", [w["name"] for w in plugins.benchmark()["workloads"]])
def test_every_cell_logs_its_host_and_leaves_it(cell, monkeypatch, capsys):
    torch.set_num_threads(3)
    seen = {}

    def fake_run_cell(name, seed, seconds, trace, started=None):
        seen["threads"] = torch.get_num_threads()
        return dict(correct=True, attempted=1, failed=0, metrics={},
                    device=dict(kind="stand-in")), []

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_cell", fake_run_cell)
    monkeypatch.setattr(run, "pin_caches", lambda: None)
    assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1"]) == 0
    out = capsys.readouterr()
    assert seen["threads"] == 3
    assert re.search(r"^host: \d+ CPUs allowed; torch intra-op threads 3$",
                     out.err, re.M)
    assert json.loads(out.out.splitlines()[-1])["correct"] is True


def test_the_window_log_counts_every_completed_query(capsys):
    cfg, tr = tiny("fiqa.bulk")
    res, _ = run.run_cell("fiqa.bulk", 2200000101, 1.0, False,
                          device="cpu", config=cfg, traffic=tr)
    err = capsys.readouterr().err
    slots = re.search(r"queries completed in each 5 s: (.*)", err).group(1)
    done = [int(n) for n in slots.split()]
    assert len(done) == 1
    assert sum(done) == res["metrics"]["qps"]["value"] * 1.0
