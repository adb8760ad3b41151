"""The contract's shape of BENCHMARK.json and of the last line."""

import json
import re

import pytest

from perfbench import check, plugins, run
from tiny import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    spec = plugins.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    seen = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(trace):
    cfg, tr = tiny("fiqa.bulk")
    res, lines = run.run_cell("fiqa.bulk", 2**31 + 99, 1.0, trace,
                              device="cpu", config=cfg, traffic=tr)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    json.dumps(res)
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    limits = plugins.load_json("limits", "fiqa.bulk")
    assert list(res["checks"]) == check.compared(limits)
    for n, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    assert len(lines) == len(res["checks"])
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "launch_ms.bulk" in res["metrics"]
    else:
        assert {"qps", "peak_mem_gib", "setup_s"} >= set(
            res["metrics"]) >= {"qps", "setup_s"}
