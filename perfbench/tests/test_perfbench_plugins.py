"""Configurations, mixes, limits and metrics are files found by name: a
new one is picked up with no edit to the harness."""

import json
import shutil
from pathlib import Path

import pytest

from perfbench import plugins, run
from tiny import tiny

HERE = Path(__file__).resolve().parents[1]


def test_a_new_config_runs_with_no_harness_edit(tmp_path):
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg, tr = tiny("fiqa.online")
    cfg["name"] = "newcorpus"
    cfg["corpus"]["length"] = {"dist": "fixed", "n": 25}
    (base / "configs" / "newcorpus.json").write_text(json.dumps(cfg))
    (base / "traffic" / "newmix.json").write_text(json.dumps(tr))
    (base / "limits" / "newcorpus.newmix.json").write_text(json.dumps(
        plugins.load_json("limits", "fiqa.online")))
    spec = plugins.benchmark()
    spec["configs"].append(dict(spec["configs"][0], name="newcorpus",
                                file="perfbench/configs/newcorpus.json"))
    spec["workloads"].append(dict(spec["workloads"][2],
                                  name="newcorpus.newmix",
                                  config="newcorpus", traffic="newmix"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "fiqa.online" in m.get("workloads", []):
            m["workloads"].append("newcorpus.newmix")
    cell = plugins.cell("newcorpus.newmix", spec, base)
    assert cell["config"]["corpus"]["length"]["n"] == 25
    res, _ = run.run_cell("newcorpus.newmix", 5, 0.5, False, device="cpu",
                          spec=spec, base=base)
    assert res["correct"], res
    assert {"latency_p95_ms", "setup_s"} <= set(res["metrics"])


def test_every_named_file_exists_and_agrees():
    spec = plugins.benchmark()
    for c in spec["configs"]:
        assert (HERE.parent / c["file"]).is_file()
        cfg = plugins.load_json("configs", c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert "control" in cfg
    for w in spec["workloads"]:
        plugins.load_json("traffic", w["traffic"])
        limits = plugins.load_json("limits", w["name"])
        assert {"score_gap", "bad_ids", "rows_missing"} <= set(limits)
        cell = plugins.cell(w["name"], spec)
        assert cell["per_layer"], w["name"]
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(plugins.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("bad", ["../configs/fiqa", "a b", "", "x/y"])
def test_names_outside_the_rules_are_refused(bad):
    with pytest.raises(ValueError):
        plugins.load_json("configs", bad)
