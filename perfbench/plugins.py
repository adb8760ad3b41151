"""Files found by name: configurations, traffic mixes and limits
(JSON), distributions, loops and metric readers (Python). A new cell,
configuration, mix or metric is a new file, never an edit here."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    """``perfbench/<kind>/<name>.json``."""
    with open(base / kind / f"{_checked(name)}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots,
    so it is loaded from its path, not imported by name)."""
    path = base / kind / f"{_checked(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, spec: dict, base: Path = HERE) -> dict:
    """The workload entry, its configuration and traffic files, and the
    end-to-end and per-layer metric entries that it reports."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json("configs", w["config"], base)
    traffic = load_json("traffic", w["traffic"], base)

    def applies(metric, reported):
        if "workloads" in metric:
            return name in metric["workloads"]
        return reported is None or metric["moves"] in reported

    e2e = [m for m in spec["end_to_end"] if applies(m, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m, names)]
    return dict(workload=w, config_entry=conf_entry, config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)
