"""PyTorch port: the benchmark harness of ``benchmarks/`` on the port.

- ``benchmarks_torch/hybrid_beir.py``, the port's copy of the JAX
  package's harness, on the port's CPU device reproduces the JAX
  package's frozen per-method NDCG@5 on the checked-in mini BEIR
  (``tests/data/mini_beir_frozen.json``, JAX on the CPU in float64)
  within the JAX test's 1e-6, for all 35 methods;
- the copy differs from ``benchmarks/hybrid_beir.py`` only in the listed
  hunks (imports, ``device``, the dense product, the encoder, ``main``'s
  ``--device``), and ``benchmarks_torch/scalability.py`` from its
  original in one line;
- ``scripts/run_benchmarks_torch.py --device cpu`` in a subprocess runs
  two recorded scripts unchanged and matches the JAX package's recorded
  output (``tests/data/benchmarks_jax/``), and its process, having
  imported everything of ``benchmarks_torch/`` and ``chip_smoke.py``,
  holds neither ``jax`` nor the JAX package;
- the gate studies' own logic (``benchmarks/ordering_study.py``,
  ``vpt_ordering_study.py``, unchanged) reproduces each JAX artifact's
  statistics and decisions from the artifact's per-seed NDCGs;
- the runner's timing masks and ``benchmarks_torch/sharded_scaling.py``
  at a small size.
"""

import difflib
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from torch_helpers import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RUNNER = ROOT / "scripts" / "run_benchmarks_torch.py"
FROZEN = json.loads((ROOT / "tests" / "data" /
                     "mini_beir_frozen.json").read_text())
ARTIFACTS = ROOT / "benchmarks" / "results"


def _runner():
    spec = importlib.util.spec_from_file_location("run_benchmarks_torch",
                                                  RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mini_beir():
    from benchmarks.utils import load_beir_dataset
    from benchmarks_torch.hybrid_beir import run_dataset

    ds = load_beir_dataset(str(ROOT / "benchmarks" / "data" / "mini_beir"))
    return run_dataset(ds, k=5, R=50, verbose=False, device="cpu")


@pytest.mark.parametrize("method", sorted(FROZEN))
def test_copy_reproduces_the_frozen_mini_beir_ndcg(mini_beir, method):
    assert len(FROZEN) == 35
    assert mini_beir[method]["ndcg@5"] == pytest.approx(FROZEN[method],
                                                        abs=1e-6)


def test_mini_beir_runs_every_method_and_no_other(mini_beir):
    assert sorted(mini_beir) == sorted(FROZEN)


# --- the copy differs from the JAX harness only where listed ---------------

# Hunks whose added text is fixed, each present once.
EXACT = {
    "signature": ["    device=None,"],
    "encoder": [
        '        # Neither machine has sentence-transformers weights: "auto" is',
        "        # the hashing encoder, and any other backend fails.",
        '        if dense_backend not in ("auto", "hash"):',
        '            raise ValueError(f"dense_backend {dense_backend!r} is not "',
        '                             "available; use \'hash\'")',
        '        corpus_emb = encode_dense(doc_texts, backend="hash")'],
    "encoder queries": ['                                 backend="hash")'],
    "dense import": ["    import torch"],
    "dense product": [
        "    from bayesian_bm25_tpu_torch.ops.mathx import resolve_device",
        "",
        "    # One full product in the inputs' dtype (float32), as JAX "
        "computes it.",
        "    dev = resolve_device(device)",
        '    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:',
        '        raise RuntimeError("TF32 is on: the dense product must be '
        'float32")',
        "    dense_all = torch.matmul(torch.from_numpy(query_emb).to(dev),",
        "                             torch.from_numpy(corpus_emb).to(dev).T",
        "                             ).cpu().numpy()"],
    "main device": [
        "    # The port's CPU device where asked for, else the card.",
        '    device = "cpu" if args.device == "cpu" else None'],
    "main call": ["            device=device,"],
}
DEVICE_ARG = re.compile(
    r",\s*device=device\b|\bdevice=device,\s*|(?<=\()device=device(?=\))")


def _hunks(original: str, copy: str):
    a, b = (ROOT / original).read_text().splitlines(), \
        (ROOT / copy).read_text().splitlines()
    ops = difflib.SequenceMatcher(a=a, b=b, autojunk=False).get_opcodes()
    return [(a[i1:i2], b[j1:j2]) for tag, i1, i2, j1, j2 in ops
            if tag != "equal"]


def _kind(old, new) -> str | None:
    for name, text in EXACT.items():
        if new == text:
            return name
    if old and new == [line.replace("bayesian_bm25_tpu",
                                    "bayesian_bm25_tpu_torch")
                       for line in old]:
        return "import"
    squash = "".join(DEVICE_ARG.sub("", "".join(new)).split())
    if old and "device=device" in "".join(new) and squash == "".join(
            "".join(old).split()):
        return "device"
    return None


def test_the_copy_differs_from_the_harness_only_where_listed():
    kinds = [_kind(old, new) for old, new in
             _hunks("benchmarks/hybrid_beir.py",
                    "benchmarks_torch/hybrid_beir.py")]
    assert None not in kinds, [h for h, k in zip(
        _hunks("benchmarks/hybrid_beir.py",
               "benchmarks_torch/hybrid_beir.py"), kinds) if k is None]
    assert sorted(k for k in kinds if k in EXACT) == sorted(EXACT)
    # Five import lines at the top (three hunks) and calibration_report's
    # in run_dataset; every constructor and function of the port that
    # run_dataset calls takes its device (30 hunks).
    assert kinds.count("import") == 4 and kinds.count("device") == 30


def test_the_scalability_copy_differs_in_one_line_and_its_docstring():
    (doc, line) = _hunks("benchmarks/scalability.py",
                         "benchmarks_torch/scalability.py")
    assert doc[0] == ["Usage: python benchmarks/scalability.py [--large]"]
    assert doc[1][-1] == ("Usage: python benchmarks_torch/scalability.py "
                          "[--large]")
    assert line == (
        ["    index_mb = (idx.term_ids.size * 4 + idx.weights.size * 4) "
         "/ 1e6"],
        ["    index_mb = (idx.term_ids.numel() * 4 + idx.weights.numel() "
         "* 4) / 1e6"])


def test_the_wand_copy_differs_in_two_lines_and_its_docstring():
    (doc, lines) = _hunks("benchmarks/wand_upper_bound.py",
                          "benchmarks_torch/wand_upper_bound.py")
    assert doc[0] == ["Usage: python benchmarks/wand_upper_bound.py"]
    assert doc[1][-1] == "Usage: python benchmarks_torch/wand_upper_bound.py"
    assert lines == (["            w = np.asarray(idx.weights)",
                      "            tid = np.asarray(idx.term_ids)"],
                     ["            w = np.asarray(idx.weights.cpu())",
                      "            tid = np.asarray(idx.term_ids.cpu())"])


@pytest.mark.parametrize("backend", ["st", "tfidf"])
def test_the_copy_refuses_an_encoder_it_does_not_have(backend):
    from benchmarks.utils import load_beir_dataset
    from benchmarks_torch.hybrid_beir import run_dataset

    ds = load_beir_dataset(str(ROOT / "benchmarks" / "data" / "mini_beir"))
    with pytest.raises(ValueError, match="not available"):
        run_dataset(ds, dense_backend=backend, verbose=False, device="cpu")


# --- the runner in its own process -----------------------------------------

# Runs the runner, then imports what chip_smoke.py and benchmarks_torch/
# hold, and reports what the process holds.
PROBE = """
import importlib, json, runpy, sys
sys.path.insert(0, {root!r})
sys.argv = [{runner!r}, *sys.argv[1:]]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
    code = 0
except SystemExit as exc:
    code = exc.code
for name in ("benchmarks_torch.hybrid_beir", "benchmarks_torch.sharded_scaling",
             "benchmarks_torch.scalability", "chip_smoke"):
    importlib.import_module(name)
src = "bayesian_bm25_tpu"
print(json.dumps({{"code": code, "jax": sorted(
    m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "held": {{m: sys.modules[m].__name__ for m in sys.modules
             if m == src or m.startswith(src + ".")}}}}))
"""


@pytest.fixture(scope="module")
def runner_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("benchmarks_torch")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            runner=str(RUNNER)),
         "--device", "cpu", "--only", "benchmark", "weighted_fusion",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return (json.loads(proc.stdout.splitlines()[-1]),
            json.loads((out / "summary.json").read_text()))


@pytest.mark.parametrize("name", ["benchmark", "weighted_fusion"])
def test_runner_output_matches_the_jax_recording(runner_run, name):
    _, summary = runner_run
    part = summary["parts"][name]
    assert part["error"] is None, part["error"]
    assert part["recorded"] and part["differ"] == [] and part["ok"]


def test_runner_on_the_cpu_exits_0_and_launches_nothing(runner_run):
    probe, summary = runner_run
    assert probe["code"] == 0
    assert summary["device"] == "cpu" and summary["card"] == "cpu"
    assert sorted(summary["parts"]) == ["benchmark", "weighted_fusion"]
    # On the CPU the wrappers run their plain versions.
    assert set(summary["launches"].values()) == {0}


def test_runner_process_holds_neither_jax_nor_the_jax_package(runner_run):
    probe, _ = runner_run
    assert probe["jax"] == []
    assert probe["held"] and all(
        v.startswith("bayesian_bm25_tpu_torch") for v in
        probe["held"].values()), probe["held"]


def test_runner_refuses_a_process_holding_the_jax_package():
    import bayesian_bm25_tpu  # noqa: F401

    with pytest.raises(RuntimeError, match="already imported"):
        _runner().install_alias()


def test_runner_refuses_an_unknown_part():
    with pytest.raises(SystemExit, match="no part"):
        _runner().main(["--only", "nope", "--device", "cpu"])


# --- the gate studies' logic on the JAX artifacts' per-seed NDCGs ----------

STUDIES = {
    "ordering_gate": ("benchmarks/ordering_study.py", [], 1.0),
    "attn_gate": ("benchmarks/ordering_study.py", ["--regimes"], 1.0),
    # vpt_ordering_study.py prints and stores NDCG x 100.
    "vpt_gate": ("benchmarks/vpt_ordering_study.py", ["--device", "auto"],
                 100.0),
}


def _run_study(monkeypatch, tmp_path, name, per_seed):
    """Run a study unchanged with run_dataset answering each seed from
    ``per_seed`` ({method: [NDCG per seed]}). Returns (exit code, its
    JSON)."""
    script, flags, _ = STUDIES[name]
    seeds = [7, 8, 9]
    fake = types.ModuleType("benchmarks.hybrid_beir")

    def run_dataset(ds, **kw):
        i = seeds.index(ds)
        return {m: {"ndcg@10": v[i]} for m, v in per_seed.items()}

    fake.run_dataset = run_dataset
    import benchmarks.utils as bu

    monkeypatch.setitem(sys.modules, "benchmarks.hybrid_beir", fake)
    for gen in ("synthetic_dataset_hard", "synthetic_dataset_vpt"):
        monkeypatch.setattr(bu, gen, lambda seed, **kw: seed)
    out = tmp_path / f"{name}.json"
    monkeypatch.setattr(sys, "argv", [script, *flags, "--seeds", "7", "8",
                                      "9", "-o", str(out)])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(str(ROOT / script), run_name="__main__")
    return exc.value.code, json.loads(out.read_text())


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_logic_reproduces_the_artifact(monkeypatch, tmp_path, name,
                                             capsys):
    art = json.loads((ARTIFACTS / f"{name}.json").read_text())
    scale = STUDIES[name][2]
    per_seed = {m: [v / scale for v in s["per_seed"]]
                for m, s in art["stats"].items()}
    code, got = _run_study(monkeypatch, tmp_path, name, per_seed)
    assert code == 0 and got["ok"] and art["ok"]
    for m, s in art["stats"].items():
        assert got["stats"][m]["mean"] == pytest.approx(s["mean"], rel=1e-12)
        assert got["stats"][m]["se"] == pytest.approx(s["se"], rel=1e-9)
    assert [g["pair"] for g in got["gates"]] == [g["pair"]
                                                 for g in art["gates"]]
    for g, a in zip(got["gates"], art["gates"]):
        assert g["ok"] == a["ok"]
        assert g["margin"] == pytest.approx(a["margin"], rel=1e-9)


def test_study_fails_a_gate_whose_intervals_overlap(monkeypatch, tmp_path,
                                                    capsys):
    art = json.loads((ARTIFACTS / "ordering_gate.json").read_text())
    per_seed = {m: list(s["per_seed"]) for m, s in art["stats"].items()}
    # Convex moves to within Balanced's seed noise.
    per_seed["Convex"] = [v - 0.002 for v in per_seed["Bayesian-Balanced"]]
    code, got = _run_study(monkeypatch, tmp_path, "ordering_gate", per_seed)
    assert code == 1 and not got["ok"]
    assert [g["ok"] for g in got["gates"]] == [False, True, True, True]
    assert "[FAIL] Bayesian-Balanced > Convex" in capsys.readouterr().out


# --- the runner's masks and sharded_scaling --------------------------------

@pytest.mark.parametrize("want, got, differ", [
    # a "Timing" table's decimals and spacing
    ("=== Timing ===\n  gate      ms    \n  none      0.7400\n",
     "=== Timing ===\n  gate      ms     \n  none      12.1800\n", 0),
    ("=== Timing ===\n  signals  fit ms  forward ms\n  2        7.7000  0.25\n",
     "=== Timing ===\n  signals  fit ms  forward ms\n  3        62.6000 0.22\n",
     1),
    # other tables stay compared
    ("=== Fusion MSE ===\n  2        0.0210\n",
     "=== Fusion MSE ===\n  2        0.0310\n", 1),
    ("=== Timing ===\n  a  0.1\n\n=== Quality ===\n  b  0.5000\n",
     "=== Timing ===\n  a  0.9\n\n=== Quality ===\n  b  0.5100\n", 1),
    # a speedup ratio of two times
    ("single pass 14.2 ms vs double pass 16.1 ms  (1.13x)",
     "single pass 5.0 ms vs double pass 9.0 ms  (1.77x)", 0),
])
def test_timing_masks(want, got, differ):
    runner = _runner()
    d, _ = runner.examples.compare(runner.mask_timings(got),
                                   runner.mask_timings(want))
    assert len(d) == differ


def test_sharded_scaling_on_shards_of_one_device(monkeypatch, tmp_path,
                                                 capsys):
    out = tmp_path / "rows.json"
    monkeypatch.setattr(sys, "argv", [
        "sharded_scaling.py", "--docs", "3000", "--queries", "64",
        "--device", "cpu", "-o", str(out)])
    runpy.run_path(str(ROOT / "benchmarks_torch" / "sharded_scaling.py"),
                   run_name="__main__")
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith("all shards share one device (cpu); "
                            "split merge: yes")
    rows = json.loads(out.read_text())
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert [r["merge_B_per_query"] for r in rows] == [0, 320, 640, 1280]
    # Each shard holds its part of the doc axis, no more than the whole.
    mb = np.array([r["shard_MB"] for r in rows])
    assert np.all(np.diff(mb) < 0) and np.all(mb * [1, 2, 4, 8] >= mb[0])


# --- the benchmarks' data drawn as numpy 2.0 draws it ----------------------

@pytest.mark.parametrize("seed, a, want, after", [
    # numpy 2.0.2's Generator.zipf; the next double shows where the
    # stream stands.
    (7, 1.3, [145, 1, 203, 3, 2, 10, 2, 23, 1, 27, 9, 1, 50, 4, 367, 1, 4,
              1, 3, 283, 376119, 22, 43, 6], 0.40249829810398163),
    (3, 2.5, [1, 2, 1, 1, 2, 1, 1, 1], 0.6962159966701554),
])
def test_pinned_zipf_draws_numpy_2_0s_values(seed, a, want, after):
    from benchmarks_torch import data

    rng = data.default_rng(seed)
    assert rng.zipf(a, len(want)).tolist() == want
    assert rng.random() == after
    rng = data.default_rng(seed)
    assert [rng.zipf(a) for _ in range(3)] == want[:3]


def test_pinned_zipf_keeps_every_other_draw_numpys():
    from benchmarks_torch import data

    mine, ref = data.default_rng(11), np.random.default_rng(11)
    for draw in (lambda r: r.normal(0, 1, 64), lambda r: r.integers(0, 9, 64),
                 lambda r: r.choice(100, 20, replace=False),
                 lambda r: r.permutation(50), lambda r: r.uniform(size=8)):
        np.testing.assert_array_equal(draw(mine), draw(ref))


def test_pin_zipf_rebinds_only_the_module_given(monkeypatch):
    import benchmarks.utils as bu
    from benchmarks_torch import data

    monkeypatch.setattr(bu, "np", bu.np)
    data.pin_zipf(bu)
    assert isinstance(bu.np.random.default_rng(0), data.Numpy20Generator)
    assert bu.np.linalg is np.linalg and bu.np.float32 is np.float32
    assert not isinstance(np.random.default_rng(0), data.Numpy20Generator)
    ds = bu.synthetic_dataset(n_docs=60, n_queries=4, seed=5)
    assert len(ds.corpus) == 60 and len(ds.queries) == 4


@pytest.mark.parametrize("port, jax, want", [
    ({"q0": ["a", "b"], "q1": ["c", "d", "e"]},
     {"q0": ["a", "b"], "q1": ["c", "e", "d"]}, ("q1", 1, ["d", "e"],
                                                 ["e", "d"])),
    ({"q0": ["a", "b"]}, {"q0": ["a", "b"]}, None),
    ({"q0": ["a"]}, {}, ("q0", 0, ["a"], [])),
])
def test_first_ranking_difference(port, jax, want):
    spec = importlib.util.spec_from_file_location(
        "compare_gate_rankings", ROOT / "scripts" / "compare_gate_rankings.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.first_difference(port, jax) == want
