"""PyTorch port: the JAX package's examples, unchanged, on the port.

One subprocess runs ``scripts/run_examples_torch.py`` over the 18
``examples/*.py`` and the port's counterpart of
``examples/sharded_retrieval.py`` (which imports jax itself), and holds
each output to the JAX package's recorded one
(``tests/data/examples_jax/``, JAX on the CPU in float64;
``scripts/record_jax_examples.py``) under the runner's rule: volatile
fields masked, integers equal, other numbers within one unit of their
last printed digit. The runner runs the examples on the card, as the
port's entry points do by default; here a shim that this test puts in
that subprocess only rebinds the port's ``resolve_device`` so the card
means the CPU. Nothing in the package or the runner changes for it, and
this process never maps ``bayesian_bm25_tpu`` to the port.

Also: the comparison rule on made-up lines, and the one printed
difference that is deliberate: the port's library computes in float64
(clamp 1e-10) where JAX with x64 off computes in float32 (clamp 1e-6).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import bayesian_bm25_tpu
from bayesian_bm25_tpu import VectorProbabilityTransform as JaxVPT
from bayesian_bm25_tpu_torch.models.vector_probability import (
    VectorProbabilityTransform as TorchVPT)

from torch_helpers import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RUNNER = ROOT / "scripts" / "run_examples_torch.py"
NAMES = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))

# Run in the examples' process before the runner: every port module that
# bound resolve_device by name gets the CPU-for-the-card version.
SHIM = """
import importlib, pkgutil, runpy, sys
import torch
sys.path.insert(0, {root!r})
import bayesian_bm25_tpu_torch as pkg
from bayesian_bm25_tpu_torch.ops import mathx
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
card = mathx.resolve_device

def on_cpu(device=None):
    dev = torch.device("cuda" if device is None else device)
    return card("cpu" if dev.type == "cuda" else dev)

for mod in list(sys.modules.values()):
    if (getattr(mod, "__name__", "").startswith(pkg.__name__)
            and getattr(mod, "resolve_device", None) is card):
        mod.resolve_device = on_cpu
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _runner():
    spec = importlib.util.spec_from_file_location("run_examples_torch",
                                                  RUNNER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("examples_torch")
    proc = subprocess.run(
        [sys.executable, "-c", SHIM.format(root=str(ROOT)), str(RUNNER),
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    summary = json.loads((out / "summary.json").read_text())
    return proc, summary


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_jax_printed(run, name):
    _, summary = run
    ex = summary["examples"][name]
    assert ex["error"] is None, ex["error"]
    assert ex["differ"] == [], ex["differ"]
    assert ex["ok"]


def test_runner_ran_every_example_once(run):
    proc, summary = run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(summary["examples"]) == NAMES and len(NAMES) == 19
    assert summary["examples"]["sharded_retrieval"]["source"] == (
        "scripts/torch_examples/sharded_retrieval.py")
    assert summary["examples"]["basic_probability"]["source"] == (
        "examples/basic_probability.py")
    # On the CPU the wrappers run their plain versions: nothing launched.
    assert set(summary["launches"].values()) == {0}
    # The alias lived in the runner's process only.
    assert bayesian_bm25_tpu.__name__ == "bayesian_bm25_tpu"
    assert "torch" not in bayesian_bm25_tpu.__file__.split("/")[-2]


def test_runner_refuses_a_process_holding_the_jax_package():
    with pytest.raises(RuntimeError, match="already imported"):
        _runner().install_alias()


@pytest.mark.parametrize("want, got, differ, last", [
    # wall times, q/s, temporary paths, the mesh repr, the platform
    ("indexed 5000 docs in 1.4s (split index: on)",
     "indexed 5000 docs in 12.0s (split index: on)", 0, 0),
    ("batch   1:   154.2 ms (       6 queries/sec)",
     "batch   1:    19.7 ms (      51 queries/sec)", 0, 0),
    ("indexed 5 documents from /tmp/tmp5680hyt7/corpus.jsonl",
     "indexed 5 documents from /scratch/x/tmpab_c/corpus.jsonl", 0, 0),
    ("term table (64, 40) sharded over mesh OrderedDict({'d': 8})",
     "term table (64, 40) sharded over mesh {'d': 8}", 0, 0),
    ("devices: 8 x cpu", "devices: 8 x cuda", 0, 0),
    # ids and counts exact; a last printed digit may move, reported
    ("  q0: docs [10, 44, 30]", "  q0: docs [10, 30, 44]", 1, 0),
    ("N=64 avgdl=40.00", "N=65 avgdl=40.00", 1, 0),
    ("doc 0 (P=0.4431)", "doc 0 (P=0.4432)", 0, 1),
    ("doc 0 (P=0.4431)", "doc 0 (P=0.4433)", 1, 0),
    ("probs [0.29600000381469727, 0.2]", "probs [0.296, 0.2]", 0, 1),
    ("base_rate=2.53e-02", "base_rate=2.54e-02", 0, 1),
    ("base_rate=2.53e-02", "base_rate=2.53e-03", 1, 0),
    ("query: python", "query: pasta", 1, 0),
])
def test_comparison_rule(want, got, differ, last):
    d, ld = _runner().compare(got + "\n", want + "\n")
    assert (len(d), len(ld)) == (differ, last)


def test_a_missing_line_differs():
    d, _ = _runner().compare("a\n", "a\nb\n")
    assert d == [[2, "b", None]]


def test_vector_calibration_clamp_differs_on_purpose():
    # examples/vector_calibration.py's background shell: JAX with x64 off
    # clamps at float32's 1e-6, the port at float64's 1e-10 (the JAX
    # package with x64 on, as recorded, agrees with the port).
    rng = np.random.default_rng(0)
    background = rng.normal(0.62, 0.1, 5000)
    near = np.concatenate([rng.normal(0.18, 0.02, 12),
                           rng.normal(0.60, 0.08, 88)])
    with jax.enable_x64(False):
        jp = np.asarray(JaxVPT.fit_background(
            background, base_rate=0.05).calibrate(near))
    tp = TorchVPT.fit_background(background, base_rate=0.05,
                                 device="cpu").calibrate(near)
    shell = np.argsort(near)[-3:]
    assert jp.dtype == np.float32 and tp.dtype == np.float64
    np.testing.assert_array_equal(jp[shell], np.float32(1e-6))
    np.testing.assert_array_equal(tp[shell], 1e-10)
    close = np.argsort(near)[:5]
    np.testing.assert_allclose(tp[close], jp[close], rtol=1e-6)
