"""Nothing the benchmark runs may load JAX or the JAX package, compared
by whole top-level names; the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax", "bayesian_bm25_tpu",
                                  "bayesian_bm25_tpu.engine.index"])
def test_forbidden_names_are_refused(name):
    assert run.forbidden_modules(["numpy", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", ["bayesian_bm25_tpu_torch",
                                  "bayesian_bm25_tpu_torch.engine",
                                  "jaxtyping", "flaxen", "torch"])
def test_other_names_pass(name):
    assert run.forbidden_modules([name]) == []


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "check.py"):
        assert _imports(HERE / f) <= {"__future__", "numpy", "torch",
                                      "perfbench"}, f


def test_no_harness_file_imports_jax():
    for f in HERE.rglob("*.py"):
        assert not (_imports(f) & set(run.FORBIDDEN)), f


def test_a_run_on_the_cpu_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from tiny import tiny\n"
        "from perfbench import run\n"
        "cfg, tr = tiny('fiqa.online')\n"
        "res, _ = run.run_cell('fiqa.online', 3, 0.5, True, device='cpu',"
        " config=cfg, traffic=tr)\n"
        "assert res['correct'], res\n"
        "print(run.forbidden_modules())\n"
    ) % (str(HERE.parent), str(HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "fiqa.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=HERE.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == run.EXIT_NO_CARD
    assert out.stdout == ""
