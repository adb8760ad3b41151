"""The JAX package's library test files, unchanged, against the port on
the CPU (``scripts/run_jax_suites_torch.py --device cpu --set library``,
one subprocess): each file's failures are the entries of
``tests/data/jax_suites_torch/differences.json`` for the CPU (strict
xfail) and nothing else fails, every entry names a collected test, and
the subprocess held no module of JAX.
"""

import pytest

from torch_helpers import (check_file, check_table_ids, run_jax_suites,
                           suite_files, suites_runner)

SET = "library"
FILES = suite_files(SET)


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    return run_jax_suites(SET, tmp_path_factory.mktemp("jax_suites"))


def test_runner_exits_0(suites):
    rc, out, summary = suites
    assert rc == 0, out[-4000:]
    assert summary["held"] == {"jax_package": [], "jax": []}


@pytest.mark.parametrize("name", FILES)
def test_file_fails_as_the_table_says(suites, name):
    check_file(suites[2], name)


def test_table_names_collected_tests(suites):
    check_table_ids(suites[2], FILES)


def test_summary_holds_host_copies_to_the_table():
    """The runner's bookkeeping on a made-up run: counts and ids by
    file; a host copy that the table's ``T`` entries do not list for the
    device, a listed one that did not happen, and an entry that names no
    collected test are reported; entries for another device, and the
    failing classes (which the plugin marks strict xfail), are not."""
    files = ["tests/test_a.py", "tests/test_b.py"]
    record = {"outcomes": {"tests/test_a.py::t1": "xfailed",
                           "tests/test_a.py::t2": "failed",
                           "tests/test_a.py::t3": "passed",
                           "tests/test_b.py::t4": "passed",
                           "tests/test_b.py::t5": "skipped"},
              "seconds": {"tests/test_a.py::t1": 0.5},
              "converted": ["tests/test_b.py::t4", "tests/test_b.py::t5"],
              "collected": ["tests/test_a.py::t1", "tests/test_a.py::t2",
                            "tests/test_a.py::t3", "tests/test_b.py::t4",
                            "tests/test_b.py::t5"],
              "launches": {}, "held": {}}
    table = [
        {"id": "tests/test_a.py::t1", "devices": ["cuda"], "class": "D"},
        {"id": "tests/test_b.py::t4", "devices": ["cuda"], "class": "T"},
        {"id": "tests/test_a.py::t3", "devices": ["cuda"], "class": "T"},
        {"id": "tests/test_b.py::t5", "devices": ["cpu"], "class": "T"},
        {"id": "tests/test_b.py::t9", "devices": ["cuda"], "class": "A2"},
        {"id": "tests/test_c.py::t6", "devices": ["cuda"], "class": "D"},
    ]
    s = suites_runner().summarize(record, files, "cuda", table)
    assert s["unlisted"] == ["tests/test_b.py::t5"]
    assert s["stale"] == ["tests/test_a.py::t3"]
    assert s["uncollected"] == ["tests/test_b.py::t9"]
    assert s["files"]["tests/test_a.py"] == {
        "passed": 1, "failed": 1, "xfailed": 1, "skipped": 0,
        "seconds": 0.5, "failed_ids": ["tests/test_a.py::t2"],
        "xfailed_ids": ["tests/test_a.py::t1"], "host_copy_ids": []}
    assert s["files"]["tests/test_b.py"]["host_copy_ids"] == [
        "tests/test_b.py::t4", "tests/test_b.py::t5"]
