"""The JAX package's scorer test files, unchanged, against the port on
the CPU (``scripts/run_jax_suites_torch.py --device cpu --set scorer``,
one subprocess): each file's failures are the entries of
``tests/data/jax_suites_torch/differences.json`` for the CPU (strict
xfail) and nothing else fails, every entry names a collected test, and
the subprocess held no module of JAX.
"""

import pytest

from torch_helpers import (check_file, check_table_ids, run_jax_suites,
                           suite_files)

SET = "scorer"
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
