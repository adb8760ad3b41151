"""The pytest plugin of ``scripts/run_jax_suites_torch.py``: the JAX
package's test files, unchanged, against the PyTorch port in this
process.

At configure it installs the import alias (``bayesian_bm25_tpu`` and
its modules resolve to ``bayesian_bm25_tpu_torch``'s,
``benchmarks_torch/_alias.py``) and, when ``BB25_SUITES_DEVICE`` is
``cpu``, makes the card mean the CPU (``card_means_cpu``) with one
torch thread. On the card, ``np.asarray`` of a CUDA tensor called from
a test (not from the port) copies it to the host, as JAX's device
arrays convert, and the test is recorded as one that needed the copy.

At collection it marks each test that
``tests/data/jax_suites_torch/differences.json`` lists as failing on the
device (every class but ``T``) ``xfail(strict=True)``: a failure that
the table does not list fails the session, and so does a listed test
that passes (XPASS(strict), a stale entry). It records every test's
outcome and duration; at the end of the session it writes them, the
collected ids, the tests that needed the host copy, the port's kernel
launches over the session and the modules of the real JAX package and
of ``jax`` that the process holds to the JSON file ``BB25_SUITES_OUT``.
The session fails if it holds either.
"""

from __future__ import annotations

import json
import os
import sys
import types
from collections import defaultdict
from pathlib import Path

SCRIPTS = Path(__file__).resolve().parent
ROOT = SCRIPTS.parent
for p in (str(ROOT), str(SCRIPTS)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402

from benchmarks_torch._alias import DST, SRC, install_alias  # noqa: E402
from run_jax_suites_torch import HOST_COPY, load_table  # noqa: E402

_outcomes: dict[str, str] = {}
_seconds: dict[str, float] = defaultdict(float)
_collected: list[str] = []
_converted: set[str] = set()
_running: list[str] = [""]    # the id of the test that is running


def pytest_configure(config):
    # Two suites import helpers as ``tests.<module>``. The repo's tests/
    # has no __init__.py, so a ``tests`` package installed elsewhere on
    # the path would win over it: bind the name to the directory.
    tests = types.ModuleType("tests")
    tests.__path__ = [str(ROOT / "tests")]
    sys.modules["tests"] = tests
    install_alias()
    if os.environ.get("BB25_SUITES_DEVICE") == "cpu":
        import torch

        from benchmarks_torch._alias import card_means_cpu

        card_means_cpu()
        torch.set_num_threads(1)
    else:
        _host_copy_from_tests()


def _caller_file() -> str:
    """The file of the code that asked numpy for an array, past numpy's
    own Python frames."""
    import numpy

    frame = sys._getframe(2)
    while frame.f_code.co_filename.startswith(os.path.dirname(numpy.__file__)):
        frame = frame.f_back
    return frame.f_code.co_filename


def _host_copy_from_tests():
    import torch

    to_numpy = torch.Tensor.__array__
    port = str(ROOT / DST)

    def __array__(self, *args, **kwargs):
        if self.device.type != "cpu" and not _caller_file().startswith(port):
            _converted.add(_running[0])
            self = self.cpu()
        return to_numpy(self, *args, **kwargs)

    torch.Tensor.__array__ = __array__


def pytest_runtest_logstart(nodeid, location):
    _running[0] = nodeid


def pytest_collection_modifyitems(items):
    device = os.environ.get("BB25_SUITES_DEVICE", "cuda")
    listed = {e["id"]: e for e in load_table()
              if device in e["devices"] and e["class"] != HOST_COPY}
    for item in items:
        _collected.append(item.nodeid)
        e = listed.get(item.nodeid)
        if e is not None:
            item.add_marker(pytest.mark.xfail(
                strict=True, reason=f"class {e['class']}: {e['reason']}"))


def pytest_collectreport(report):
    if report.failed:  # a file that does not import fails as a whole
        _outcomes[report.nodeid] = "failed"


def pytest_runtest_logreport(report):
    _seconds[report.nodeid] += report.duration
    if report.failed:
        _outcomes[report.nodeid] = "failed"
    elif report.skipped and _outcomes.get(report.nodeid) != "failed":
        _outcomes[report.nodeid] = ("xfailed" if hasattr(report, "wasxfail")
                                    else "skipped")
    elif report.when == "call":
        _outcomes.setdefault(report.nodeid, "passed")


def held_modules() -> dict:
    """The modules of the real JAX package (``bayesian_bm25_tpu[.…]``
    names that are not the port's modules) and of ``jax`` and
    ``jaxlib`` in this process."""
    real = sorted(
        name for name, mod in list(sys.modules.items())
        if (name == SRC or name.startswith(SRC + "."))
        and not getattr(mod, "__name__", "").startswith(DST))
    jax = sorted(name for name in list(sys.modules)
                 if name.split(".")[0] in ("jax", "jaxlib"))
    return {"jax_package": real, "jax": jax}


def pytest_sessionfinish(session, exitstatus):
    from run_examples_torch import launches

    held = held_modules()
    Path(os.environ["BB25_SUITES_OUT"]).write_text(json.dumps({
        "outcomes": _outcomes, "seconds": _seconds,
        "collected": _collected, "converted": sorted(_converted),
        "launches": launches(), "held": held}))
    if held["jax_package"] or held["jax"]:
        print(f"jax_suites_plugin: the process holds {held}", flush=True)
        session.exitstatus = 3
