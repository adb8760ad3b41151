"""The JAX package's scripts on the port: an import alias and the port's
default device.

``install_alias()`` puts a meta-path finder into this process that
resolves imports of ``bayesian_bm25_tpu`` and every
``bayesian_bm25_tpu.<sub>`` to the port's module of the same name
(``bayesian_bm25_tpu_torch.<sub>``), and ``benchmarks.hybrid_beir`` to
``benchmarks_torch.hybrid_beir``. The JAX package's examples and
benchmark scripts then run unchanged on the port
(``scripts/run_examples_torch.py``, ``scripts/run_benchmarks_torch.py``).

``card_means_cpu()`` makes every port entry point that is given no device,
or is given the card, compute on the CPU: for scripts that name no device
when the caller asked for the CPU. A mesh over n cards becomes n shards
on the CPU.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import pkgutil
import sys

SRC, DST = "bayesian_bm25_tpu", "bayesian_bm25_tpu_torch"
# Modules outside the package that resolve to the port's copy.
MODULES = {"benchmarks.hybrid_beir": "benchmarks_torch.hybrid_beir"}


def _target(fullname: str) -> str | None:
    if fullname == SRC or fullname.startswith(SRC + "."):
        return DST + fullname[len(SRC):]
    return MODULES.get(fullname)


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports of ``bayesian_bm25_tpu[.sub]`` and of the names in
    ``MODULES`` resolve to the port's module."""

    def find_spec(self, fullname, path=None, target=None):
        if _target(fullname) is None:
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        return importlib.import_module(_target(spec.name))

    def exec_module(self, module):
        pass


def install_alias() -> None:
    """Install the finder; raises if this process already holds a module
    that it would map."""
    if any(isinstance(f, _Alias) for f in sys.meta_path):
        return
    held = [m for m in sys.modules if _target(m) is not None]
    if held:
        raise RuntimeError(f"{held[0]} is already imported in this process")
    sys.meta_path.insert(0, _Alias())


def card_means_cpu() -> None:
    """Rebind ``resolve_device`` in every module of the port that bound it
    by name, so that None and the card mean the CPU."""
    import torch

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

    from bayesian_bm25_tpu_torch.parallel import sharded

    def cpu_shards(n):
        return [torch.device("cpu")] * n

    sharded._cards = cpu_shards
