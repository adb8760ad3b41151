#!/usr/bin/env python3
"""Record the JAX package's examples' standard output as the reference
for the PyTorch port.

    python3 scripts/record_jax_examples.py

Runs each ``examples/*.py`` in its own subprocess with JAX on the CPU in
float64 (``JAX_PLATFORMS=cpu JAX_ENABLE_X64=1``: the precision the port's
library computes in) and writes its standard output to
``tests/data/examples_jax/<name>.txt``. ``examples/sharded_retrieval.py``
makes its own 8-device virtual CPU mesh. A machine with a card but no
JAX compares the port's runs with these files
(``scripts/run_examples_torch.py``, ``chip_smoke.py`` phase 21,
``tests/test_torch_examples.py``). This is the one script of the port's
tooling that runs the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
OUT = ROOT / "tests" / "data" / "examples_jax"


def record(path: Path) -> tuple[str, int, float, str]:
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=str(ROOT))
    env.pop("BB25_EXAMPLE_REAL_DEVICES", None)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(path)], cwd=ROOT, env=env,
                         capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if run.returncode == 0:
        (OUT / f"{path.stem}.txt").write_text(run.stdout)
    return path.stem, run.returncode, secs, run.stderr


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    failed = []
    with ThreadPoolExecutor(max_workers=4) as pool:
        for name, rc, secs, err in pool.map(record,
                                            sorted(EXAMPLES.glob("*.py"))):
            print(f"{name}: exit {rc}, {secs:.1f} s", flush=True)
            if rc:
                failed.append(name)
                print(err[-4000:], file=sys.stderr)
    if failed:
        sys.exit(f"record_jax_examples: {failed} failed")


if __name__ == "__main__":
    main()
