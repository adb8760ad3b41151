#!/usr/bin/env python3
"""The control of a cell's comparison, on the card: the program with its
own lower-precision path switched on (the configuration's ``control``:
scorer arguments, such as bf16 storage in place of hilo, and entry
arguments, such as ``coarse=True`` in place of the int8 pair), run
through the cell's window at its own size and compared with the plain
reference as a run is. Its numbers are the upper readings that the
limits in ``perfbench/limits/<cell>.json`` sit below; the benchmark's
own runs never run it. With ``--program`` the same loop runs the
program as configured, for the lower readings: many seeds in one
process.

    python3 perfbench/control.py --workload <cell> --seconds 5 \
        --seeds 101 102 103 [--program]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


class WithArgs:
    """The scorer with extra keyword arguments on its two entries."""

    def __init__(self, scorer, kwargs: dict):
        self._scorer, self._kwargs = scorer, dict(kwargs)

    def retrieve(self, queries, **kw):
        return self._scorer.retrieve(queries, **{**kw, **self._kwargs})

    def retrieve_stream(self, batches, **kw):
        return self._scorer.retrieve_stream(batches,
                                            **{**kw, **self._kwargs})


def control_run(name: str, seed: int, seconds: float, **kw):
    """One run of the cell with the configuration's control switched
    on; keyword arguments as ``run.run_cell``'s."""
    from perfbench import plugins, run

    config = copy.deepcopy(kw.pop("config", None)
                           or plugins.cell(name, plugins.benchmark())["config"])
    ctl = config["control"]
    config["scorer"] = {**config["scorer"], **ctl.get("scorer", {})}
    entry = ctl.get("entry", {})
    return run.run_cell(name, seed, seconds, False, config=config,
                        wrap=(lambda s: WithArgs(s, entry)) if entry else None,
                        **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="run the program as configured, not the control")
    args = ap.parse_args(argv)
    from perfbench import run

    run.pin_caches()
    import torch
    if not torch.cuda.is_available():
        run.log("the control runs on a CUDA card")
        return run.EXIT_NO_CARD
    for seed in args.seeds:
        if args.program:
            result, lines = run.run_cell(args.workload, seed, args.seconds,
                                         False)
        else:
            result, lines = control_run(args.workload, seed, args.seconds)
        for line in lines:
            run.log(line)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              control=not args.program,
                              correct=result["correct"],
                              checks=result["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
