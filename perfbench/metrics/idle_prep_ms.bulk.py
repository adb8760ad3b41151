"""Device-idle ms in the profiled slice while the host runs the
program's ``encode``, ``split`` or ``h2d`` spans (the innermost one
open), per 1,000 queries of the slice (``perfbench/program_spans.py``)."""

from perfbench.program_spans import PREP


def read(rec):
    t = rec["trace"]
    p = t and t.get("program")
    if not p or not t["queries"] or not p["idle_s"]:
        return None
    ms = 1e3 * sum(p["idle_s"].get(n, 0.0) for n in PREP)
    return ms / (t["queries"] / 1e3)
