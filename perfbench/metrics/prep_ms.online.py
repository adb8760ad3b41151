"""Host ms a request in the program's ``encode``, ``split`` and ``h2d``
spans (self time), over the traced window's requests outside the
profiled slice (``perfbench/program_spans.py``)."""

from perfbench.program_spans import PREP


def read(rec):
    p = rec["trace"] and rec["trace"].get("program")
    if not p or not p["requests"] or not set(PREP) & set(p["self_s"]):
        return None
    return 1e3 * sum(p["self_s"].get(n, 0.0) for n in PREP) / p["requests"]
