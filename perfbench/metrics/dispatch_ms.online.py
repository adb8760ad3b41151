"""Host ms a request in the program's stage spans (self time: the
frequent-term product, leader selection, each merge pass, tf with the
transform, or the whole score of the doc-major and compare-tail paths),
over the traced window's requests outside the profiled slice
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import is_stage


def read(rec):
    p = rec["trace"] and rec["trace"].get("program")
    if not p or not p["requests"]:
        return None
    s = [v for n, v in p["self_s"].items() if is_stage(n)]
    return 1e3 * sum(s) / p["requests"] if s else None
