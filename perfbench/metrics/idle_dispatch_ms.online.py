"""Device-idle ms a request in the profiled slice while the host runs
one of the program's stage spans (the innermost one open: the
frequent-term product, leader selection, a merge pass, tf with the
transform, or a whole score), over the slice's requests
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import is_stage


def read(rec):
    t = rec["trace"]
    p = t and t.get("program")
    if not p or not t["requests"] or not p["idle_s"]:
        return None
    return 1e3 * sum(v for n, v in p["idle_s"].items()
                     if is_stage(n)) / t["requests"]
