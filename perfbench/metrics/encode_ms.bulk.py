"""Host ms in the program's ``encode`` spans (self time) per 1,000
queries, over the traced window's requests outside the profiled slice
(``perfbench/program_spans.py``)."""


def read(rec):
    p = rec["trace"] and rec["trace"].get("program")
    if not p or not p["queries"] or "encode" not in p["self_s"]:
        return None
    return 1e3 * p["self_s"]["encode"] / (p["queries"] / 1e3)
