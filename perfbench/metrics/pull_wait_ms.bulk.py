"""Host ms in the program's ``pull.behind`` spans (self time: the
device-to-host copy, with the wait behind the batches launched after
the request's own) per 1,000 queries, over the traced window's requests
outside the profiled slice (``perfbench/program_spans.py``)."""


def read(rec):
    p = rec["trace"] and rec["trace"].get("program")
    if not p or not p["queries"] or "pull.behind" not in p["self_s"]:
        return None
    return 1e3 * p["self_s"]["pull.behind"] / (p["queries"] / 1e3)
