"""Wall of the program's ``index.build`` span inside
``scorer.index(corpus)``, ended by a device synchronize, seconds
(``perfbench/program_spans.py``)."""


def read(rec):
    p = rec["trace"] and rec["trace"].get("program")
    if not p:
        return None
    return p["index_s"].get("index.build")
