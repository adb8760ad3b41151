"""Wall of ``scorer.index(corpus)`` in set-up, ended by a device
synchronize; corpus generation excluded (host clock)."""


def read(rec):
    return rec["index_s"]
