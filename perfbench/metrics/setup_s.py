"""Process start to the first timed request: imports, library load or
build, generation, index, warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
