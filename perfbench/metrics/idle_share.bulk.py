"""1 - (union of device-busy intervals) / wall of the profiled slice."""


def read(rec):
    t = rec["trace"]
    if not t or not t["busy_s"]:
        return None
    return 1.0 - t["busy_s"] / t["slice_s"]
