"""Kernels, copies and memsets on the device in the profiled slice, per
request."""


def read(rec):
    t = rec["trace"]
    if not t or not t["requests"] or not t["device_events"]:
        return None
    return t["device_events"] / t["requests"]
