"""Host ms in the scorer's launch (``models/scorer._retrieve_launch``)
per request, over the traced window's requests outside the profiled
slice."""


def read(rec):
    t = rec["trace"]
    if not t or not t["launch_requests"]:
        return None
    return 1e3 * t["launch_s"] / t["launch_requests"]
