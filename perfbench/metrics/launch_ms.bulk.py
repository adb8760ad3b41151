"""Host ms in the scorer's launch (encode, copies, kernel launches;
``models/scorer._retrieve_launch``) per 1,000 queries, over the traced
window's requests outside the profiled slice."""


def read(rec):
    t = rec["trace"]
    if not t or not t["launch_queries"]:
        return None
    return 1e3 * t["launch_s"] / (t["launch_queries"] / 1e3)
