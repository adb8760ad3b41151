"""Device ms of every rare-postings merge pass (``_sparse_merge``) per
1,000 queries in the profiled slice."""


def read(rec):
    t = rec["trace"]
    if not t or not t["queries"]:
        return None
    ms = sum(v for st, d in t["stages"].items() if st.startswith("merge")
             for b, v in d.items() if b != "calls")
    return ms / (t["queries"] / 1e3) if ms > 0 else None
