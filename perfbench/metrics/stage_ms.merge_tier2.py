"""Device ms of the tier-2 merge passes per 1,000 queries in the
profiled slice: the stages whose name starts ``merge tier-2``, where
``tracing.merge_kind`` puts both group-B passes (tier-2 and its heavy
half). None where no tier-2 pass ran, as on an index whose rare
postings fit one rectangle."""


def read(rec):
    t = rec["trace"]
    if not t or not t["queries"]:
        return None
    ms = sum(v for st, d in t["stages"].items()
             if st.startswith("merge tier-2")
             for b, v in d.items() if b != "calls")
    return ms / (t["queries"] / 1e3) if ms > 0 else None
