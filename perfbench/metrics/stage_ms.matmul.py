"""Device ms of the frequent-term product (unfused or K4) per 1,000
queries in the profiled slice, kernels attributed to the stage by
correlation id."""


def read(rec):
    t = rec["trace"]
    if not t or not t["queries"] or "matmul" not in t["stages"]:
        return None
    ms = sum(v for b, v in t["stages"]["matmul"].items() if b != "calls")
    return ms / (t["queries"] / 1e3) if ms > 0 else None
