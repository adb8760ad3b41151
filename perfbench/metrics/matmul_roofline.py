"""The frequent-term product's least time for its work
(``perfbench/roofline.py``) over its device ms in the profiled slice,
in percent of the published peak."""


def read(rec):
    t = rec["trace"]
    if not t or t["matmul_bound_ms"] is None or "matmul" not in t["stages"]:
        return None
    ms = sum(v for b, v in t["stages"]["matmul"].items() if b != "calls")
    return 100.0 * t["matmul_bound_ms"] / ms if ms > 0 else None
