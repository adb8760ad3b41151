"""95th percentile, over every request completed in the window, of the
time from handing the request to the entry to its ids and
probabilities on the host (host clock)."""


def read(rec):
    return rec["window"].latency_p95_ms()
