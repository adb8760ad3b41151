"""The window's arithmetic: a rate over all the work and all the seconds,
a tail over all completed requests; a stall moves both."""

import numpy as np
import pytest

from perfbench.window import Window


def steady(n=400, every=0.01, took=0.004, size=8, stall_at=None,
           stall=0.0):
    w = Window(t0=100.0, seconds=n * every)
    t = 100.0
    for i in range(n + 5):
        if t >= w.end:
            break
        j = w.handed(i % 7, size, t)
        d = took + (stall if i == stall_at else 0.0)
        w.finished(j, t + d, ("ids", "probs"))
        t = t + max(every, d)
    return w


def test_rate_over_the_whole_window():
    w = steady()
    assert len(w.completed()) == 400
    assert w.qps() == pytest.approx(400 * 8 / 4.0)


def test_p95_over_every_request():
    w = steady()
    assert w.latency_p95_ms() == pytest.approx(4.0)
    lat = w.latencies_ms()
    assert len(lat) == 400


def test_a_stall_moves_rate_and_tail():
    base = steady()
    # 30 requests stall: 7.5% of the window's requests, above the tail.
    w = Window(t0=100.0, seconds=4.0)
    t = 100.0
    i = 0
    while t < w.end:
        j = w.handed(i % 7, 8, t)
        d = 0.004 + (0.05 if i % 13 == 0 else 0.0)
        w.finished(j, t + d, ("ids", "probs"))
        t += max(0.01, d)
        i += 1
    assert w.qps() < base.qps() * 0.93
    assert w.latency_p95_ms() > 40.0
    # one long stall: the rate drops by the stalled seconds
    one = steady(stall_at=10, stall=1.0)
    assert one.qps() < base.qps() * 0.8


def test_late_and_lost_requests():
    w = Window(t0=0.0, seconds=1.0)
    a = w.handed(0, 4, 0.1)
    w.finished(a, 0.2, "x")
    b = w.handed(1, 4, 0.9)
    w.finished(b, 1.3, "x")          # late: not in the rate or the tail
    w.handed(2, 4, 0.95)             # never answered
    assert w.attempted() == 3
    assert w.completed() == [a]
    assert w.failed() == 1
    assert w.qps() == 4.0
    assert np.allclose(w.latencies_ms(), [100.0])


def test_idle_gaps_are_named_by_the_innermost_host_span():
    from perfbench import tracing

    busy = tracing.union([(0, 2), (1, 3), (10, 12), (20, 21)])
    assert busy == [[0, 3], [10, 12], [20, 21]]
    gaps = tracing.idle_gaps(busy, 0, 30)
    assert gaps == [(3, 10), (12, 20), (21, 30)]
    spans = [(2, 15, "launch"), (4, 9, "encode"), (16, 19, "pull")]
    tl = tracing.host_timeline(spans)
    names = [tracing.label_at(tl, (s + e) / 2) for s, e in gaps]
    assert names == ["encode", "pull", "harness"]
    assert tracing.label_at(tl, 12) == "launch"


def test_completions_per_slot_show_a_slow_start():
    w = steady(n=400, every=0.01, size=8)        # 4 s, 100 requests a second
    assert w.completed_per(1.0) == [800, 800, 800, 800]
    assert sum(w.completed_per(1.5)) == 400 * 8  # a shorter last slot
    assert len(w.completed_per(1.5)) == 3
    slow = steady(n=400, every=0.01, size=8, stall_at=0, stall=1.0)
    per = slow.completed_per(1.0)
    assert per[0] < per[1] and sum(per) == 8 * len(slow.completed())
