"""Closed loop, one caller, ``BayesianBM25Scorer.retrieve``: each
request is handed, waited for and timed alone, then the next; the pool
is cycled. The request that straddles the close finishes after it and
counts as late."""

from __future__ import annotations

import time

from perfbench.window import Window


def warm(scorer, pool, traffic) -> None:
    """One request of every size in the pool, then the pool's first
    ``warm_requests``: the shapes the window uses and no others."""
    seen = set()
    k = int(traffic["k"])
    for r in range(len(pool)):
        if pool.size(r) not in seen:
            seen.add(pool.size(r))
            scorer.retrieve(pool.tokens[r], k=k)
    for r in range(min(int(traffic.get("warm_requests", 0)), len(pool))):
        scorer.retrieve(pool.tokens[r], k=k)


def run(scorer, pool, traffic, seconds: float, tick=None) -> Window:
    clock = time.perf_counter
    win = Window(clock(), float(seconds))
    k = int(traffic["k"])
    r = 0
    while True:
        if tick is not None:
            tick(len(win.hand))
        t = clock()
        if t >= win.end:
            return win
        i = win.handed(r, pool.size(r), t)
        answer = scorer.retrieve(pool.tokens[r], k=k)
        win.finished(i, clock(), answer)
        r = (r + 1) % len(pool)
