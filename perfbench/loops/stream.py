"""Closed loop, one caller, ``BayesianBM25Scorer.retrieve_stream``:
requests cycle through the pool while ``lookahead`` of them stay
launched ahead; a request is handed when the stream takes it and done
when its answer is yielded on the host. At the window's close the feed
stops and the stream drains what it holds."""

from __future__ import annotations

import time

from perfbench.window import Window


def warm(scorer, pool, traffic) -> None:
    n = min(len(pool), int(traffic["warm_requests"]))
    for _ in scorer.retrieve_stream(pool.tokens[:n], k=int(traffic["k"]),
                                    lookahead=int(traffic["lookahead"])):
        pass


def run(scorer, pool, traffic, seconds: float, tick=None) -> Window:
    clock = time.perf_counter
    win = Window(clock(), float(seconds))
    order = []

    def feed():
        r = 0
        while True:
            if tick is not None:
                tick(len(order))
            now = clock()
            if now >= win.end:
                return
            order.append(win.handed(r, pool.size(r), now))
            yield pool.tokens[r]
            r = (r + 1) % len(pool)

    stream = scorer.retrieve_stream(feed(), k=int(traffic["k"]),
                                    lookahead=int(traffic["lookahead"]))
    for n, answer in enumerate(stream):
        win.finished(order[n], clock(), answer)
    return win
