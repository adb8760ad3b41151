"""Every draw is ``n``: {"n": 120}."""

import numpy as np


def sampler(params):
    n = int(params["n"])

    def draw(rng, size):
        return np.full(size, n, dtype=np.int64)
    return draw
