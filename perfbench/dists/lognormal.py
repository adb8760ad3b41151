"""Lengths from a lognormal with the given arithmetic mean and log-space
sigma, rounded and clipped: {"mean": 132.3, "sigma": 0.75, "min": 1,
"max": 2048}. Stratified: n draws are the distribution's n
mid-quantiles in an order drawn from the seed, so every seed holds the
same lengths and the seed changes which document has which, not the
work."""

import math

import numpy as np


def sampler(params):
    from scipy.special import ndtri

    sigma = float(params["sigma"])
    mu = math.log(float(params["mean"])) - sigma * sigma / 2.0
    lo, hi = int(params["min"]), int(params["max"])

    def draw(rng, size):
        u = (np.arange(size) + 0.5) / size
        x = np.clip(np.rint(np.exp(mu + sigma * ndtri(u))), lo, hi)
        return rng.permutation(x.astype(np.int64))
    return draw
