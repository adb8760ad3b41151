"""One plus a Poisson draw: {"lam": 9.8} has mean 10.8. Stratified as
``lognormal``: the n mid-quantiles, in an order drawn from the seed."""

import numpy as np


def sampler(params):
    from scipy.stats import poisson

    lam = float(params["lam"])
    top = int(lam + 40 * np.sqrt(lam) + 40)
    cdf = poisson.cdf(np.arange(top), lam)

    def draw(rng, size):
        u = (np.arange(size) + 0.5) / size
        # the ppf: the least k with cdf(k) >= u
        x = 1 + np.searchsorted(cdf, u, side="left").astype(np.int64)
        return rng.permutation(x)
    return draw
