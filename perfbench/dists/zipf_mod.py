"""Term ids Zipf(a) mod ``mod``, as ``rng.zipf(a) % mod`` draws them in
the upstream scale test, from the folded distribution's exact
probabilities (Hurwitz zeta) by the alias method: ~10x faster than
``rng.zipf`` for the 120M tokens of a 1M-document corpus.
{"a": 1.3, "mod": 30000}."""

import numpy as np


def probabilities(a: float, mod: int) -> np.ndarray:
    """P(zipf(a) % mod == r) for r in [0, mod)."""
    from scipy.special import zeta

    r = np.arange(mod, dtype=np.float64)
    p = np.empty(mod)
    p[0] = zeta(a) * mod ** -a                   # mod, 2 mod, ...
    p[1:] = zeta(a, r[1:] / mod) * mod ** -a     # r, r + mod, ...
    return p / p.sum()


def alias_table(p: np.ndarray):
    """Vose's alias table: (threshold, alias) for draws in O(1)."""
    n = len(p)
    q = p * n
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if q[i] < 1.0]
    large = [i for i in range(n) if q[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        alias[s] = g
        q[g] -= 1.0 - q[s]
        (small if q[g] < 1.0 else large).append(g)
    for i in small + large:
        q[i] = 1.0
    return q, alias


def sampler(params):
    threshold, alias = alias_table(
        probabilities(float(params["a"]), int(params["mod"])))
    n = len(threshold)

    def draw(rng, size):
        col = rng.integers(0, n, size, dtype=np.int32)
        keep = rng.random(size) < threshold[col]
        return np.where(keep, col, alias[col]).astype(np.int32)
    return draw
