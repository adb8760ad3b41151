"""The benchmarks' synthetic data, drawn as numpy 2.0 draws it.

``benchmarks/utils.py`` draws its corpora from ``np.random.default_rng``,
token frequencies by ``Generator.zipf``. Releases of numpy after 2.0 draw
other values from ``zipf`` for the same seed, so two machines with two
numpy releases build two corpora, and the JAX package's recorded outputs
and gate artifacts (drawn under numpy 2.0) describe another dataset.
``pin_zipf(module)`` makes ``module``'s ``np.random.default_rng`` return a
``Numpy20Generator``: numpy's own generator (the same bit stream, every
other distribution numpy's) whose ``zipf`` is numpy 2.0's rejection
sampler, so every machine draws the same corpora.
"""

from __future__ import annotations

import math
import types

import numpy as np

_INT64_MAX = 9223372036854775807.0


class Numpy20Generator(np.random.Generator):
    """``np.random.Generator`` with numpy 2.0's ``zipf``."""

    def zipf(self, a, size=None):
        """numpy 2.0's sampler: per draw, U = 1 - u1 and V = u2 from two
        doubles of the stream, X = floor(U ** (-1 / (a - 1))), accepted
        when V * X * (T - 1) / (b - 1) <= T / b with T = (1 + 1 / X) **
        (a - 1) and b = 2 ** (a - 1); X outside [1, INT64_MAX] is
        redrawn. Leaves the stream where numpy 2.0 leaves it."""
        n = 1 if size is None else int(np.prod(size))
        am1 = float(a) - 1.0
        exponent, b = -1.0 / am1, math.pow(2.0, am1)
        state = self.bit_generator.state
        out, pairs, m = [], 0, max(2 * n, 16)
        while len(out) < n:
            buf = self.random(2 * m).tolist()
            for i in range(0, 2 * m, 2):
                pairs += 1
                x = math.floor(math.pow(1.0 - buf[i], exponent))
                if x > _INT64_MAX or x < 1.0:
                    continue
                t = math.pow(1.0 + 1.0 / x, am1)
                if buf[i + 1] * x * (t - 1.0) / (b - 1.0) <= t / b:
                    out.append(int(x))
                    if len(out) == n:
                        break
            m *= 2
        # Consume exactly the doubles the accepted draws used.
        self.bit_generator.state = state
        self.random(2 * pairs)
        if size is None:
            return out[0]
        return np.asarray(out, dtype=np.int64).reshape(size)


def default_rng(seed=None) -> Numpy20Generator:
    """``np.random.default_rng(seed)`` for a seed (PCG64 over its
    SeedSequence), as a ``Numpy20Generator``."""
    return Numpy20Generator(np.random.PCG64(seed))


def zipf_is_numpy20() -> bool:
    """Whether this numpy's ``zipf`` draws what numpy 2.0's does."""
    return bool(np.array_equal(np.random.default_rng(0).zipf(1.3, 4096),
                               default_rng(0).zipf(1.3, 4096)))


def pin_zipf(module) -> None:
    """Rebind ``module.np`` to numpy with this ``default_rng``."""
    rand = types.ModuleType("numpy.random")
    rand.__dict__.update(vars(np.random))
    rand.default_rng = default_rng
    pinned = types.ModuleType("numpy")
    pinned.__dict__.update(vars(np))
    pinned.random = rand
    module.np = pinned
