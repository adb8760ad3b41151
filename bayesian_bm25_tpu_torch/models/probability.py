"""BayesianProbabilityTransform: the stateful wrapper over ops.transform.

Counterpart of ``bayesian_bm25_tpu/models/probability.py``: the
constructor, its attributes and ``score_to_probability``. Fitting and
online updates are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import transform as T

_VALID_MODES = ("balanced", "prior_aware", "prior_free")


def _ret(x: torch.Tensor, *inputs):
    arr = x.cpu().numpy()
    if arr.ndim == 0 and all(np.ndim(i) == 0 for i in inputs):
        return float(arr)
    return arr


class BayesianProbabilityTransform:
    """Transforms raw BM25 scores into calibrated probabilities.

    ``alpha`` is the sigmoid steepness, ``beta`` the midpoint,
    ``base_rate`` an optional corpus-level relevance rate in (0, 1)
    applied through a second Bayes update, ``prior_fn`` an optional
    callable replacing the composite prior.
    """

    _VALID_MODES = _VALID_MODES

    def __init__(self, alpha=1.0, beta=0.0, base_rate=None, prior_fn=None):
        if base_rate is not None and not (0.0 < base_rate < 1.0):
            raise ValueError(f"base_rate must be in (0, 1), got {base_rate}")
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.base_rate = base_rate
        self._prior_fn = prior_fn
        self._training_mode = "balanced"

    def score_to_probability(self, score, tf, doc_len_ratio,
                             dtype: torch.dtype = torch.float64):
        """Full pipeline: score -> likelihood -> prior -> posterior,
        computed on the host in ``dtype``."""
        prior_free = self._training_mode == "prior_free"
        if not prior_free and self._prior_fn is not None:
            prior = T.clamp_probability(
                np.asarray(self._prior_fn(score, tf, doc_len_ratio)), dtype)
            out = T.posterior(T.likelihood(score, self.alpha, self.beta,
                                           dtype),
                              prior, self.base_rate, dtype)
        else:
            out = T.score_to_probability(
                score, tf, doc_len_ratio, self.alpha, self.beta,
                self.base_rate, prior_free=prior_free, dtype=dtype)
        return _ret(out, score, tf, doc_len_ratio)
