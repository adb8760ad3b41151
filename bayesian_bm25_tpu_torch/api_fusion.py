"""NumPy-facing fusion API.

Counterpart of ``bayesian_bm25_tpu/api_fusion.py``: thin wrappers over
the tensor functions of ``ops/fusion.py`` that take numpy arrays or
scalars, validate eagerly (the JAX package's ``ValueError`` messages),
compute in float64 on ``device`` (the card unless the caller names
another, ``ops/mathx.resolve_device``) and return numpy arrays, or
Python floats for scalar inputs. Tensor pipelines call ``ops/fusion``
directly.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import fusion as F
from bayesian_bm25_tpu_torch.ops.mathx import as_float, resolve_device


def _on(x, device) -> torch.Tensor:
    return as_float(x, torch.float64, resolve_device(device))


def _ret(x: torch.Tensor, *inputs):
    arr = x.cpu().numpy()
    if arr.ndim == 0 and all(np.ndim(i) == 0 for i in inputs if i is not None):
        return float(arr)
    return arr


def cosine_to_probability(score, device=None):
    """Cosine similarity [-1, 1] -> probability (1 + s) / 2."""
    return _ret(F.cosine_to_probability(_on(score, device)), score)


def prob_not(prob, device=None):
    """P(NOT R) = 1 - P(R)."""
    return _ret(F.prob_not(_on(prob, device)), prob)


def prob_and(probs, device=None):
    """AND by the product rule in log space over the last axis."""
    return _ret(F.prob_and(_on(probs, device)))


def prob_or(probs, device=None):
    """OR by the complement rule in log space over the last axis."""
    return _ret(F.prob_or(_on(probs, device)))


def log_odds_conjunction(probs, alpha=None, weights=None,
                         gating: str = "none", gating_beta: float = 1.0,
                         max_logit=None, device=None):
    """Log-odds conjunction (unweighted mean or weighted Log-OP) with
    optional gating and logit clipping (``ops/fusion.py``)."""
    if gating not in F.VALID_GATES:
        raise ValueError(
            f"gating must be 'none', 'relu', 'swish', 'gelu', or 'softplus', "
            f"got {gating!r}"
        )
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        if np.any(w < 0):
            raise ValueError("weights must be non-negative")
        if abs(float(np.sum(w)) - 1.0) > 1e-6:
            raise ValueError(f"weights must sum to 1, got {float(np.sum(w))}")
    F.resolve_alpha(alpha, 0.0)  # eager "auto"/float validation
    p = _on(probs, device)
    return _ret(F.log_odds_conjunction(
        p, alpha=alpha, weights=None if weights is None else _on(weights,
                                                                 p.device),
        gating=gating, gating_beta=gating_beta, max_logit=max_logit))


def balanced_log_odds_fusion(sparse_probs, dense_similarities, weight=0.5,
                             device=None):
    """Hybrid sparse + dense fusion scores."""
    return _ret(F.balanced_log_odds_fusion(
        _on(sparse_probs, device), _on(dense_similarities, device), weight),
        sparse_probs, dense_similarities)
