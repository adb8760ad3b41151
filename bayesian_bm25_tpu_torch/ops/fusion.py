"""Fusion algebra on tensors: boolean ops, gating, log-odds conjunction.

Counterpart of ``bayesian_bm25_tpu/ops/fusion.py``. Every function
computes on its input's device and in its dtype (a float tensor is
used as it is; an array-like goes through ``mathx.as_input``, onto the
default device, the card), and copies nothing. The learnable and attention weight models are in
``ops/fusion_learn.py`` and ``models/fusion_weights.py``.

Numeric contract, as in the JAX package: ``SQRT_N_ALPHA`` = 0.5; the
weighted default alpha is 0.0, the unweighted one 0.5; the GELU gate
constant is 1.702. Divisions by a host scalar go through
``ops/transform.true_div`` (CUDA turns them into a reciprocal multiply).
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.ops.mathx import (as_float, as_input,
                                               clamp_probability, logit, min_max_normalize,
                                               sigmoid)
from bayesian_bm25_tpu_torch.ops.transform import true_div

SQRT_N_ALPHA = 0.5  # alpha=0.5 implements the sqrt(n) scaling law
VALID_GATES = ("none", "relu", "swish", "gelu", "softplus")


def tensor(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` as a float tensor: a float tensor as it is; an integer
    tensor as float64 on its device; an array-like as ``as_input`` reads
    it. With ``like``, in ``like``'s dtype and on its device."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x if like is None else x.to(dtype=like.dtype,
                                           device=like.device)
    if like is not None:
        return as_float(x, like.dtype, like.device)
    if isinstance(x, torch.Tensor):
        return as_float(x, torch.float64)
    return as_input(x)


def resolve_alpha(alpha, default: float) -> float:
    """Resolve the confidence-scaling exponent: "auto" -> 0.5, None ->
    ``default``."""
    if alpha is None:
        return default
    if isinstance(alpha, str):
        if alpha != "auto":
            raise ValueError(
                f"alpha must be a float, None, or 'auto', got {alpha!r}")
        return SQRT_N_ALPHA
    return float(alpha)


def cosine_to_probability(score) -> torch.Tensor:
    """Map cosine similarity [-1, 1] -> probability (1 + s) / 2, clamped."""
    s = tensor(score)
    return clamp_probability(true_div(1.0 + s, 2.0), s.dtype)


def prob_not(prob) -> torch.Tensor:
    """Complement rule: 1 - p, clamped on both input and output."""
    p = tensor(prob)
    return clamp_probability(1.0 - clamp_probability(p, p.dtype), p.dtype)


def prob_and(probs) -> torch.Tensor:
    """Product rule in log space: exp(sum ln p) over the last axis."""
    p = tensor(probs)
    return torch.exp(torch.sum(torch.log(clamp_probability(p, p.dtype)),
                               dim=-1))


def prob_or(probs) -> torch.Tensor:
    """Complement rule in log space: 1 - exp(sum ln(1 - p)) over the
    last axis."""
    p = tensor(probs)
    return 1.0 - torch.exp(torch.sum(torch.log1p(-clamp_probability(
        p, p.dtype)), dim=-1))


def apply_gating(logits, gating: str, beta: float = 1.0) -> torch.Tensor:
    """Sparse-signal gating in logit space.

    relu: MAP under a sparse prior; swish: the Bayes estimate
    x * sigma(beta * x); gelu: x * sigma(1.702 * x) (beta ignored);
    softplus: logaddexp(0, beta * x) / beta (``F.softplus`` switches to
    the identity above its threshold, so it is not the same function).
    """
    x = tensor(logits)
    if gating == "none":
        return x
    if gating == "relu":
        return torch.clamp(x, min=0.0)
    if gating == "swish":
        return x * sigmoid(beta * x, x.dtype)
    if gating == "gelu":
        return x * sigmoid(1.702 * x, x.dtype)
    if gating == "softplus":
        return true_div(torch.logaddexp(torch.zeros_like(x), beta * x),
                        float(beta))
    raise ValueError(f"gating must be one of {VALID_GATES}, got {gating!r}")


def log_odds_conjunction(probs, alpha=None, weights=None,
                         gating: str = "none", gating_beta: float = 1.0,
                         max_logit=None) -> torch.Tensor:
    """Log-odds conjunction with multiplicative confidence scaling.

    Unweighted: sigma(mean(logit p) * n^alpha), alpha 0.5 by default.
    Weighted Log-OP: sigma(n^alpha * sum(w_i * logit p_i)), w >= 0
    summing to 1, alpha 0.0 by default. Gating applies before the
    aggregation; ``max_logit`` clips the gated logits.
    """
    p = tensor(probs)
    n = p.shape[-1]
    x = apply_gating(logit(p, p.dtype), gating, beta=gating_beta)
    if max_logit is not None:
        x = torch.clamp(x, -max_logit, max_logit)
    if weights is not None:
        w = tensor(weights, like=x)
        eff_alpha = resolve_alpha(alpha, default=0.0)
        return sigmoid((n ** eff_alpha) * torch.sum(w * x, dim=-1), x.dtype)
    eff_alpha = resolve_alpha(alpha, default=0.5)
    l_bar = true_div(torch.sum(x, dim=-1), float(n))
    return sigmoid(l_bar * (n ** eff_alpha), x.dtype)


def balanced_log_odds_fusion(sparse_probs, dense_similarities,
                             weight: float = 0.5) -> torch.Tensor:
    """Hybrid sparse + dense fusion score: both logit arrays min-max
    normalized to [0, 1] (a zero span maps to zeros), then
    weight * dense + (1 - weight) * sparse. A score, not a probability.
    """
    sp = tensor(sparse_probs)
    logit_sparse = logit(clamp_probability(sp, sp.dtype), sp.dtype)
    dense = cosine_to_probability(tensor(dense_similarities, like=sp))
    logit_dense = logit(dense, sp.dtype)
    w = float(weight)
    return (w * min_max_normalize(logit_dense)
            + (1.0 - w) * min_max_normalize(logit_sparse))
