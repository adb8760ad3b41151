"""Bayesian probability transform as plain functions on tensors.

Counterpart of ``bayesian_bm25_tpu/ops/transform.py``: the pipeline
(likelihood, priors, posterior, score_to_probability, the WAND bound)
and its learning surface (the batch gradient-descent fit and the online
update). Every function takes an explicit ``dtype``; inputs are
converted to it first, as the JAX module's ``as_float`` does.

  likelihood      L = sigma(alpha * (s - beta))
  tf prior        P_tf = 0.2 + 0.7 * min(1, tf/10)
  norm prior      P_n  = 0.3 + 0.6 * (1 - min(1, |r-0.5|*2))
  composite prior clip(0.7*P_tf + 0.3*P_n, 0.1, 0.9)
  posterior       two-step odds update with optional base rate
  WAND UB         posterior(sigma(alpha*(UB-beta)), p_max=0.9), and its
                  inverse, a certified score prefilter for a threshold
  fit             batch GD on the mean BCE, stopping when both steps
                  fall below ``tolerance`` (the step that converges is
                  applied)
  online update   EMA of the gradient, bias correction, L2 clip, decayed
                  learning rate, alpha floor, Polyak averages
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import mathx
from bayesian_bm25_tpu_torch.ops.mathx import (as_float, clamp_probability,
                                               sigmoid)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division.

    PyTorch's CUDA kernel divides by a host scalar as ``x * (1/c)``,
    which rounds differently from ``x / c`` (for f32 integers 0..4999
    over 10, 999 of the 5000 quotients differ). Dividing by a 0-dim
    tensor on the same device keeps the true division on every device.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def likelihood(score, alpha, beta,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sigmoid likelihood sigma(alpha * (score - beta))."""
    s = as_float(score, dtype)
    return sigmoid(float(alpha) * (s - float(beta)), dtype)


def tf_prior(tf, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Term-frequency prior: 0.2 + 0.7 * min(1, tf / 10)."""
    tf = as_float(tf, dtype)
    return 0.2 + 0.7 * torch.clamp(true_div(tf, 10.0), max=1.0)


def norm_prior(doc_len_ratio, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Doc-length prior: peaks at 0.9 when doc_len/avgdl == 0.5, floor 0.3."""
    r = as_float(doc_len_ratio, dtype)
    return 0.3 + 0.6 * (1.0 - torch.clamp(torch.abs(r - 0.5) * 2.0, max=1.0))


def composite_prior(tf, doc_len_ratio,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """clip(0.7 * P_tf + 0.3 * P_norm, 0.1, 0.9)."""
    return torch.clamp(0.7 * tf_prior(tf, dtype)
                       + 0.3 * norm_prior(doc_len_ratio, dtype), 0.1, 0.9)


def posterior(likelihood_val, prior, base_rate=None,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Two-step Bayes odds update, equivalent to
    sigma(logit L + logit prior [+ logit base_rate])."""
    l_val = as_float(likelihood_val, dtype)
    p = as_float(prior, dtype, device=l_val.device)
    num = l_val * p
    out = clamp_probability(num / (num + (1.0 - l_val) * (1.0 - p)), dtype)
    if base_rate is not None:
        br = float(base_rate)
        num_br = out * br
        out = clamp_probability(
            num_br / (num_br + (1.0 - out) * (1.0 - br)), dtype)
    return out


def score_to_probability(score, tf, doc_len_ratio, alpha, beta,
                         base_rate=None, *, prior_free: bool = False,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Full score -> calibrated probability pipeline.

    ``prior_free`` uses prior 0.5 (posterior == likelihood before the
    base rate)."""
    l_val = likelihood(score, alpha, beta, dtype)
    if prior_free:
        p = torch.full((), 0.5, dtype=dtype, device=l_val.device)
    else:
        p = composite_prior(as_float(tf, dtype, l_val.device),
                            as_float(doc_len_ratio, dtype, l_val.device),
                            dtype)
    return posterior(l_val, p, base_rate=base_rate, dtype=dtype)


def wand_upper_bound(bm25_upper_bound, alpha, beta, base_rate=None,
                     p_max: float = 0.9,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Safe Bayesian probability upper bound for WAND pruning: the
    posterior of the max likelihood at prior ``p_max``."""
    l_max = likelihood(bm25_upper_bound, alpha, beta, dtype)
    return posterior(l_max, p_max, base_rate=base_rate, dtype=dtype)


def wand_score_threshold(threshold: float, alpha: float, beta: float,
                         base_rate: float | None = None,
                         p_max: float = 0.9) -> float:
    """Inverse of :func:`wand_upper_bound`: the smallest BM25 score whose
    certified probability upper bound reaches ``threshold`` (host-side
    float64 math).

    Every stage of the transform is monotone increasing in the score, so
    a document scoring below the returned value cannot reach
    ``threshold``. A small downward margin absorbs float32-vs-float64
    rounding between this inverse and the device (it can only admit
    extra candidates). Returns -inf when the threshold prunes nothing
    (t <= 0, or alpha <= 0), +inf when nothing can pass (t >= 1).
    """
    t = float(threshold)
    a = float(alpha)
    if t <= 0.0 or a <= 0.0:
        return float("-inf")
    if t >= 1.0:
        return float("inf")
    odds = t / (1.0 - t)
    if base_rate is not None:
        br = min(max(float(base_rate), 1e-12), 1.0 - 1e-12)
        odds *= (1.0 - br) / br
    odds_l = odds * (1.0 - p_max) / p_max
    l_min = odds_l / (1.0 + odds_l)
    s_min = float(beta) + float(np.log(l_min) - np.log1p(-l_min)) / a
    if not np.isfinite(s_min):
        return float("-inf") if s_min < 0 else float("inf")
    return s_min - 1e-4 * max(1.0, abs(s_min))


# ---------------------------------------------------------------------------
# Batch fit: gradient descent on the mean BCE with a tolerance stop
# ---------------------------------------------------------------------------


def _bce_grads(alpha, beta, scores, labels, priors, weights,
               prior_aware: bool, dtype: torch.dtype):
    """Mean BCE gradients with respect to (alpha, beta), through the
    posterior when ``prior_aware`` (the chain rule over the composite
    prior in ``priors``), else through the likelihood alone. ``weights``
    are per-sample gradient weights (ones for the plain transform)."""
    L = clamp_probability(sigmoid(alpha * (scores - beta), dtype), dtype)
    if prior_aware:
        p = priors
        denom = L * p + (1.0 - L) * (1.0 - p)
        predicted = clamp_probability(L * p / denom, dtype)
        dP_dL = p * (1.0 - p) / (denom * denom)
        dL_da = L * (1.0 - L) * (scores - beta)
        dL_db = -L * (1.0 - L) * alpha
        err = predicted - labels
        g_a = torch.mean(weights * err * dP_dL * dL_da)
        g_b = torch.mean(weights * err * dP_dL * dL_db)
    else:
        err = L - labels
        g_a = torch.mean(weights * err * (scores - beta))
        g_b = torch.mean(weights * err * (-alpha))
    return g_a, g_b


def fit_transform(alpha0, beta0, scores, labels, *, prior_aware: bool,
                  priors=None, sample_weights=None,
                  learning_rate: float = 0.01, max_iterations: int = 1000,
                  tolerance: float = 1e-6,
                  dtype: torch.dtype = torch.float64):
    """Batch gradient descent on the mean BCE from (alpha0, beta0).

    Stops after the first step whose moves in alpha and beta are both
    below ``tolerance``, with that step applied (the JAX package's
    ``lax.while_loop`` carries the same (alpha, beta, done, it)), or
    after ``max_iterations`` steps. Computes on the scores' device (a
    numpy input on the CPU). Returns (alpha, beta, steps) with alpha and
    beta as 0-dim ``dtype`` tensors there."""
    scores = as_float(scores, dtype)
    labels = as_float(labels, dtype, scores.device)
    weights = (torch.ones_like(scores) if sample_weights is None
               else as_float(sample_weights, dtype, scores.device))
    priors_arr = (torch.zeros_like(scores) if priors is None
                  else as_float(priors, dtype, scores.device))
    dev = scores.device
    lr = torch.tensor(learning_rate, dtype=dtype, device=dev)
    tol = torch.tensor(tolerance, dtype=dtype, device=dev)
    a = torch.tensor(alpha0, dtype=dtype, device=dev)
    b = torch.tensor(beta0, dtype=dtype, device=dev)
    it = 0
    done = False
    while not done and it < max_iterations:
        g_a, g_b = _bce_grads(a, b, scores, labels, priors_arr, weights,
                              prior_aware, dtype)
        na = a - lr * g_a
        nb = b - lr * g_b
        # One device-to-host read a step.
        done = bool((torch.abs(na - a) < tol) & (torch.abs(nb - b) < tol))
        a, b = na, nb
        it += 1
    return a, b, it


# ---------------------------------------------------------------------------
# Online update: EMA + bias correction + clip + lr decay + alpha floor +
# Polyak averaging, as a pure step over the state
# ---------------------------------------------------------------------------


class OnlineTransformState(NamedTuple):
    alpha: torch.Tensor
    beta: torch.Tensor
    grad_alpha_ema: torch.Tensor
    grad_beta_ema: torch.Tensor
    alpha_avg: torch.Tensor
    beta_avg: torch.Tensor
    n_updates: int


def init_online_state(alpha, beta, dtype: torch.dtype = torch.float64,
                      device=None) -> OnlineTransformState:
    a = as_float(alpha, dtype, device)
    b = as_float(beta, dtype, device)
    z = torch.zeros_like(a)
    return OnlineTransformState(a, b, z, z, a, b, 0)


def online_update_step(state: OnlineTransformState, scores, labels, *,
                       prior_aware: bool, priors=None,
                       learning_rate: float = 0.01, momentum: float = 0.9,
                       decay_tau: float = 1000.0, max_grad_norm: float = 1.0,
                       avg_decay: float = 0.995,
                       dtype: torch.dtype = torch.float64
                       ) -> OnlineTransformState:
    """One online SGD update (a single observation or a mini-batch), on
    the device of ``state.alpha``."""
    alpha = as_float(state.alpha, dtype)
    beta = as_float(state.beta, dtype)
    dev = alpha.device
    scores = torch.atleast_1d(as_float(scores, dtype, dev))
    labels = torch.atleast_1d(as_float(labels, dtype, dev))
    priors_arr = (torch.zeros_like(scores) if priors is None
                  else as_float(priors, dtype, dev))
    g_a, g_b = _bce_grads(alpha, beta, scores, labels, priors_arr,
                          torch.ones_like(scores), prior_aware, dtype)

    mom = torch.tensor(momentum, dtype=dtype, device=dev)
    ema_a = mom * as_float(state.grad_alpha_ema, dtype) + (1.0 - mom) * g_a
    ema_b = mom * as_float(state.grad_beta_ema, dtype) + (1.0 - mom) * g_b

    t = int(state.n_updates) + 1
    t_f = torch.tensor(t, dtype=dtype, device=dev)
    correction = 1.0 - mom ** t_f
    c_a = ema_a / correction
    c_b = ema_b / correction

    norm = torch.sqrt(c_a * c_a + c_b * c_b)
    max_norm = torch.tensor(max_grad_norm, dtype=dtype, device=dev)
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    c_a = c_a * scale
    c_b = c_b * scale

    lr = (torch.tensor(learning_rate, dtype=dtype, device=dev)
          / (1.0 + true_div(t_f, decay_tau)))
    alpha = torch.clamp(alpha - lr * c_a, min=mathx.ALPHA_MIN)
    beta = beta - lr * c_b

    ad = torch.tensor(avg_decay, dtype=dtype, device=dev)
    alpha_avg = ad * as_float(state.alpha_avg, dtype) + (1.0 - ad) * alpha
    beta_avg = ad * as_float(state.beta_avg, dtype) + (1.0 - ad) * beta
    return OnlineTransformState(alpha, beta, ema_a, ema_b, alpha_avg,
                                beta_avg, t)
