"""Density estimation: Gaussian pdf, weighted KDE, fixed-background
GMM-EM, gap detection and the weight constructions of vector
calibration.

Counterpart of ``bayesian_bm25_tpu/ops/density.py``. Every function
computes on its input's device and in its dtype (float64 for parity with
the JAX package under x64), and returns tensors; the callers in
``models/vector_probability.py`` convert at the numpy boundary.

Numeric contract, as in the JAX package:
  * means divide sums by n (``ops/transform.true_div``): ``torch.mean``
    on CUDA multiplies by 1/n, and every division by a host scalar
    goes through a 0-dim tensor for the same reason;
  * standard deviations are population ones (``jnp.std``);
  * the median of an even-length input averages its two middle values
    (``jnp.median``; ``torch.median`` returns the lower one);
  * ``argmax`` returns the first maximum, as ``jnp.argmax`` does.

The GMM-EM loop (JAX: one ``lax.while_loop``) runs its steps in blocks
of ``GMM_BLOCK_STEPS`` with one host read a block: a step taken after
the loop has stopped is frozen (``torch.where(done, old, new)``), so
the fit stops at JAX's iteration and keeps its parameters, with one
synchronization per block instead of one per step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bayesian_bm25_tpu_torch.ops.mathx import epsilon, sigmoid
from bayesian_bm25_tpu_torch.ops.transform import true_div

_SQRT_2PI = math.sqrt(2.0 * math.pi)
# EM steps queued between two host reads of the stop flag.
GMM_BLOCK_STEPS = 16


def scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number or a tensor) as a 0-dim tensor of ``like``'s dtype
    on its device, so arithmetic with it rounds as one IEEE operation."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def mean(x: torch.Tensor) -> torch.Tensor:
    """Sum over n, as ``jnp.mean`` divides."""
    return true_div(torch.sum(x), float(x.shape[0]))


def std(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation (``jnp.std``)."""
    return torch.sqrt(mean((x - mean(x)) ** 2))


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the middle of the sorted values, the mean of the
    two middle ones for an even length."""
    s = torch.sort(x).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def gaussian_pdf(x: torch.Tensor, mu, sigma) -> torch.Tensor:
    """Normal density."""
    mu, sigma = scalar(mu, x), scalar(sigma, x)
    z = (x - mu) / sigma
    return torch.exp(-0.5 * z * z) / (sigma * _SQRT_2PI)


def silverman_bandwidth(distances: torch.Tensor, weights=None
                        ) -> torch.Tensor:
    """Weighted Silverman rule: h = 1.06 * sigma_w * K_eff^(-1/5), with
    K_eff = (sum w)^2 / sum(w^2); a 0-dim tensor."""
    d = distances
    eps = epsilon(d.dtype)
    w = torch.ones_like(d) if weights is None else weights
    w_sum = torch.sum(w)
    w_sq = torch.sum(w * w)
    k_eff = (w_sum * w_sum) / torch.clamp(w_sq, min=eps)
    mu = torch.sum(w * d) / torch.clamp(w_sum, min=eps)
    var = torch.sum(w * (d - mu) ** 2) / torch.clamp(w_sum, min=eps)
    sigma_w = torch.sqrt(torch.clamp(var, min=0.0))
    h = 1.06 * sigma_w * k_eff ** (-0.2)
    h = torch.where(sigma_w < eps, scalar(eps, d), torch.clamp(h, min=eps))
    return torch.where((w_sum < eps) | (w_sq < eps), scalar(eps, d), h)


def kernel_density(eval_points: torch.Tensor, sample_points: torch.Tensor,
                   weights: torch.Tensor, bandwidth) -> torch.Tensor:
    """Weighted Gaussian KDE through one (n_eval, n_sample) kernel
    matrix and one matrix-vector product."""
    e, s, w = eval_points, sample_points, weights
    eps = epsilon(e.dtype)
    h = scalar(bandwidth, e)
    diff = (e[:, None] - s[None, :]) / h
    kern = torch.exp(-0.5 * diff * diff) / (h * _SQRT_2PI)
    w_sum = torch.sum(w)
    dens = (kern @ w) / torch.clamp(w_sum, min=eps)
    dens = torch.clamp(dens, min=eps)
    return torch.where(w_sum < eps, torch.full_like(dens, eps), dens)


class GMMState(NamedTuple):
    mu_R: torch.Tensor
    sigma_R: torch.Tensor
    pi_R: torch.Tensor
    prev_ll: torch.Tensor
    done: torch.Tensor


def gmm_fixed_background(distances: torch.Tensor, mu_G, sigma_G, mu_R0,
                         sigma_R0, pi_R0, *, max_iter: int = 100,
                         tol: float = 1e-6, mask=None):
    """Two-component GMM-EM with the background (G) component frozen;
    only (mu_R, sigma_R, pi_R) update. ``mask`` (0/1 per sample) drops
    points from the E/M sums and the count. On convergence or a
    degenerate responsibility sum the step keeps the previous
    parameters and the loop ends, as the JAX ``while_loop`` does.
    Returns the fitted (mu_R, sigma_R, pi_R) as 0-dim tensors."""
    d = distances
    eps = epsilon(d.dtype)
    m = torch.ones_like(d) if mask is None else mask.to(d.dtype)
    n = torch.sum(m)
    sigma_G = scalar(sigma_G, d)
    f_G_fixed = gaussian_pdf(d, mu_G, sigma_G)
    floor_sigma = sigma_G * 0.1

    def step(s: GMMState) -> GMMState:
        f_R = s.pi_R * gaussian_pdf(d, s.mu_R, s.sigma_R)
        f_G = (1.0 - s.pi_R) * f_G_fixed
        total = torch.clamp(f_R + f_G, min=eps)
        gamma = (f_R / total) * m
        ll = torch.sum(torch.log(total) * m)
        converged = torch.abs(ll - s.prev_ll) < tol
        gsum = torch.sum(gamma)
        degenerate = gsum < eps
        safe_gsum = torch.clamp(gsum, min=eps)
        mu_new = torch.sum(gamma * d) / safe_gsum
        sig_new = torch.sqrt(torch.sum(gamma * (d - mu_new) ** 2) / safe_gsum)
        sig_new = torch.where(sig_new < eps, floor_sigma, sig_new)
        pi_new = torch.clamp(gsum / n, 0.01, 0.99)
        keep = converged | degenerate
        new = GMMState(
            mu_R=torch.where(keep, s.mu_R, mu_new),
            sigma_R=torch.where(keep, s.sigma_R, sig_new),
            pi_R=torch.where(keep, s.pi_R, pi_new),
            prev_ll=ll, done=keep)
        # A step after the loop ended changes nothing.
        return GMMState(*(torch.where(s.done, a, b) for a, b in zip(s, new)))

    state = GMMState(
        scalar(mu_R0, d), scalar(sigma_R0, d), scalar(pi_R0, d),
        scalar(-math.inf, d),
        torch.zeros((), dtype=torch.bool, device=d.device))
    queued = 0
    while queued < max_iter:
        for _ in range(min(GMM_BLOCK_STEPS, max_iter - queued)):
            state = step(state)
        queued = min(queued + GMM_BLOCK_STEPS, max_iter)
        if bool(state.done):
            break
    return state.mu_R, state.sigma_R, state.pi_R


def detect_gap_index(distances: torch.Tensor, threshold_ratio: float = 0.15):
    """Semantic-cliff detection in sorted distances: (gap_index, found)
    as 0-dim tensors, the index in sorted order of the first element
    after the gap. Primary criterion: the largest gap over the total
    span >= ``threshold_ratio``; fallback: a gap z-score above 2.0."""
    d = distances
    eps = epsilon(d.dtype)
    n = d.shape[0]
    if n < 3:
        return (torch.zeros((), dtype=torch.int64, device=d.device),
                torch.zeros((), dtype=torch.bool, device=d.device))
    sorted_d = torch.sort(d).values
    gaps = torch.diff(sorted_d)
    span = sorted_d[-1] - sorted_d[0]

    ratios = gaps / torch.clamp(span, min=eps)
    ratio_idx = torch.argmax(ratios)
    primary = ratios[ratio_idx] >= threshold_ratio

    std_gap = std(gaps)
    z = (gaps - mean(gaps)) / torch.clamp(std_gap, min=eps)
    z_idx = torch.argmax(z)
    fallback = (std_gap > eps) & (z[z_idx] > 2.0)

    found = (span >= eps) & (primary | fallback)
    idx = torch.where(primary, ratio_idx + 1, z_idx + 1)
    return idx, found


def gap_weights(distances: torch.Tensor):
    """Binary weights: 1.0 below the detected gap threshold, 0.0 at or
    above it. Returns (weights, found)."""
    d = distances
    idx, found = detect_gap_index(d)
    if d.shape[0] < 3:
        return torch.ones_like(d), found
    threshold = torch.sort(d).values[idx]
    return (d < threshold).to(d.dtype), found


def sharpen_weights(weights: torch.Tensor, temperature: float = 0.05
                    ) -> torch.Tensor:
    """Softmax-temperature sharpening that keeps the total mass."""
    w = weights
    eps = epsilon(w.dtype)
    total = torch.sum(w)
    sharp = torch.exp(true_div(w - torch.max(w), float(temperature)))
    ssum = torch.sum(sharp)
    return torch.where(ssum > eps, sharp * (total / ssum), sharp)


def distance_density_weights(distances: torch.Tensor) -> torch.Tensor:
    """Fallback weights sigma(median(d) / d - 1): closer is heavier."""
    d = distances
    eps = epsilon(d.dtype)
    return sigmoid(median(d) / torch.clamp(d, min=eps) - 1.0, d.dtype)
