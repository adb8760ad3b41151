"""Vector similarity calibration via the likelihood-ratio framework.

Counterpart of ``bayesian_bm25_tpu/models/vector_probability.py``:

    P(R|d) = sigmoid(log(f_R(d) / f_G(d)) + logit(P_base))

with f_G a fitted background Gaussian and f_R estimated by weighted KDE
or fixed-background GMM-EM (``ops/density.py``), routed as the JAX
package routes them (gap detection -> KDE or GMM, sharpened weights,
the density prior, the distance fallback). A transform holds a
``device``, the card unless the caller names another
(``ops/mathx.resolve_device``): the estimators, the density ratio and
the priors compute there in float64, the routing decisions are read
back as the JAX package reads them, and results return as numpy arrays
(Python floats for scalar input). The JAX package's host placement and
its power-of-two padding of the sample (there to bound XLA compiles)
are not copied: padding with zero weights is a no-op, so the unpadded
estimate is the same up to the order of the float64 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.models.probability import _pointwise
from bayesian_bm25_tpu_torch.ops import density as dens
from bayesian_bm25_tpu_torch.ops.mathx import (as_float, clamp_probability,
                                               logit, resolve_device,
                                               sigmoid)
from bayesian_bm25_tpu_torch.ops.transform import true_div

_EPS = 1e-10
_F64 = torch.float64


def _on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=_F64, device=device)
    return as_float(np.asarray(x, dtype=np.float64), _F64, device)


def _ret(x: torch.Tensor):
    out = x.cpu().numpy()
    return float(out) if out.ndim == 0 else out


class VectorProbabilityTransform:
    """Calibrates vector distances into probabilities (Theorem 3.1.1).

    Parameters: background Gaussian (mu_G, sigma_G), an optional
    base_rate in (0, 1) (None: the neutral logit 0) and the ``device``
    the estimators run on.
    """

    def __init__(self, mu_G: float, sigma_G: float, base_rate=None,
                 device=None) -> None:
        if sigma_G <= 0.0:
            raise ValueError(f"sigma_G must be positive, got {sigma_G}")
        if base_rate is not None and not (0.0 < base_rate < 1.0):
            raise ValueError(f"base_rate must be in (0, 1), got {base_rate}")
        self._device = resolve_device(device)
        self.mu_G = float(mu_G)
        self.sigma_G = float(sigma_G)
        self.base_rate = base_rate
        self._logit_base_rate = (
            float(logit(torch.tensor(float(base_rate), dtype=_F64,
                                     device=self._device), _F64))
            if base_rate is not None else 0.0)

    @property
    def device(self) -> torch.device:
        return self._device

    @classmethod
    def fit_background(cls, distances, *, base_rate=None, device=None):
        """Estimate (mu_G, sigma_G) from a corpus distance sample (host
        numpy, as in the JAX package)."""
        d = np.asarray(distances, dtype=np.float64)
        sigma = float(np.std(d))
        return cls(mu_G=float(np.mean(d)), sigma_G=max(sigma, _EPS),
                   base_rate=base_rate, device=device)

    def _t(self, x) -> torch.Tensor:
        return _on(x, self._device)

    # -- weight construction -------------------------------------------------

    def _detect_gap(self, distances, threshold_ratio: float = 0.15):
        """Index in sorted order of the first distance after the gap, or
        None when there is none."""
        d = self._t(distances)
        if d.shape[0] < 3:
            return None
        idx, found = dens.detect_gap_index(d, threshold_ratio)
        return int(idx) if bool(found) else None

    def _gap_weights_t(self, d: torch.Tensor):
        gap_idx = self._detect_gap(d)
        if gap_idx is None:
            return None
        threshold = torch.sort(d).values[gap_idx]
        return (d < threshold).to(_F64)

    def _gap_weights(self, distances):
        """Binary weights below the detected gap, or None without one."""
        w = self._gap_weights_t(self._t(distances))
        return None if w is None else w.cpu().numpy()

    @_pointwise
    def _sharpen_weights(weights, temperature: float = 0.05, device=None):
        return dens.sharpen_weights(_on(weights, resolve_device(device)),
                                    temperature).cpu().numpy()

    @_pointwise
    def _distance_density_weights(distances, device=None):
        return dens.distance_density_weights(
            _on(distances, resolve_device(device))).cpu().numpy()

    @staticmethod
    def _signal_mass(weights) -> float:
        if weights is None:
            return 0.0
        w = np.asarray(weights, dtype=np.float64)
        if w.size == 0:
            return 0.0
        return float(np.sum(np.maximum(w, 0.0)))

    # -- density estimators --------------------------------------------------

    def _kde(self, d, w, bandwidth_factor, e) -> torch.Tensor:
        h = dens.silverman_bandwidth(d, w) * bandwidth_factor
        return dens.kernel_density(e, d, w, h)

    def _gmm(self, d, w, e, max_iter: int = 100, tol: float = 1e-6
             ) -> torch.Tensor:
        n = d.shape[0]
        if w is not None:
            w_sum = torch.sum(w)
            ok = w_sum > _EPS
            mu_w = torch.sum(w * d) / w_sum
            sigma_w = torch.sqrt(torch.sum(w * (d - mu_w) ** 2) / w_sum)
            mu_R = torch.where(ok, mu_w, dens.mean(d))
            sigma_R = torch.where(ok, sigma_w, dens.std(d))
            pi_R = torch.where(ok, torch.clamp(true_div(w_sum, float(n)),
                                               0.1, 0.9),
                               dens.scalar(0.5, d))
        else:
            mu_R = dens.scalar(self.mu_G - 0.5 * self.sigma_G, d)
            sigma_R = dens.scalar(self.sigma_G * 0.5, d)
            pi_R = dens.scalar(0.3, d)
        sigma_R = torch.where(sigma_R < _EPS,
                              dens.scalar(self.sigma_G * 0.5, d), sigma_R)
        mu_R, sigma_R, _ = dens.gmm_fixed_background(
            d, self.mu_G, self.sigma_G, mu_R, sigma_R, pi_R,
            max_iter=max_iter, tol=tol)
        return torch.clamp(dens.gaussian_pdf(e, mu_R, sigma_R), min=_EPS)

    def estimate_kde(self, distances, weights, bandwidth_factor: float = 2.0,
                     *, eval_points=None):
        """Weighted KDE for f_R with a scaled Silverman bandwidth (one
        (n_eval, n_sample) kernel matrix on the device)."""
        d = self._t(distances)
        e = d if eval_points is None else self._t(eval_points)
        return self._kde(d, self._t(weights), bandwidth_factor,
                         e).cpu().numpy()

    def estimate_gmm(self, distances, weights=None, *, max_iter: int = 100,
                     tol: float = 1e-6, eval_points=None):
        """Fixed-background GMM-EM for f_R; weights inform the
        initialization."""
        d = self._t(distances)
        e = d if eval_points is None else self._t(eval_points)
        w = None if weights is None else self._t(weights)
        return self._gmm(d, w, e, max_iter, tol).cpu().numpy()

    # -- routing -------------------------------------------------------------

    def _relevant_density(self, e: torch.Tensor, s: torch.Tensor, *,
                          weights=None, method: str = "auto",
                          bandwidth_factor: float = 2.0,
                          density_prior=None) -> torch.Tensor:
        """f_R at ``e`` from the sample ``s``, routed as the JAX package
        routes it; a tensor on the device."""
        if s.shape[0] == 0:
            return torch.full_like(e, _EPS)
        K = s.shape[0]
        has_weights = weights is not None and self._signal_mass(weights) > _EPS
        has_prior = (density_prior is not None
                     and self._signal_mass(density_prior) > _EPS)

        if method == "auto":
            gap_w = self._gap_weights_t(s)
            if gap_w is not None:
                if K >= 50:
                    return self._kde(s, gap_w, bandwidth_factor, e)
                return self._gmm(s, gap_w, e)
            if has_weights:
                w = dens.sharpen_weights(self._t(weights))
                return self._kde(s, w, bandwidth_factor, e)
            if has_prior:
                return self._gmm(s, self._t(density_prior), e)
            return self._gmm(s, dens.distance_density_weights(s), e)

        if method == "kde":
            if has_weights:
                eff = self._t(weights)
            elif has_prior:
                eff = self._t(density_prior)
            else:
                eff = self._gap_weights_t(s)
                if eff is None:
                    eff = dens.distance_density_weights(s)
            return self._kde(s, eff, bandwidth_factor, e)

        if method == "gmm":
            if has_weights:
                eff = self._t(weights)
            elif has_prior:
                eff = self._t(density_prior)
            else:
                eff = None
            return self._gmm(s, eff, e)

        raise ValueError(
            f"method must be 'auto', 'kde', or 'gmm', got {method!r}")

    def _estimate_relevant_density(self, eval_points, sample_distances, *,
                                   weights=None, method: str = "auto",
                                   bandwidth_factor: float = 2.0,
                                   density_prior=None):
        """f_R at the eval points from the sample (numpy out)."""
        return self._relevant_density(
            self._t(eval_points), self._t(sample_distances), weights=weights,
            method=method, bandwidth_factor=bandwidth_factor,
            density_prior=density_prior).cpu().numpy()

    # -- calibration ---------------------------------------------------------

    def _log_ratio(self, d: torch.Tensor, f_R: torch.Tensor) -> torch.Tensor:
        f_R = torch.clamp(f_R, min=_EPS)
        f_G = torch.clamp(dens.gaussian_pdf(d, self.mu_G, self.sigma_G),
                          min=_EPS)
        return torch.log(f_R / f_G)

    def log_density_ratio(self, distances, f_R_values):
        """log(f_R(d) / f_G(d)) with epsilon floors (Definition 3.2.1)."""
        return _ret(self._log_ratio(self._t(distances),
                                    self._t(f_R_values)))

    def _posterior(self, e: torch.Tensor, f_R: torch.Tensor, scalar: bool):
        out = clamp_probability(sigmoid(
            self._log_ratio(e, f_R) + self._logit_base_rate, _F64), _F64)
        out = out.cpu().numpy()
        return float(out[0]) if scalar else out

    def calibrate(self, distances, *, weights=None, method: str = "auto",
                  bandwidth_factor: float = 2.0, density_prior=None):
        """P(R|d) = sigma(log density ratio + logit base rate), with the
        eval points doubling as the estimation sample."""
        scalar = np.ndim(distances) == 0
        d = torch.atleast_1d(self._t(distances))
        f_R = self._relevant_density(
            d, d, weights=weights, method=method,
            bandwidth_factor=bandwidth_factor, density_prior=density_prior)
        return self._posterior(d, f_R, scalar)

    def calibrate_with_sample(self, eval_distances, sample_distances, *,
                              weights=None, method: str = "auto",
                              bandwidth_factor: float = 2.0,
                              density_prior=None):
        """Index-aware path: f_R from an ANN-local sample, evaluated on an
        arbitrary eval set."""
        scalar = np.ndim(eval_distances) == 0
        e = torch.atleast_1d(self._t(eval_distances))
        f_R = self._relevant_density(
            e, self._t(sample_distances), weights=weights, method=method,
            bandwidth_factor=bandwidth_factor, density_prior=density_prior)
        return self._posterior(e, f_R, scalar)


def ivf_density_prior(cell_population, avg_population, *, gamma: float = 1.0,
                      device=None):
    """sigma(gamma * (avg_pop / cell_pop - 1)): sparse IVF cells get a
    higher prior weight, the IDF analogue."""
    pop = _on(cell_population, resolve_device(device))
    safe = torch.clamp(pop, min=_EPS)
    ratio = dens.scalar(float(avg_population), safe) / safe
    return _ret(sigmoid(gamma * (ratio - 1.0), _F64))


def knn_density_prior(kth_distance, global_median_kth, *, gamma: float = 1.0,
                      device=None):
    """sigma(gamma * (kth_dist / global_median - 1)): sparse neighbourhoods
    get a higher prior weight."""
    d = _on(kth_distance, resolve_device(device))
    ratio = true_div(d, max(float(global_median_kth), _EPS))
    return _ret(sigmoid(gamma * (ratio - 1.0), _F64))
