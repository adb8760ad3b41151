"""BayesianProbabilityTransform and TemporalBayesianTransform: stateful
wrappers over ``ops.transform``.

Counterpart of ``bayesian_bm25_tpu/models/probability.py``: the
constructor and its state, the pipeline's pieces (``likelihood``, the
priors, ``posterior``, ``score_to_probability``, ``wand_upper_bound``),
and learning: ``fit`` (batch gradient descent in three modes, with
optional sample weights) and ``update`` (online SGD with Polyak
averages). A transform holds a ``device``, the card unless the caller
names another (``ops/mathx.resolve_device``); every method computes
there, the pipeline's pieces in float64, ``fit`` and ``update`` in a
``dtype`` the caller may name (float64 by default), and returns numpy
arrays or Python floats. The priors and ``posterior`` are static in the
JAX package: called on the class, they compute on the card. State is
a handful of Python floats and the device, so the objects pickle and
copy as they are.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import mathx
from bayesian_bm25_tpu_torch.ops import transform as T

_VALID_MODES = ("balanced", "prior_aware", "prior_free")


def _ret(x: torch.Tensor, *inputs):
    arr = x.cpu().numpy()
    if arr.ndim == 0 and all(np.ndim(i) == 0 for i in inputs):
        return float(arr)
    return arr


_F64 = torch.float64


def _on(x, device, dtype=_F64) -> torch.Tensor:
    return mathx.as_float(x, dtype, device)


def sigmoid(x, device=None):
    """Numerically stable sigmoid in float64 on ``device`` (the card by
    default); a float for a scalar, else an array."""
    return _ret(mathx.sigmoid(_on(x, mathx.resolve_device(device)), _F64), x)


def logit(p, device=None):
    """Logit after the epsilon clamp, in float64 on ``device`` (the card
    by default); a float for a scalar, else an array."""
    return _ret(mathx.logit(_on(p, mathx.resolve_device(device)), _F64), p)


class _pointwise:
    """A method that is static in the JAX package: called on an instance
    it computes on the instance's device, called on the class on the
    card (``device`` may name another)."""

    def __init__(self, fn):
        self._fn = fn
        functools.update_wrapper(self, fn)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self._fn
        return functools.partial(self._fn, device=obj.device)


class BayesianProbabilityTransform:
    """Transforms raw BM25 scores into calibrated probabilities.

    ``alpha`` is the sigmoid steepness, ``beta`` the midpoint,
    ``base_rate`` an optional corpus-level relevance rate in (0, 1)
    applied through a second Bayes update, ``prior_fn`` an optional
    callable replacing the composite prior.
    """

    _VALID_MODES = _VALID_MODES

    def __init__(self, alpha=1.0, beta=0.0, base_rate=None, prior_fn=None,
                 device=None):
        if base_rate is not None and not (0.0 < base_rate < 1.0):
            raise ValueError(f"base_rate must be in (0, 1), got {base_rate}")
        self._device = mathx.resolve_device(device)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.base_rate = base_rate
        self._prior_fn = prior_fn
        self._training_mode = "balanced"
        self._n_updates = 0
        self._grad_alpha_ema = 0.0
        self._grad_beta_ema = 0.0
        self._alpha_avg = float(alpha)
        self._beta_avg = float(beta)

    # -- inference ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def averaged_alpha(self) -> float:
        """Polyak-averaged alpha for stable inference after online updates."""
        return self._alpha_avg

    @property
    def averaged_beta(self) -> float:
        """Polyak-averaged beta for stable inference after online updates."""
        return self._beta_avg

    def likelihood(self, score):
        """sigma(alpha * (score - beta))."""
        return _ret(T.likelihood(_on(score, self._device), self.alpha,
                                 self.beta, _F64), score)

    @_pointwise
    def tf_prior(tf, device=None):
        """0.2 + 0.7 * min(1, tf / 10)."""
        return _ret(T.tf_prior(_on(tf, mathx.resolve_device(device)), _F64),
                    tf)

    @_pointwise
    def norm_prior(doc_len_ratio, device=None):
        """0.3 + 0.6 * (1 - min(1, |r - 0.5| * 2))."""
        return _ret(T.norm_prior(_on(doc_len_ratio,
                                     mathx.resolve_device(device)), _F64),
                    doc_len_ratio)

    @_pointwise
    def composite_prior(tf, doc_len_ratio, device=None):
        """clip(0.7 * P_tf + 0.3 * P_norm, 0.1, 0.9)."""
        dev = mathx.resolve_device(device)
        return _ret(T.composite_prior(_on(tf, dev), _on(doc_len_ratio, dev),
                                      _F64), tf, doc_len_ratio)

    @_pointwise
    def posterior(likelihood_val, prior, base_rate=None, device=None):
        """Two-step Bayes odds update."""
        return _ret(T.posterior(_on(likelihood_val,
                                    mathx.resolve_device(device)),
                                prior, base_rate, _F64),
                    likelihood_val, prior)

    def score_to_probability(self, score, tf, doc_len_ratio,
                             dtype: torch.dtype = torch.float64):
        """Full pipeline: score -> likelihood -> prior -> posterior,
        computed on the transform's device in ``dtype``."""
        prior_free = self._training_mode == "prior_free"
        dev = self._device
        s = _on(score, dev, dtype)
        if not prior_free and self._prior_fn is not None:
            prior = T.clamp_probability(_on(
                np.asarray(self._prior_fn(score, tf, doc_len_ratio)), dev,
                dtype), dtype)
            out = T.posterior(T.likelihood(s, self.alpha, self.beta, dtype),
                              prior, self.base_rate, dtype)
        else:
            out = T.score_to_probability(
                s, _on(tf, dev, dtype), _on(doc_len_ratio, dev, dtype),
                self.alpha, self.beta, self.base_rate,
                prior_free=prior_free, dtype=dtype)
        return _ret(out, score, tf, doc_len_ratio)

    def wand_upper_bound(self, bm25_upper_bound, p_max: float = 0.9):
        """Safe Bayesian probability upper bound for WAND pruning."""
        return _ret(T.wand_upper_bound(_on(bm25_upper_bound, self._device),
                                       self.alpha, self.beta, self.base_rate,
                                       p_max, _F64), bm25_upper_bound)

    # -- learning ----------------------------------------------------------

    def _validate_mode(self, mode, tfs, doc_len_ratios):
        if mode not in self._VALID_MODES:
            raise ValueError(
                f"mode must be one of {self._VALID_MODES}, got {mode!r}"
            )
        if mode == "prior_aware" and (tfs is None or doc_len_ratios is None):
            raise ValueError(
                "tfs and doc_len_ratios are required when mode='prior_aware'"
            )

    def fit(self, scores, labels, *, learning_rate: float = 0.01,
            max_iterations: int = 1000, tolerance: float = 1e-6,
            mode: str = "balanced", tfs=None, doc_len_ratios=None,
            sample_weights=None, dtype: torch.dtype = torch.float64) -> None:
        """Batch gradient descent on the BCE (``ops/transform.fit_transform``).

        Modes: "balanced" trains the likelihood, "prior_aware" the full
        posterior through the composite prior of ``tfs`` and
        ``doc_len_ratios``, "prior_free" the likelihood, and inference
        then uses prior 0.5. ``sample_weights`` weight each sample's
        gradient (the temporal transform's decay). Resets the online
        state; the number of steps taken is kept in ``_fit_iterations``."""
        self._validate_mode(mode, tfs, doc_len_ratios)
        dev = self._device
        priors = None
        if mode == "prior_aware":
            priors = T.composite_prior(_on(tfs, dev, dtype),
                                       _on(doc_len_ratios, dev, dtype), dtype)
        alpha, beta, self._fit_iterations = T.fit_transform(
            self.alpha, self.beta,
            _on(np.asarray(scores, dtype=np.float64), dev, dtype),
            np.asarray(labels, dtype=np.float64),
            prior_aware=mode == "prior_aware", priors=priors,
            sample_weights=sample_weights, learning_rate=learning_rate,
            max_iterations=max_iterations, tolerance=tolerance, dtype=dtype)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._training_mode = mode
        self._n_updates = 0
        self._grad_alpha_ema = 0.0
        self._grad_beta_ema = 0.0
        self._alpha_avg = self.alpha
        self._beta_avg = self.beta

    def update(self, score, label, *, learning_rate: float = 0.01,
               momentum: float = 0.9, decay_tau: float = 1000.0,
               max_grad_norm: float = 1.0, avg_decay: float = 0.995,
               mode: str | None = None, tf=None, doc_len_ratio=None,
               dtype: torch.dtype = torch.float64) -> None:
        """Online SGD update on one observation or a mini-batch: EMA of
        the gradient with bias correction, L2 clip, decayed learning
        rate, alpha floor and Polyak averages
        (``ops/transform.online_update_step``). ``mode`` switches the
        training mode for this and later updates."""
        effective_mode = mode if mode is not None else self._training_mode
        self._validate_mode(effective_mode, tf, doc_len_ratio)
        if mode is not None:
            self._training_mode = effective_mode
        dev = self._device
        priors = None
        if effective_mode == "prior_aware":
            priors = torch.atleast_1d(T.composite_prior(
                _on(tf, dev, dtype), _on(doc_len_ratio, dev, dtype), dtype))
        state = T.OnlineTransformState(*(
            torch.tensor(v, dtype=dtype, device=dev) for v in (
                self.alpha, self.beta, self._grad_alpha_ema,
                self._grad_beta_ema, self._alpha_avg, self._beta_avg)),
            n_updates=self._n_updates)
        new = T.online_update_step(
            state,
            np.atleast_1d(np.asarray(score, dtype=np.float64)),
            np.atleast_1d(np.asarray(label, dtype=np.float64)),
            prior_aware=effective_mode == "prior_aware", priors=priors,
            learning_rate=learning_rate, momentum=momentum,
            decay_tau=decay_tau, max_grad_norm=max_grad_norm,
            avg_decay=avg_decay, dtype=dtype)
        self.alpha = float(new.alpha)
        self.beta = float(new.beta)
        self._grad_alpha_ema = float(new.grad_alpha_ema)
        self._grad_beta_ema = float(new.grad_beta_ema)
        self._alpha_avg = float(new.alpha_avg)
        self._beta_avg = float(new.beta_avg)
        self._n_updates = int(new.n_updates)


class TemporalBayesianTransform(BayesianProbabilityTransform):
    """Transform whose batch fit weights samples by an exponential time
    decay with half-life ``decay_half_life``, and whose online updates
    shrink the Polyak decay early on."""

    def __init__(self, alpha=1.0, beta=0.0, base_rate=None,
                 decay_half_life: float = 1000.0, device=None):
        if decay_half_life <= 0.0:
            raise ValueError(
                f"decay_half_life must be positive, got {decay_half_life}"
            )
        super().__init__(alpha=alpha, beta=beta, base_rate=base_rate,
                         device=device)
        self._decay_half_life = float(decay_half_life)
        self._decay_rate = float(np.log(2.0) / decay_half_life)
        self._timestamp = 0

    @property
    def decay_half_life(self) -> float:
        return self._decay_half_life

    @property
    def timestamp(self) -> int:
        return self._timestamp

    def fit(self, scores, labels, *, timestamps=None, **kwargs) -> None:
        """Batch fit with per-sample weights
        exp(-ln2 / half_life * (max_ts - ts)), normalized to sum to n."""
        sample_weights = None
        if timestamps is not None:
            ts = np.asarray(timestamps, dtype=np.float64)
            w = np.exp(-self._decay_rate * (float(np.max(ts)) - ts))
            sample_weights = w * (len(ts) / float(np.sum(w)))
        super().fit(scores, labels, sample_weights=sample_weights, **kwargs)

    def update(self, score, label, *, avg_decay: float = 0.995,
               **kwargs) -> None:
        """Online update with the Polyak decay shrunk to
        avg_decay * (1 - 1 / (1 + t)) at timestamp t."""
        self._timestamp += 1
        effective = avg_decay * (1.0 - 1.0 / (1.0 + self._timestamp))
        super().update(score, label, avg_decay=effective, **kwargs)
