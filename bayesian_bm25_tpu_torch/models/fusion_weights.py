"""Learnable, attention and multi-head log-odds fusion weight models.

Counterpart of ``bayesian_bm25_tpu/models/fusion_weights.py``: stateful
wrappers over ``ops/fusion_learn.py``. Each model holds a ``device``,
the card unless the caller names another (``ops/mathx.resolve_device``),
and keeps its parameters, gradient EMAs and Polyak averages there as
float64 tensors under the JAX package's attribute names, so fits,
updates and forwards run without a host round trip and
``utils/convert.py`` reads either package's state. Inputs are numpy
arrays or scalars; outputs numpy arrays, or Python floats where the JAX
package returns them.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import fusion_learn as FL
from bayesian_bm25_tpu_torch.ops import gd
from bayesian_bm25_tpu_torch.ops.fusion import resolve_alpha
from bayesian_bm25_tpu_torch.ops.mathx import (as_float, logit,
                                               resolve_device, sigmoid,
                                               stable_softmax)

_F64 = torch.float64


def _check_base_rate(base_rate):
    if base_rate is not None and not (0.0 < base_rate < 1.0):
        raise ValueError(f"base_rate must be in (0, 1), got {base_rate}")


def _logit_base_rate(base_rate, device):
    if base_rate is None:
        return None
    return float(logit(torch.tensor(float(base_rate), dtype=_F64,
                                    device=device), _F64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class LearnableLogOddsWeights:
    """Learnable per-signal reliability weights for the log-odds
    conjunction: softmax weights of internal logits (zeros at the start,
    the uniform 1/n Naive-Bayes weights); the forward is
    sigma(n^alpha * sum(w * logit p) [+ logit base_rate])."""

    def __init__(self, n_signals: int, alpha=0.0, base_rate=None,
                 device=None):
        if n_signals < 1:
            raise ValueError(f"n_signals must be >= 1, got {n_signals}")
        _check_base_rate(base_rate)
        self._device = resolve_device(device)
        self._logit_base_rate = _logit_base_rate(base_rate, self._device)
        self._n_signals = int(n_signals)
        self._alpha = resolve_alpha(alpha, default=0.0)
        self._base_rate = base_rate
        dev = self._device
        self._logits = torch.zeros(n_signals, dtype=_F64, device=dev)
        self._n_updates = 0
        self._grad_logits_ema = torch.zeros(n_signals, dtype=_F64, device=dev)
        self._weights_avg = torch.full((n_signals,), 1.0 / n_signals,
                                       dtype=_F64, device=dev)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_signals(self) -> int:
        return self._n_signals

    @property
    def alpha(self) -> float:
        return self._alpha

    @property
    def base_rate(self):
        return self._base_rate

    @property
    def weights(self) -> np.ndarray:
        """Current weights: softmax of the internal logits."""
        return _np(stable_softmax(self._logits))

    @property
    def averaged_weights(self) -> np.ndarray:
        """Polyak-averaged weights (in the simplex) for stable inference."""
        return _np(self._weights_avg).copy()

    def _scale(self) -> float:
        return self._n_signals ** self._alpha

    def _probs(self, probs, at_least_2d: bool = False) -> torch.Tensor:
        p = as_float(np.asarray(probs, dtype=np.float64), _F64, self._device)
        if at_least_2d:
            p = torch.atleast_2d(p)
        if p.shape[-1] != self._n_signals:
            raise ValueError(f"probs last dimension {p.shape[-1]} != "
                             f"n_signals {self._n_signals}")
        return p

    def _labels(self, labels) -> torch.Tensor:
        return as_float(np.asarray(labels, dtype=np.float64), _F64,
                        self._device)

    def __call__(self, probs, use_averaged: bool = False):
        p = self._probs(probs)
        if use_averaged:
            # The averaged weights live in the simplex, not logit space:
            # the forward formula applied to them directly.
            x = logit(p, _F64)
            l_w = self._scale() * torch.sum(self._weights_avg * x, dim=-1)
            if self._logit_base_rate is not None:
                l_w = l_w + self._logit_base_rate
            out = _np(sigmoid(l_w, _F64))
        else:
            out = _np(FL.learnable_forward(self._logits, p, self._scale(),
                                           self._logit_base_rate))
        return float(out) if out.ndim == 0 else out

    def fit(self, probs, labels, *, learning_rate=0.01, max_iterations=1000,
            tolerance=1e-6) -> None:
        """Batch gradient descent with the Hebbian gradient; resets the
        online state."""
        z, self._fit_iterations = FL.learnable_fit(
            self._logits, self._probs(probs, True), self._labels(labels),
            self._scale(), self._logit_base_rate,
            learning_rate=learning_rate, max_iterations=max_iterations,
            tolerance=tolerance)
        self._logits = z
        self._n_updates = 0
        self._grad_logits_ema = torch.zeros_like(z)
        self._weights_avg = stable_softmax(z)

    def update(self, probs, label, *, learning_rate=0.01, momentum=0.9,
               decay_tau=1000.0, max_grad_norm=1.0,
               avg_decay=0.995) -> None:
        """Online SGD (EMA, bias correction, clip, decay) with Polyak
        averages of the weights in the simplex."""
        state = gd.OnlineState((self._logits,), (self._grad_logits_ema,),
                               (self._weights_avg,), self._n_updates)
        new = FL.learnable_online_step(
            state, self._probs(probs, True), self._labels(label),
            self._scale(), self._logit_base_rate,
            learning_rate=learning_rate, momentum=momentum,
            decay_tau=decay_tau, max_grad_norm=max_grad_norm,
            avg_decay=avg_decay)
        (self._logits,), (self._grad_logits_ema,), (self._weights_avg,) = (
            new.params, new.grad_ema, new.params_avg)
        self._n_updates = new.n_updates


class AttentionLogOddsWeights:
    """Query-dependent signal weights by linear-softmax attention:
    w(q) = softmax(W @ query_features + b), fused by the weighted
    log-odds conjunction; per-signal logit min-max normalization
    (optionally within query groups) and pruning by fused upper
    bounds."""

    def __init__(self, n_signals: int, n_query_features: int, alpha=0.5,
                 normalize: bool = False, seed: int = 0, base_rate=None,
                 device=None):
        if n_signals < 1:
            raise ValueError(f"n_signals must be >= 1, got {n_signals}")
        if n_query_features < 1:
            raise ValueError(
                f"n_query_features must be >= 1, got {n_query_features}"
            )
        _check_base_rate(base_rate)
        self._device = resolve_device(device)
        self._logit_base_rate = _logit_base_rate(base_rate, self._device)
        self._n_signals = int(n_signals)
        self._n_query_features = int(n_query_features)
        self._alpha = resolve_alpha(alpha, default=0.5)
        self._normalize = bool(normalize)
        self._base_rate = base_rate
        self._W, self._b = FL.attention_init(n_signals, n_query_features,
                                             seed, device=self._device)
        self._reset_online()

    def _reset_online(self) -> None:
        self._n_updates = 0
        self._grad_W_ema = torch.zeros_like(self._W)
        self._grad_b_ema = torch.zeros_like(self._b)
        self._W_avg = self._W.clone()
        self._b_avg = self._b.clone()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_signals(self) -> int:
        return self._n_signals

    @property
    def n_query_features(self) -> int:
        return self._n_query_features

    @property
    def alpha(self) -> float:
        return self._alpha

    @property
    def base_rate(self):
        return self._base_rate

    @property
    def normalize(self) -> bool:
        return self._normalize

    @property
    def weights_matrix(self) -> np.ndarray:
        return _np(self._W).copy()

    def _params(self, use_averaged: bool) -> FL.AttentionParams:
        if use_averaged:
            return FL.AttentionParams(self._W_avg, self._b_avg)
        return FL.AttentionParams(self._W, self._b)

    def _scale(self) -> float:
        return self._n_signals ** self._alpha

    def _t(self, x) -> torch.Tensor:
        return as_float(np.asarray(x, dtype=np.float64), _F64, self._device)

    def _compute_weights(self, query_features, use_averaged: bool = False):
        return _np(FL.attention_weights(self._params(use_averaged),
                                        self._t(query_features)))

    def __call__(self, probs, query_features, use_averaged: bool = False):
        p = self._t(probs)
        scalar = p.ndim == 1
        out = _np(FL.attention_forward(
            self._params(use_averaged), p, self._t(query_features),
            self._scale(), self._logit_base_rate, normalize=self._normalize,
            # A single 1-D sample has no candidate set to normalize across.
            skip_normalize=scalar))
        if scalar:
            return float(out[0]) if out.ndim else float(out)
        return np.atleast_1d(out)

    def fit(self, probs, labels, query_features, *, query_ids=None,
            learning_rate=0.01, max_iterations=1000, tolerance=1e-6) -> None:
        """Batch GD on the BCE through the softmax Jacobian. With
        ``normalize=True`` and ``query_ids``, the logits are min-max
        normalized within each query group (segment reductions)."""
        seg = num_seg = None
        if self._normalize and query_ids is not None:
            _, inv = np.unique(np.asarray(query_ids), return_inverse=True)
            num_seg = int(inv.max()) + 1 if inv.size else 1
            seg = torch.as_tensor(inv.reshape(-1), device=self._device)
        params, self._fit_iterations = FL.attention_fit(
            self._params(False), torch.atleast_2d(self._t(probs)),
            self._t(labels), torch.atleast_2d(self._t(query_features)),
            self._scale(), self._logit_base_rate, normalize=self._normalize,
            segment_ids=seg, num_segments=num_seg,
            learning_rate=learning_rate, max_iterations=max_iterations,
            tolerance=tolerance)
        self._W, self._b = params
        self._reset_online()

    def update(self, probs, label, query_features, *, learning_rate=0.01,
               momentum=0.9, decay_tau=1000.0, max_grad_norm=1.0,
               avg_decay=0.995) -> None:
        """Online SGD update."""
        state = gd.OnlineState((self._W, self._b),
                               (self._grad_W_ema, self._grad_b_ema),
                               (self._W_avg, self._b_avg), self._n_updates)
        new = FL.attention_online_step(
            state, self._t(probs), self._t(label), self._t(query_features),
            self._scale(), self._logit_base_rate, normalize=self._normalize,
            learning_rate=learning_rate, momentum=momentum,
            decay_tau=decay_tau, max_grad_norm=max_grad_norm,
            avg_decay=avg_decay)
        self._W, self._b = new.params
        self._grad_W_ema, self._grad_b_ema = new.grad_ema
        self._W_avg, self._b_avg = new.params_avg
        self._n_updates = new.n_updates

    def compute_upper_bounds(self, upper_bound_probs, query_features,
                             use_averaged: bool = False) -> np.ndarray:
        """Fused probability upper bound per candidate (Theorem 8.7.1)."""
        out = _np(FL.attention_forward(
            self._params(use_averaged),
            torch.atleast_2d(self._t(upper_bound_probs)),
            self._t(query_features), self._scale(), self._logit_base_rate,
            normalize=self._normalize, skip_normalize=False))
        return np.atleast_1d(out)

    def prune(self, probs, query_features, threshold, upper_bound_probs=None,
              use_averaged: bool = False):
        """Drop candidates whose fused upper bound is below ``threshold``:
        (surviving_indices, fused_probs) on the host."""
        return _prune(self, probs, query_features, threshold,
                      upper_bound_probs, use_averaged)


def _prune(model, probs, query_features, threshold, upper_bound_probs,
           use_averaged):
    probs = np.atleast_2d(np.asarray(probs, dtype=np.float64))
    qf = np.atleast_2d(np.asarray(query_features, dtype=np.float64))
    if upper_bound_probs is None:
        upper_bound_probs = probs
    ub = model.compute_upper_bounds(upper_bound_probs, qf, use_averaged)
    surviving = np.where(ub >= threshold)[0]
    if len(surviving) == 0:
        return surviving, np.array([], dtype=np.float64)
    surv_qf = qf[surviving] if qf.shape[0] > 1 else qf
    fused = model(probs[surviving], surv_qf, use_averaged)
    return surviving, np.atleast_1d(np.asarray(fused, dtype=np.float64))


class MultiHeadAttentionLogOddsWeights:
    """Attention heads seeded 0 .. n_heads - 1; inference averages the
    heads' fused log-odds, then applies the sigmoid, in one batched pass
    over the stacked head parameters."""

    def __init__(self, n_heads: int, n_signals: int, n_query_features: int,
                 alpha=0.5, normalize: bool = False, device=None):
        if n_heads < 1:
            raise ValueError(f"n_heads must be >= 1, got {n_heads}")
        self._n_heads = int(n_heads)
        self._heads = [
            AttentionLogOddsWeights(
                n_signals=n_signals, n_query_features=n_query_features,
                alpha=alpha, normalize=normalize, seed=h, device=device,
            )
            for h in range(n_heads)
        ]

    @property
    def device(self) -> torch.device:
        return self._heads[0].device

    @property
    def n_heads(self) -> int:
        return self._n_heads

    @property
    def heads(self) -> list:
        return list(self._heads)

    def _forward(self, probs, query_features, use_averaged, skip_normalize):
        h0 = self._heads[0]
        return _np(FL.multihead_forward(
            FL.stack_heads([h._params(use_averaged) for h in self._heads]),
            probs, h0._t(query_features), h0._scale(), h0._logit_base_rate,
            normalize=h0._normalize, skip_normalize=skip_normalize))

    def __call__(self, probs, query_features, use_averaged: bool = False):
        p = self._heads[0]._t(probs)
        scalar = p.ndim == 1
        out = self._forward(p, query_features, use_averaged, scalar)
        if scalar:
            return float(out[0]) if out.ndim else float(out)
        return np.atleast_1d(out)

    def fit(self, probs, labels, query_features, **kwargs) -> None:
        """Train every head on the same data (diversity from the seeds)."""
        for head in self._heads:
            head.fit(probs, labels, query_features, **kwargs)

    def update(self, probs, label, query_features, **kwargs) -> None:
        for head in self._heads:
            head.update(probs, label, query_features, **kwargs)

    def compute_upper_bounds(self, upper_bound_probs, query_features,
                             use_averaged: bool = False) -> np.ndarray:
        """Average of the heads' upper-bound log-odds, then the sigmoid
        (Corollary 8.7.2)."""
        ub = torch.atleast_2d(self._heads[0]._t(upper_bound_probs))
        return np.atleast_1d(self._forward(ub, query_features, use_averaged,
                                           False))

    def prune(self, probs, query_features, threshold, upper_bound_probs=None,
              use_averaged: bool = False):
        return _prune(self, probs, query_features, threshold,
                      upper_bound_probs, use_averaged)
