"""Score calibration: Platt scaling and isotonic (PAVA) regression.

Counterpart of ``bayesian_bm25_tpu/models/calibration.py``. Each
calibrator holds a ``device``, the card unless the caller names another
(``ops/mathx.resolve_device``). Platt's fit is the batch gradient
descent of ``ops/gd.fit_loop`` there; the isotonic fit is the
pool-adjacent-violators pass on the host (sequential by nature, one
O(n) stack pass after a sort), and isotonic inference is one
``torch.searchsorted`` with interpolation on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import gd
from bayesian_bm25_tpu_torch.ops.mathx import (as_float, clamp_probability,
                                               resolve_device, sigmoid)
from bayesian_bm25_tpu_torch.ops.transform import true_div

_F64 = torch.float64


def _platt_grads(params, scores, labels):
    a, b = params
    err = clamp_probability(sigmoid(a * scores + b, _F64), _F64) - labels
    n = float(scores.shape[0])
    return (true_div(torch.sum(err * scores), n), true_div(torch.sum(err), n))


class PlattCalibrator:
    """Sigmoid calibration P = sigma(a * score + b), fitted by gradient
    descent on the BCE."""

    def __init__(self, a: float = 1.0, b: float = 0.0, device=None) -> None:
        self.a = float(a)
        self.b = float(b)
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def _t(self, x) -> torch.Tensor:
        return as_float(np.asarray(x, dtype=np.float64), _F64, self._device)

    def fit(self, scores, labels, *, learning_rate=0.01, max_iterations=1000,
            tolerance=1e-6) -> None:
        s, y = self._t(scores), self._t(labels)
        params0 = (torch.tensor(self.a, dtype=_F64, device=self._device),
                   torch.tensor(self.b, dtype=_F64, device=self._device))
        (a, b), self._fit_iterations = gd.fit_loop(
            lambda params: _platt_grads(params, s, y), params0,
            learning_rate=learning_rate, max_iterations=max_iterations,
            tolerance=tolerance, convergence="param_change")
        self.a = float(a)
        self.b = float(b)

    def calibrate(self, scores):
        out = sigmoid(self.a * self._t(scores) + self.b, _F64).cpu().numpy()
        return float(out) if out.ndim == 0 else out

    def __call__(self, scores):
        return self.calibrate(scores)


def _isotonic_eval(x: torch.Tensor, y: torch.Tensor,
                   scores: torch.Tensor) -> torch.Tensor:
    """Breakpoint interpolation: clamped to the end values, linear
    between breakpoints, the midpoint of tied breakpoints."""
    idx = torch.searchsorted(x, scores)
    idx_hi = torch.clamp(idx, 1, x.shape[0] - 1)
    x0, x1 = x[idx_hi - 1], x[idx_hi]
    y0, y1 = y[idx_hi - 1], y[idx_hi]
    span = x1 - x0
    tied = span < 1e-12
    t = (scores - x0) / torch.where(tied, torch.ones_like(span), span)
    interp = torch.where(tied, true_div(y0 + y1, 2.0), y0 + t * (y1 - y0))
    out = torch.where(idx == 0, y[0], interp)
    out = torch.where(idx >= x.shape[0], y[-1], out)
    return clamp_probability(out, _F64)


class IsotonicCalibrator:
    """Non-parametric monotone calibration by pool-adjacent-violators."""

    def __init__(self, device=None) -> None:
        self._device = resolve_device(device)
        self._x: torch.Tensor | None = None
        self._y: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self._device

    def fit(self, scores, labels) -> None:
        scores = np.asarray(scores, dtype=np.float64)
        labels = np.asarray(labels, dtype=np.float64)
        order = np.argsort(scores)
        xs = scores[order]
        ys = labels[order]

        # Stack of blocks (y_sum, count, x_sum); merge while the tail
        # breaks non-decreasing block means.
        blocks: list[list[float]] = []
        for xv, yv in zip(xs, ys):
            blocks.append([yv, 1.0, xv])
            while len(blocks) > 1 and (
                blocks[-2][0] / blocks[-2][1] > blocks[-1][0] / blocks[-1][1]
            ):
                y1, c1, x1 = blocks.pop()
                blocks[-1][0] += y1
                blocks[-1][1] += c1
                blocks[-1][2] += x1

        self._x = torch.tensor([b[2] / b[1] for b in blocks], dtype=_F64,
                               device=self._device)
        self._y = torch.tensor([b[0] / b[1] for b in blocks], dtype=_F64,
                               device=self._device)

    def calibrate(self, scores):
        if self._x is None or self._y is None:
            raise RuntimeError("Call fit() before calibrate().")
        scalar = np.ndim(scores) == 0
        if self._x.shape[0] == 1:
            const = float(np.clip(float(self._y[0]), 1e-10, 1 - 1e-10))
            if scalar:
                return const
            return np.full(np.shape(np.asarray(scores)), const)
        s = as_float(np.atleast_1d(np.asarray(scores, dtype=np.float64)),
                     _F64, self._device)
        out = _isotonic_eval(self._x, self._y, s).cpu().numpy()
        return float(out[0]) if scalar else out

    def __call__(self, scores):
        return self.calibrate(scores)
