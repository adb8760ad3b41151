"""Calibration metrics: ECE, Brier score, log loss, reliability diagram.

Counterpart of ``bayesian_bm25_tpu/utils/metrics.py``. Each function
takes numpy arrays (or tensors) and computes in float64 on ``device``,
the card unless the caller names another (``ops/mathx.resolve_device``;
a tensor already there is not copied). The bins are one ``index_add_``
pass, with the JAX package's bin rule: the first bin closed [0, hi],
the rest (lo, hi]. On CUDA ``index_add_`` adds with atomics, so a
bin's float64 sum may differ between runs and from the CPU in its last
bits; hold it to a tolerance, not to bit equality.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops.mathx import as_float, resolve_device
from bayesian_bm25_tpu_torch.ops.transform import true_div

_F64 = torch.float64


def _t(x, device) -> torch.Tensor:
    return as_float(x, _F64, resolve_device(device))


def _bin_index(p: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin ids: ceil(p * n_bins) - 1 puts p in (lo, hi] in its bin, p == 0
    in bin 0 (the closed first bin); values outside [0, 1] are clipped."""
    idx = torch.ceil(p * n_bins).to(torch.int32) - 1
    return torch.clamp(idx, 0, n_bins - 1)


def _binned_sums(p: torch.Tensor, y: torch.Tensor, n_bins: int):
    """(count, sum of p, sum of y) per bin, stacked as (3, n_bins)."""
    idx = _bin_index(p, n_bins)
    out = torch.zeros((3, n_bins), dtype=p.dtype, device=p.device)
    for row, src in zip(out, (torch.ones_like(p), p, y)):
        row.index_add_(0, idx, src)
    return out


def _ece(p: torch.Tensor, y: torch.Tensor, n_bins: int) -> torch.Tensor:
    count, p_sum, y_sum = _binned_sums(p, y, n_bins)
    safe = torch.clamp(count, min=1.0)
    gap = torch.abs(p_sum / safe - y_sum / safe)
    return torch.sum(torch.where(count > 0,
                                 true_div(count, float(p.shape[0])) * gap,
                                 torch.zeros_like(gap)))


def _mean(x: torch.Tensor) -> torch.Tensor:
    return true_div(torch.sum(x), float(x.numel()))


def _brier(p, y) -> torch.Tensor:
    return _mean((p - y) ** 2)


def _log_loss(p, y, eps: float) -> torch.Tensor:
    p = torch.clamp(p, eps, 1.0 - eps)
    return -_mean(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def _reliability(p, y, n_bins: int) -> list:
    count, p_sum, y_sum = _binned_sums(p, y, n_bins).cpu().numpy()
    return [(float(ps / c), float(ys / c), int(c))
            for c, ps, ys in zip(count, p_sum, y_sum) if c > 0]


def expected_calibration_error(probabilities, labels, n_bins: int = 10,
                               device=None) -> float:
    """Expected Calibration Error; lower is better, 0 is perfect."""
    return float(_ece(_t(probabilities, device), _t(labels, device), n_bins))


def brier_score(probabilities, labels, device=None) -> float:
    """Mean squared error between probabilities and labels."""
    return float(_brier(_t(probabilities, device), _t(labels, device)))


def log_loss(probabilities, labels, *, eps: float = 1e-15,
             device=None) -> float:
    """Negative log-likelihood with probabilities clipped to
    [eps, 1 - eps], in float64 (at float32 the 1e-15 clip would round
    away)."""
    return float(_log_loss(_t(probabilities, device), _t(labels, device),
                           eps))


def reliability_diagram(probabilities, labels, n_bins: int = 10,
                        device=None):
    """(avg_predicted, avg_actual, count) per non-empty bin."""
    return _reliability(_t(probabilities, device), _t(labels, device),
                        n_bins)


@dataclass
class CalibrationReport:
    """Bundled calibration diagnostics with a text ``summary()``."""

    ece: float
    brier: float
    logloss: float
    reliability: list
    n_samples: int
    n_bins: int

    def summary(self) -> str:
        lines = [
            "Calibration Report",
            "==================",
            f"  Samples : {self.n_samples}",
            f"  Bins    : {self.n_bins}",
            f"  ECE     : {self.ece:.6f}",
            f"  Brier   : {self.brier:.6f}",
            f"  LogLoss : {self.logloss:.6f}",
            "",
            "  Reliability Diagram",
            "  -------------------",
            f"  {'Predicted':>10}  {'Actual':>10}  {'Count':>6}",
        ]
        for avg_pred, avg_actual, count in self.reliability:
            lines.append(
                f"  {avg_pred:>10.4f}  {avg_actual:>10.4f}  {count:>6}")
        return "\n".join(lines)


def calibration_report(probabilities, labels, n_bins: int = 10,
                       device=None) -> CalibrationReport:
    """ECE, Brier score, log loss and the reliability diagram in one
    call, from one copy of the inputs to ``device``."""
    p, y = _t(probabilities, device), _t(labels, device)
    return CalibrationReport(
        ece=float(_ece(p, y, n_bins)), brier=float(_brier(p, y)),
        logloss=float(_log_loss(p, y, 1e-15)),
        reliability=_reliability(p, y, n_bins),
        n_samples=int(np.shape(probabilities)[0]), n_bins=n_bins)
