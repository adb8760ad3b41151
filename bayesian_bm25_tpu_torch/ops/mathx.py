"""Math primitives: probability clamps, stable sigmoid and logit.

Counterpart of ``bayesian_bm25_tpu/ops/mathx.py``. The JAX module picks
its float type from the global x64 flag; here every function takes an
explicit ``dtype`` (float32 on the card, float64 for host-side parity),
so a caller always states the precision it computes in. The clamp
epsilon follows the dtype: 1e-10 is below float32 resolution next to
1.0 (1 - 1e-10 rounds to 1.0), so float32 uses 1e-6.
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON_F64 = 1e-10
EPSILON_F32 = 1e-6
ALPHA_MIN = 0.01


def as_float(x, dtype: torch.dtype = torch.float32,
             device=None) -> torch.Tensor:
    """``x`` (tensor, array or scalar) as a ``dtype`` tensor. A numpy
    array that torch cannot wrap (read-only, or with negative strides)
    is copied first."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device or x.device)
    if isinstance(x, np.ndarray):
        x = np.require(x, requirements=["C", "W"])
    return torch.as_tensor(x, dtype=dtype, device=device)


def epsilon(dtype: torch.dtype) -> float:
    """Probability-clamp epsilon for a dtype."""
    return EPSILON_F64 if dtype == torch.float64 else EPSILON_F32


def clamp_probability(p, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Clamp a probability to [eps, 1 - eps]."""
    p = as_float(p, dtype)
    eps = epsilon(dtype)
    return torch.clamp(p, eps, 1.0 - eps)


def sigmoid(x, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Numerically stable sigmoid."""
    return torch.sigmoid(as_float(x, dtype))


def logit(p, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse sigmoid log(p / (1 - p)) after the epsilon clamp."""
    p = clamp_probability(p, dtype)
    return torch.log(p) - torch.log1p(-p)
