"""Math primitives: the device policy, probability clamps, stable
sigmoid and logit, softmax and min-max normalization.

Counterpart of ``bayesian_bm25_tpu/ops/mathx.py``. The JAX module picks
its float type from the global x64 flag; here the clamps, sigmoid and
logit take an explicit ``dtype`` (float32 on the card, float64 for
host-side parity), so a caller always states the precision it computes
in, and ``stable_softmax`` and the normalizations compute in their
input's dtype, on its device. The clamp epsilon follows the dtype:
1e-10 is below float32 resolution next to 1.0 (1 - 1e-10 rounds to
1.0), so float32 uses 1e-6.

``resolve_device`` is the port's one device policy: every numpy-facing
entry point computes on the card unless its caller names another
device, and never falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

EPSILON_F64 = 1e-10
EPSILON_F32 = 1e-6
ALPHA_MIN = 0.01


def resolve_device(device=None) -> torch.device:
    """The device a numpy-facing entry point computes on: the card
    (``"cuda"``) when ``device`` is None. Asking for the card without
    CUDA raises; nothing falls back to the CPU."""
    name = "cuda" if device is None else device
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    return dev


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


def stable_softmax(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shift-by-max softmax along ``dim``."""
    z = z - torch.amax(z, dim=dim, keepdim=True)
    e = torch.exp(z)
    return e / torch.sum(e, dim=dim, keepdim=True)


def _span_normalize(x, lo, hi) -> torch.Tensor:
    """(x - lo) / (hi - lo), with zeros where the span is under 1e-12."""
    span = hi - lo
    flat = span < 1e-12
    out = (x - lo) / torch.where(flat, torch.ones_like(span), span)
    return torch.where(flat, torch.zeros_like(out), out)


def min_max_normalize(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Min-max normalize to [0, 1] (a zero span maps to zeros), over the
    whole tensor or, with ``dim``, each slice along it."""
    if dim is None:
        return _span_normalize(x, torch.amin(x), torch.amax(x))
    return _span_normalize(x, torch.amin(x, dim=dim, keepdim=True),
                           torch.amax(x, dim=dim, keepdim=True))


def segment_min_max_normalize(x: torch.Tensor, segment_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Min-max normalization along dim 0 within each segment (the rows
    of one query group). One ``scatter_reduce`` for the minima and one
    for the maxima; both are exact, so the result does not depend on
    the order of the rows."""
    seg = segment_ids.to(device=x.device, dtype=torch.int64)
    idx = seg.view(-1, *([1] * (x.ndim - 1))).expand_as(x)
    shape = (num_segments, *x.shape[1:])
    lo = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_reduce_(
        0, idx, x, "amin", include_self=False)
    hi = torch.zeros(shape, dtype=x.dtype, device=x.device).scatter_reduce_(
        0, idx, x, "amax", include_self=False)
    return _span_normalize(x, lo[seg], hi[seg])
