"""Gradient-descent machinery shared by the online learners.

Counterpart of ``bayesian_bm25_tpu/ops/gd.py``: one online step (EMA
gradient smoothing with bias correction, global L2 clipping, a
1 / (1 + t / tau) learning-rate decay and Polyak averaging) and one
batch fit loop with a tolerance stop, over parameters held as a tuple
of tensors (the JAX pytrees). Both compute on the parameters' device.
The fit loop is a Python loop whose stop test reads one bool a step,
as ``ops/transform.fit_transform`` does; JAX runs it as a
``lax.while_loop``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bayesian_bm25_tpu_torch.ops.transform import true_div

class OnlineState(NamedTuple):
    """Online-learning state over a tuple of parameter tensors."""

    params: tuple
    grad_ema: tuple
    params_avg: tuple
    n_updates: int


def init_online(params: tuple) -> OnlineState:
    return OnlineState(params, tuple(torch.zeros_like(p) for p in params),
                       params, 0)


def online_step(state: OnlineState, grads: tuple, *, learning_rate,
                momentum, decay_tau, max_grad_norm, avg_decay,
                postprocess=None, average=None) -> OnlineState:
    """EMA -> bias correction -> clip -> decayed step -> Polyak average.

    ``postprocess(params) -> params`` applies constraints after the
    step; ``average(params) -> params`` maps the parameters to the space
    that is Polyak-averaged (the learnable weights average in the
    simplex), the identity by default.
    """
    g0 = grads[0]
    dt, dev = g0.dtype, g0.device
    mom = torch.tensor(momentum, dtype=dt, device=dev)
    ema = tuple(mom * e + (1.0 - mom) * g
                for e, g in zip(state.grad_ema, grads))

    t = state.n_updates + 1
    t_f = torch.tensor(t, dtype=dt, device=dev)
    correction = 1.0 - mom ** t_f
    corrected = tuple(e / correction for e in ema)

    norm = torch.sqrt(sum(torch.sum(c * c) for c in corrected))
    max_norm = torch.tensor(max_grad_norm, dtype=dt, device=dev)
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    corrected = tuple(c * scale for c in corrected)

    lr = (torch.tensor(learning_rate, dtype=dt, device=dev)
          / (1.0 + true_div(t_f, float(decay_tau))))
    params = tuple(p - lr * c for p, c in zip(state.params, corrected))
    if postprocess is not None:
        params = postprocess(params)

    ad = torch.tensor(avg_decay, dtype=dt, device=dev)
    target = params if average is None else average(params)
    params_avg = tuple(ad * a + (1.0 - ad) * p
                       for a, p in zip(state.params_avg, target))
    return OnlineState(params, ema, params_avg, t)


def fit_loop(grad_fn, params0: tuple, *, learning_rate, max_iterations: int,
             tolerance, convergence: str = "param_change"):
    """Batch gradient descent with a tolerance stop.

    ``grad_fn(params) -> grads`` (tuples of the same shapes). The stop
    test, read after each step (the step that converges is applied):
      * "param_change": every |delta param| < tolerance;
      * "step_size" (any other value): every |lr * grad| < tolerance.
    Returns (params, n_iterations).
    """
    p0 = params0[0]
    lr = torch.tensor(learning_rate, dtype=p0.dtype, device=p0.device)
    tol = torch.tensor(tolerance, dtype=p0.dtype, device=p0.device)
    params = params0
    it = 0
    done = False
    while not done and it < max_iterations:
        grads = grad_fn(params)
        new = tuple(p - lr * g for p, g in zip(params, grads))
        if convergence == "param_change":
            deltas = [torch.amax(torch.abs(q - p)) for p, q in zip(params, new)]
        else:
            deltas = [torch.amax(torch.abs(lr * g)) for g in grads]
        # One device-to-host read a step.
        done = bool(torch.all(torch.stack(deltas) < tol))
        params = new
        it += 1
    return params, it
