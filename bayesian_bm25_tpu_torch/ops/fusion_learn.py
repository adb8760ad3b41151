"""Learnable, attention and multi-head log-odds fusion weights on tensors.

Counterpart of ``bayesian_bm25_tpu/ops/fusion_learn.py``: the forward
passes, the gradients (written by hand, as in the JAX package, so the
step sequence is the same), the batch fits and the online steps.
Parameters are tuples of tensors (``AttentionParams`` for attention);
every function computes on its inputs' device and in their dtype. The
multi-head forward is one batched ``einsum`` over the stacked heads
where JAX vmaps the single-head forward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops import gd
from bayesian_bm25_tpu_torch.ops.mathx import (as_input, clamp_probability,
                                               logit, min_max_normalize,
                                               segment_min_max_normalize,
                                               sigmoid, stable_softmax)
from bayesian_bm25_tpu_torch.ops.transform import true_div


def _logits(probs: torch.Tensor) -> torch.Tensor:
    return logit(clamp_probability(probs, probs.dtype), probs.dtype)


def _fuse(w, x, scale, logit_base_rate):
    """sigma(scale * sum(w * x) [+ logit base_rate]) over the last axis,
    and the weighted mean logit."""
    x_bar = torch.sum(w * x, dim=-1)
    l_w = scale * x_bar
    if logit_base_rate is not None:
        l_w = l_w + logit_base_rate
    return sigmoid(l_w, x.dtype), x_bar


def _mean0(g: torch.Tensor) -> torch.Tensor:
    return true_div(torch.sum(g, dim=0), float(g.shape[0]))


# ---------------------------------------------------------------------------
# LearnableLogOddsWeights core: params = (z,), the softmax logits (n_signals,)
# ---------------------------------------------------------------------------


def learnable_forward(z, probs, scale, logit_base_rate=None) -> torch.Tensor:
    """sigma(n^alpha * sum(softmax(z) * logit(p)) [+ logit base_rate])."""
    return _fuse(stable_softmax(z), _logits(probs), scale,
                 logit_base_rate)[0]


def _learnable_grads(z, x, labels, scale, logit_base_rate):
    """Hebbian gradient dL/dz_j = scale * (p - y) * w_j * (x_j - x_bar_w),
    averaged over samples. Takes array-likes, as JAX's does."""
    z = as_input(z)
    x, labels = as_input(x, z), as_input(labels, z)
    w = stable_softmax(z)
    p, x_bar = _fuse(w, x, scale, logit_base_rate)
    err = p - labels
    return _mean0(scale * err[:, None] * w[None, :] * (x - x_bar[:, None]))


def learnable_fit(z0, probs, labels, scale, logit_base_rate=None, *,
                  learning_rate=0.01, max_iterations=1000, tolerance=1e-6):
    """Batch GD for the learnable weights; stops on max |lr * grad|,
    read after the step. Returns (z, n_iterations)."""
    x = _logits(probs)
    labels = torch.atleast_1d(labels)

    def grad_fn(params):
        return (_learnable_grads(params[0], x, labels, scale,
                                 logit_base_rate),)

    (z,), n_iter = gd.fit_loop(
        grad_fn, (z0,), learning_rate=learning_rate,
        max_iterations=max_iterations, tolerance=tolerance,
        convergence="step_size")
    return z, n_iter


def learnable_online_step(state: gd.OnlineState, probs, labels, scale,
                          logit_base_rate=None, **hyper) -> gd.OnlineState:
    """One online update; Polyak averages the softmax weights in the
    simplex."""
    x = _logits(torch.atleast_2d(probs))
    grads = (_learnable_grads(state.params[0], x, torch.atleast_1d(labels),
                              scale, logit_base_rate),)
    return gd.online_step(state, grads,
                          average=lambda ps: (stable_softmax(ps[0]),),
                          **hyper)


# ---------------------------------------------------------------------------
# AttentionLogOddsWeights core: params = (W: (n_sig, n_qf), b: (n_sig,))
# ---------------------------------------------------------------------------


class AttentionParams(NamedTuple):
    W: torch.Tensor
    b: torch.Tensor


def attention_init(n_signals: int, n_query_features: int, seed: int,
                   dtype: torch.dtype = torch.float64,
                   device=None) -> AttentionParams:
    """Xavier-style init N(0, 1/sqrt(n_qf)) drawn from
    ``np.random.default_rng(seed)``, the JAX package's numpy stream, so
    both packages start from the same weights bit for bit."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 1.0 / np.sqrt(n_query_features),
                   size=(n_signals, n_query_features))
    return AttentionParams(torch.as_tensor(W, dtype=dtype, device=device),
                           torch.zeros(n_signals, dtype=dtype, device=device))


def attention_weights(params, query_features) -> torch.Tensor:
    """Softmax attention weights softmax(qf @ W.T + b)."""
    W, b = params
    qf = torch.atleast_2d(query_features)
    return stable_softmax(qf @ W.T + b, dim=-1)


def _prep_logits(probs, normalize: bool, segment_ids=None,
                 num_segments=None) -> torch.Tensor:
    """logit(p), optionally min-max normalized per signal (column): over
    all rows, or within each query group given ``segment_ids``."""
    x = _logits(torch.atleast_2d(probs))
    if normalize:
        if segment_ids is not None:
            return segment_min_max_normalize(x, segment_ids, num_segments)
        return min_max_normalize(x, dim=-2)
    return x


def attention_forward(params, probs, query_features, scale,
                      logit_base_rate=None, *, normalize: bool = False,
                      skip_normalize: bool = False) -> torch.Tensor:
    """Fused probability per candidate row. ``skip_normalize``: a single
    1-D sample has no candidate set to normalize across."""
    x = _prep_logits(probs, normalize and not skip_normalize)
    w = attention_weights(params, query_features)
    return _fuse(w, x, scale, logit_base_rate)[0]


def _attention_grads(params, x, labels, qf, scale, logit_base_rate
                     ) -> AttentionParams:
    """grad_z = scale * (p - y) * w * (x - x_bar_w); dW = grad_z.T @ qf
    / m; db = mean(grad_z). Takes array-likes, as JAX's does."""
    W = as_input(params[0])
    b, x, labels, qf = (as_input(a, W) for a in (params[1], x, labels, qf))
    w = stable_softmax(qf @ W.T + b, dim=-1)
    p, x_bar = _fuse(w, x, scale, logit_base_rate)
    err = p - labels
    grad_z = scale * err[:, None] * w * (x - x_bar[:, None])
    return AttentionParams(true_div(grad_z.T @ qf, float(x.shape[0])),
                           _mean0(grad_z))


def attention_fit(params0, probs, labels, query_features, scale,
                  logit_base_rate=None, *, normalize=False, segment_ids=None,
                  num_segments=None, learning_rate=0.01, max_iterations=1000,
                  tolerance=1e-6):
    """Batch GD on the BCE for (W, b); stops on the largest parameter
    change. Returns (AttentionParams, n_iterations)."""
    x = _prep_logits(probs, normalize, segment_ids, num_segments)
    labels = torch.atleast_1d(labels)
    qf = torch.atleast_2d(query_features)

    def grad_fn(params):
        return _attention_grads(params, x, labels, qf, scale,
                                logit_base_rate)

    params, n_iter = gd.fit_loop(
        grad_fn, tuple(params0), learning_rate=learning_rate,
        max_iterations=max_iterations, tolerance=tolerance,
        convergence="param_change")
    return AttentionParams(*params), n_iter


def attention_online_step(state: gd.OnlineState, probs, labels,
                          query_features, scale, logit_base_rate=None, *,
                          normalize=False, **hyper) -> gd.OnlineState:
    x = _prep_logits(probs, normalize)
    grads = _attention_grads(state.params, x, torch.atleast_1d(labels),
                             torch.atleast_2d(query_features), scale,
                             logit_base_rate)
    return gd.online_step(state, tuple(grads), **hyper)


# ---------------------------------------------------------------------------
# Multi-head: stacked params (n_heads, ...), one batched einsum
# ---------------------------------------------------------------------------


def stack_heads(params_list) -> AttentionParams:
    return AttentionParams(torch.stack([p[0] for p in params_list]),
                           torch.stack([p[1] for p in params_list]))


def multihead_forward(stacked, probs, query_features, scale,
                      logit_base_rate=None, *, normalize=False,
                      skip_normalize=False) -> torch.Tensor:
    """Each head's fused probability, then sigma of the mean of their
    logits."""
    W, b = stacked
    x = _prep_logits(probs, normalize and not skip_normalize)
    qf = torch.atleast_2d(query_features)
    z = torch.einsum("nf,hsf->hns", qf, W) + b[:, None, :]
    per_head = _fuse(stable_softmax(z, dim=-1), x, scale,
                     logit_base_rate)[0]
    return sigmoid(_mean0(_logits(per_head)), x.dtype)
