"""Carry index state between the JAX package and the port as numpy.

``index_to_numpy`` and ``split_index_to_numpy`` read a doc-major or
frequency-split index of either package (its arrays may be JAX arrays,
numpy arrays or torch tensors) into a plain dict of numpy arrays and
Python values; bfloat16 arrays travel as their ``uint16`` bit patterns,
since numpy has no bfloat16 and ``torch.from_numpy`` refuses ml_dtypes'
one. ``index_from_numpy``, ``split_index_from_numpy`` and
``scorer_from_numpy`` rebuild the port's index or scorer from such a
dict on a given device, so both packages can compute on the same state,
and one device's state can be reproduced on another.
``transform_to_numpy`` and ``transform_from_numpy`` carry a probability
transform's whole state (parameters, training mode, the online EMAs,
Polyak averages and update count, and a temporal transform's half-life
and timestamp) the same way, and ``weights_to_numpy`` and
``weights_from_numpy`` a fusion weight model's (learnable, attention or
multi-head: its settings, parameters, gradient EMAs, Polyak averages
and update count). ``ivf_to_numpy`` and ``ivf_from_numpy`` carry a
``SimpleIVF`` (every array its constructor takes, and its default
nprobe), so a search can run on an index another package or device
built; ``vpt_to_numpy`` and ``vpt_from_numpy`` a
``VectorProbabilityTransform``'s three numbers. Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine.index import BM25Index, to_device
from bayesian_bm25_tpu_torch.engine.ivf import SimpleIVF
from bayesian_bm25_tpu_torch.engine.split_index import SplitBM25Index
from bayesian_bm25_tpu_torch.models.fusion_weights import (
    AttentionLogOddsWeights, LearnableLogOddsWeights,
    MultiHeadAttentionLogOddsWeights)
from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform, TemporalBayesianTransform)
from bayesian_bm25_tpu_torch.models.scorer import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.models.vector_probability import (
    VectorProbabilityTransform)

_BASE_VALUES = ("k1", "b", "method", "n_docs", "n_terms", "avgdl",
                "max_doc_terms", "score_scale", "delta")
_BASE_DEVICE = ("term_ids", "weights", "doc_lengths")
_BASE_HOST = ("doc_frequencies", "idf", "term_ids_host", "term_counts_host",
              "weights_host", "doc_lengths_host")
_SPLIT_VALUES = ("n_frequent", "post_w_positive")
_SPLIT_DEVICE = ("dense_impact", "dense_presence", "tail_term_ids",
                 "tail_weights", "dense_impact_lo", "over_term_ids",
                 "over_weights", "over_doc_ids", "post_doc_ids",
                 "post_weights", "post2_doc_ids", "post2_weights",
                 "impact_scale")
_SPLIT_HOST = ("freq_slot_of_term", "rare_slot_of_term", "rare_df",
               "rare2_slot_of_term", "rare2_df")
_TRANSFORM_STATE = ("alpha", "beta", "base_rate", "_prior_fn",
                    "_training_mode", "_n_updates", "_grad_alpha_ema",
                    "_grad_beta_ema", "_alpha_avg", "_beta_avg")
_TEMPORAL_STATE = ("_decay_half_life", "_decay_rate", "_timestamp")
# A weight model's settings, then its arrays (parameters, gradient EMAs,
# Polyak averages), by the attribute names both packages use.
_LEARNABLE_VALUES = ("_n_signals", "_alpha", "_base_rate",
                     "_logit_base_rate", "_n_updates")
_LEARNABLE_ARRAYS = ("_logits", "_grad_logits_ema", "_weights_avg")
_ATTENTION_VALUES = ("_n_signals", "_n_query_features", "_alpha",
                     "_normalize", "_base_rate", "_logit_base_rate",
                     "_n_updates")
_ATTENTION_ARRAYS = ("_W", "_b", "_grad_W_ema", "_grad_b_ema", "_W_avg",
                     "_b_avg")
# A SimpleIVF's constructor arguments (both packages' attribute names).
_IVF_ARRAYS = ("embeddings", "centroids", "assignments", "sorted_doc_ids",
               "cell_offsets", "background_distances", "cell_residual_means",
               "cell_residual_q90")
_VPT_VALUES = ("mu_G", "sigma_G", "base_rate")


def array_to_numpy(a) -> np.ndarray | None:
    """JAX array, numpy array or tensor -> numpy; bfloat16 becomes its
    uint16 bit pattern."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def array_from_numpy(arr, device) -> torch.Tensor | None:
    """Inverse of :func:`array_to_numpy` onto ``device``: uint16 arrays
    hold bfloat16 bits (no other field of the index is uint16)."""
    if arr is None:
        return None
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:
        bits = np.array(arr, dtype=np.uint16, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return to_device(arr, device)


def index_to_numpy(index) -> dict:
    """A doc-major BM25Index of either package -> dict of numpy arrays and
    values, with the vocabulary."""
    out = {"vocab": dict(index.vocab)}
    out.update({n: getattr(index, n) for n in _BASE_VALUES})
    out.update({n: array_to_numpy(getattr(index, n))
                for n in _BASE_DEVICE + _BASE_HOST})
    return out


def index_from_numpy(state: dict, device) -> BM25Index:
    """Rebuild the port's BM25Index on ``device`` from an
    :func:`index_to_numpy` dict."""
    return BM25Index(
        vocab=dict(state["vocab"]),
        **{n: state[n] for n in _BASE_VALUES},
        **{n: array_from_numpy(state[n], device) for n in _BASE_DEVICE},
        **{n: None if state[n] is None else np.asarray(state[n])
           for n in _BASE_HOST},
    )


def split_index_to_numpy(split) -> dict:
    """A split index of either package -> dict of numpy arrays and
    values (its base index under ``"base"``, with the vocabulary)."""
    out = {"base": index_to_numpy(split.base)}
    out.update({n: getattr(split, n) for n in _SPLIT_VALUES})
    out.update({n: array_to_numpy(getattr(split, n))
                for n in _SPLIT_DEVICE + _SPLIT_HOST})
    return out


def split_index_from_numpy(state: dict, device) -> SplitBM25Index:
    """Rebuild the port's SplitBM25Index on ``device`` from a
    :func:`split_index_to_numpy` dict."""
    return SplitBM25Index(
        base=index_from_numpy(state["base"], device),
        **{n: state[n] for n in _SPLIT_VALUES},
        **{n: array_from_numpy(state[n], device) for n in _SPLIT_DEVICE},
        **{n: None if state[n] is None else np.asarray(state[n])
           for n in _SPLIT_HOST},
    )


def scorer_from_numpy(state: dict, alpha: float, beta: float,
                      base_rate: float | None = None, *, device,
                      **scorer_kwargs) -> BayesianBM25Scorer:
    """A port scorer on ``device`` serving the index in ``state`` (a
    :func:`split_index_to_numpy` dict, or an :func:`index_to_numpy` dict
    for the doc-major path, with no split index) with the transform
    (alpha, beta, base_rate) pinned; ``scorer_kwargs`` go to the
    constructor."""
    scorer = BayesianBM25Scorer(device=device, **scorer_kwargs)
    if "base" in state:
        scorer._split = split_index_from_numpy(state, device)
        scorer._index = scorer._split.base
    else:
        scorer._split = None
        scorer._index = index_from_numpy(state, device)
    scorer._transform = BayesianProbabilityTransform(
        alpha=alpha, beta=beta, base_rate=base_rate, device=device)
    return scorer


def transform_to_numpy(transform) -> dict:
    """A BayesianProbabilityTransform or TemporalBayesianTransform of
    either package -> dict of its whole state (Python values; a temporal
    transform's half-life, decay rate and timestamp included)."""
    names = _TRANSFORM_STATE
    if hasattr(transform, "_decay_half_life"):
        names += _TEMPORAL_STATE
    return {n: getattr(transform, n) for n in names}


def transform_from_numpy(state: dict, device) -> BayesianProbabilityTransform:
    """The port's transform on ``device`` (temporal when ``state`` has a
    half-life) holding the state of a :func:`transform_to_numpy` dict."""
    if "_decay_half_life" in state:
        out = TemporalBayesianTransform(
            state["alpha"], state["beta"], state["base_rate"],
            decay_half_life=state["_decay_half_life"], device=device)
    else:
        out = BayesianProbabilityTransform(state["alpha"], state["beta"],
                                           state["base_rate"], device=device)
    for name, value in state.items():
        setattr(out, name, value)
    return out


def weights_to_numpy(model) -> dict:
    """A LearnableLogOddsWeights, AttentionLogOddsWeights or
    MultiHeadAttentionLogOddsWeights of either package -> dict of its
    whole state (``"kind"``, settings as Python values, arrays as float64
    numpy; a multi-head model's heads under ``"heads"``)."""
    if hasattr(model, "_heads"):
        return {"kind": "multi_head",
                "heads": [weights_to_numpy(h) for h in model._heads]}
    if hasattr(model, "_W"):
        kind, values, arrays = "attention", _ATTENTION_VALUES, \
            _ATTENTION_ARRAYS
    else:
        kind, values, arrays = "learnable", _LEARNABLE_VALUES, \
            _LEARNABLE_ARRAYS
    out = {"kind": kind}
    out.update({n: getattr(model, n) for n in values})
    out.update({n: np.array(array_to_numpy(getattr(model, n)),
                            dtype=np.float64) for n in arrays})
    return out


def weights_from_numpy(state: dict, device):
    """The port's weight model on ``device`` holding the state of a
    :func:`weights_to_numpy` dict."""
    if state["kind"] == "multi_head":
        heads = [weights_from_numpy(h, device) for h in state["heads"]]
        h0 = heads[0]
        out = MultiHeadAttentionLogOddsWeights(
            len(heads), h0.n_signals, h0.n_query_features, device=device)
        out._heads = heads
        return out
    if state["kind"] == "attention":
        out = AttentionLogOddsWeights(state["_n_signals"],
                                      state["_n_query_features"],
                                      device=device)
        names = _ATTENTION_VALUES, _ATTENTION_ARRAYS
    else:
        out = LearnableLogOddsWeights(state["_n_signals"], device=device)
        names = _LEARNABLE_VALUES, _LEARNABLE_ARRAYS
    for n in names[0]:
        setattr(out, n, state[n])
    for n in names[1]:
        setattr(out, n, array_from_numpy(state[n], out.device))
    return out


def ivf_to_numpy(ivf) -> dict:
    """A SimpleIVF of either package -> dict of its constructor's
    arrays (numpy) and ``default_nprobe``."""
    out = {n: np.array(getattr(ivf, n)) for n in _IVF_ARRAYS}
    out["default_nprobe"] = int(ivf.default_nprobe)
    return out


def ivf_from_numpy(state: dict, device) -> SimpleIVF:
    """The port's SimpleIVF on ``device`` from an :func:`ivf_to_numpy`
    dict."""
    return SimpleIVF(**{n: state[n] for n in _IVF_ARRAYS},
                     default_nprobe=state["default_nprobe"], device=device)


def vpt_to_numpy(vpt) -> dict:
    """A VectorProbabilityTransform of either package -> its (mu_G,
    sigma_G, base_rate)."""
    return {n: getattr(vpt, n) for n in _VPT_VALUES}


def vpt_from_numpy(state: dict, device) -> VectorProbabilityTransform:
    """The port's VectorProbabilityTransform on ``device`` from a
    :func:`vpt_to_numpy` dict."""
    return VectorProbabilityTransform(**state, device=device)
