"""Bayesian BM25 on PyTorch and CUDA: calibrated retrieval probabilities
on an NVIDIA GPU.

The port of ``bayesian_bm25_tpu`` (JAX, TPU), which stays in the
repository as the reference. The layout mirrors it:

  * ``ops``     — math primitives and the Bayesian transform, with its
                  batch fit and online update
  * ``engine``  — host-side index build (numpy), the tokenizers and the
                  ctypes loader of the C++ host loops (``native``: corpus
                  build, query encoding, JSONL loading), the
                  frequency-split index and its sparse-candidate
                  retrieval, the doc-major compare, and the hand-written
                  CUDA kernels that replace the Pallas ones
                  (``cuda_reduce``, ``cuda_gather``, ``cuda_topk``,
                  ``cuda_matmul``, ``cuda_bm25``; sources in ``csrc/``)
  * ``models``  — ``BayesianBM25Scorer`` (token and raw-text entry
                  points), ``BayesianProbabilityTransform`` and
                  ``TemporalBayesianTransform``
  * ``utils``   — state conversion between the two packages

This package imports torch and numpy, never JAX.
"""

from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform,
    TemporalBayesianTransform,
)
from bayesian_bm25_tpu_torch.models.scorer import BayesianBM25Scorer

__all__ = ["BayesianBM25Scorer", "BayesianProbabilityTransform",
           "TemporalBayesianTransform"]
