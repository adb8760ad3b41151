"""Bayesian BM25 on PyTorch and CUDA: calibrated retrieval probabilities
on an NVIDIA GPU.

The port of ``bayesian_bm25_tpu`` (JAX, TPU), which stays in the
repository as the reference. The layout mirrors it:

  * ``ops``     — math primitives, the Bayesian transform with its batch
                  fit and online update, the fusion algebra
                  (``fusion``), the shared gradient-descent machinery
                  (``gd``), the learnable and attention fusion
                  weights (``fusion_learn``) and the density estimators
                  of vector calibration (``density``)
  * ``engine``  — host-side index build (numpy), the tokenizers and the
                  ctypes loader of the C++ host loops (``native``: corpus
                  build, query encoding, JSONL loading), the
                  frequency-split index and its sparse-candidate
                  retrieval, the doc-major compare, the block-max index
                  (``block_max``), and the hand-written CUDA kernels that
                  replace the Pallas ones (``cuda_reduce``,
                  ``cuda_gather``, ``cuda_topk``, ``cuda_matmul``,
                  ``cuda_bm25``; sources in ``csrc/``), and the IVF
                  cosine index (``ivf``)
  * ``parallel`` — document sharding over a mesh of devices
                  (``sharded``) and ``ShardedBayesianBM25Scorer``
  * ``models``  — ``BayesianBM25Scorer`` (token and raw-text entry
                  points, ``retrieve(explain=True)``), the probability
                  transforms, the fusion weight models, the Platt and
                  isotonic calibrators, ``MultiFieldScorer`` and
                  ``VectorProbabilityTransform`` with its density priors
  * ``utils``   — calibration metrics, the fusion debugger, search
                  diagnostics, checkpoints in the JAX package's archive
                  format (``io``), and state conversion between the two
                  packages
  * ``api_fusion`` — the numpy-facing fusion functions
  * ``compat``  — the reference ``bayesian_bm25`` import surface

Every numpy-facing class and function computes on ``device``, the card
(``"cuda"``) unless the caller names another; without CUDA, asking for
the card raises. This package imports torch and numpy, never JAX.
"""

from bayesian_bm25_tpu_torch.api_fusion import (
    balanced_log_odds_fusion,
    cosine_to_probability,
    log_odds_conjunction,
    prob_and,
    prob_not,
    prob_or,
)
from bayesian_bm25_tpu_torch.models.fusion_weights import (
    AttentionLogOddsWeights,
    LearnableLogOddsWeights,
    MultiHeadAttentionLogOddsWeights,
)
from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform,
    TemporalBayesianTransform,
)
from bayesian_bm25_tpu_torch.utils.metrics import (
    CalibrationReport,
    brier_score,
    calibration_report,
    expected_calibration_error,
    log_loss,
    reliability_diagram,
)

__version__ = "0.1.0"

# The JAX package's __all__.
__all__ = [
    "__version__",
    "AttentionLogOddsWeights",
    "BayesianProbabilityTransform",
    "BayesianBM25Scorer",
    "BlockMaxIndex",
    "CalibrationReport",
    "FusionDebugger",
    "IsotonicCalibrator",
    "LearnableLogOddsWeights",
    "MultiFieldScorer",
    "MultiHeadAttentionLogOddsWeights",
    "PlattCalibrator",
    "RetrievalResult",
    "ShardedBayesianBM25Scorer",
    "TemporalBayesianTransform",
    "VectorProbabilityTransform",
    "balanced_log_odds_fusion",
    "brier_score",
    "calibration_report",
    "cosine_to_probability",
    "expected_calibration_error",
    "ivf_density_prior",
    "knn_density_prior",
    "log_loss",
    "log_odds_conjunction",
    "prob_and",
    "prob_not",
    "prob_or",
    "reliability_diagram",
]


def __getattr__(name: str):
    # The heavier modules (the engine, the debugger) load on first use,
    # as in the JAX package.
    if name in ("BayesianBM25Scorer", "RetrievalResult"):
        from bayesian_bm25_tpu_torch.models import scorer as _scorer

        return getattr(_scorer, name)
    if name == "ShardedBayesianBM25Scorer":
        from bayesian_bm25_tpu_torch.parallel.sharded_scorer import (
            ShardedBayesianBM25Scorer)

        return ShardedBayesianBM25Scorer
    if name == "BlockMaxIndex":
        from bayesian_bm25_tpu_torch.engine.block_max import BlockMaxIndex

        return BlockMaxIndex
    if name == "MultiFieldScorer":
        from bayesian_bm25_tpu_torch.models.multi_field import MultiFieldScorer

        return MultiFieldScorer
    if name == "FusionDebugger":
        from bayesian_bm25_tpu_torch.utils.debug import FusionDebugger

        return FusionDebugger
    if name in ("PlattCalibrator", "IsotonicCalibrator"):
        from bayesian_bm25_tpu_torch.models import calibration as _cal

        return getattr(_cal, name)
    if name in ("VectorProbabilityTransform", "ivf_density_prior",
                "knn_density_prior"):
        from bayesian_bm25_tpu_torch.models import vector_probability as _vp

        return getattr(_vp, name)
    raise AttributeError(
        f"module 'bayesian_bm25_tpu_torch' has no attribute {name!r}")
