"""Drop-in import compatibility with the reference ``bayesian_bm25``.

Counterpart of ``bayesian_bm25_tpu/compat.py``, backed by this package:
``install()`` synthesizes a virtual ``bayesian_bm25`` package (and its
submodules ``probability``/``fusion``/``scorer``/``calibration``/
``metrics``/``debug``/``multi_field``/``vector_probability``) in
``sys.modules`` from the port's modules, so reference user code runs
unchanged on the card::

    from bayesian_bm25_tpu_torch.compat import install
    install()

    from bayesian_bm25 import BayesianBM25Scorer          # the port's
    from bayesian_bm25.probability import sigmoid, logit  # the port's

The modules carry the ``__bb25_tpu_compat__`` marker the JAX package's
compat modules carry, so either package's ``install()`` replaces the
other's virtual package and either ``uninstall()`` removes it.
``install()`` refuses to shadow a real ``bayesian_bm25`` installation
unless ``force=True``.
"""

from __future__ import annotations

import sys
import types

# reference submodule -> the port's modules whose public names it holds
_MODULE_MAP: dict[str, list[str]] = {
    "probability": ["bayesian_bm25_tpu_torch.models.probability"],
    "fusion": [
        # the reference keeps functions and learners in one module
        "bayesian_bm25_tpu_torch.api_fusion",
        "bayesian_bm25_tpu_torch.models.fusion_weights",
    ],
    # the reference scorer module also exports BlockMaxIndex
    "scorer": ["bayesian_bm25_tpu_torch.models.scorer",
               "bayesian_bm25_tpu_torch.engine.block_max"],
    "calibration": ["bayesian_bm25_tpu_torch.models.calibration"],
    "metrics": ["bayesian_bm25_tpu_torch.utils.metrics"],
    "debug": ["bayesian_bm25_tpu_torch.utils.debug"],
    "multi_field": ["bayesian_bm25_tpu_torch.models.multi_field"],
    "vector_probability": [
        "bayesian_bm25_tpu_torch.models.vector_probability"],
}

# The reference package's top-level names.
_TOP_LEVEL = [
    "AttentionLogOddsWeights", "LearnableLogOddsWeights",
    "MultiHeadAttentionLogOddsWeights", "balanced_log_odds_fusion",
    "cosine_to_probability", "log_odds_conjunction", "prob_and",
    "prob_not", "prob_or", "CalibrationReport", "brier_score",
    "calibration_report", "expected_calibration_error", "log_loss",
    "reliability_diagram", "BayesianProbabilityTransform",
    "TemporalBayesianTransform", "BayesianBM25Scorer",
    "RetrievalResult", "BlockMaxIndex", "MultiFieldScorer",
    "FusionDebugger", "PlattCalibrator", "IsotonicCalibrator",
    "VectorProbabilityTransform", "ivf_density_prior",
    "knn_density_prior",
]


def _synth_module(name: str, sources: list[str]) -> types.ModuleType:
    import importlib

    mod = types.ModuleType(name)
    mod.__doc__ = (f"Virtual {name}: bayesian_bm25_tpu_torch compat alias "
                   f"for {', '.join(sources)}")
    for src in sources:
        real = importlib.import_module(src)
        public = getattr(real, "__all__", None)
        if public is None:
            public = [n for n in vars(real) if not n.startswith("_")]
        for n in public:
            setattr(mod, n, getattr(real, n))
    return mod


def install(force: bool = False) -> None:
    """Register the virtual ``bayesian_bm25`` package in sys.modules.

    Idempotent. Raises RuntimeError if a real ``bayesian_bm25`` (not a
    compat alias of either package) is already imported or importable
    and ``force`` is False.
    """
    existing = sys.modules.get("bayesian_bm25")
    if existing is not None and not getattr(existing, "__bb25_tpu_compat__",
                                            False):
        if not force:
            raise RuntimeError(
                "a real 'bayesian_bm25' module is already imported; pass "
                "force=True to shadow it with the PyTorch implementation")
    elif existing is None and not force:
        import importlib.util

        try:
            spec = importlib.util.find_spec("bayesian_bm25")
        except (ImportError, ValueError):
            spec = None
        if spec is not None:
            raise RuntimeError(
                "a real 'bayesian_bm25' package is installed; pass "
                "force=True to shadow it with the PyTorch implementation")

    import bayesian_bm25_tpu_torch as root

    uninstall()
    pkg = types.ModuleType("bayesian_bm25")
    pkg.__doc__ = "Virtual bayesian_bm25: bayesian_bm25_tpu_torch compat alias"
    pkg.__path__ = []  # a package, so submodule imports resolve
    pkg.__bb25_tpu_compat__ = True
    pkg.__version__ = root.__version__

    for sub, sources in _MODULE_MAP.items():
        m = _synth_module(f"bayesian_bm25.{sub}", sources)
        m.__bb25_tpu_compat__ = True
        sys.modules[f"bayesian_bm25.{sub}"] = m
        setattr(pkg, sub, m)

    for n in _TOP_LEVEL:
        setattr(pkg, n, getattr(root, n))

    sys.modules["bayesian_bm25"] = pkg


def uninstall() -> None:
    """Remove the virtual package (a no-op if a real one is loaded)."""
    mod = sys.modules.get("bayesian_bm25")
    if mod is not None and getattr(mod, "__bb25_tpu_compat__", False):
        for name in list(sys.modules):
            if name == "bayesian_bm25" or name.startswith("bayesian_bm25."):
                if getattr(sys.modules[name], "__bb25_tpu_compat__", False):
                    del sys.modules[name]
