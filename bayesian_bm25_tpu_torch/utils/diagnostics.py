"""Search diagnostics and the separability gate for query-adaptive
dense gating.

Counterpart of ``bayesian_bm25_tpu/utils/diagnostics.py`` (host numpy
there and here): distance-shell diagnostics from exact or IVF retrieval
(``engine/ivf.py``'s ``IVFSearchResult`` and ``SimpleIVF``), and a
silhouette-like gate in [min_gate, max_gate] that scales the dense
signal's trust per query. It reads only numpy arrays and floats, so it
computes on the host whatever device the index uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_EPSILON = 1e-12


@dataclass
class SearchDiagnostics:
    """Query-local retrieval diagnostics (accepted vs contrast shells)."""

    accepted_distances: np.ndarray
    contrast_distances: np.ndarray
    purity: float = 1.0
    coverage: float = 1.0

    def __post_init__(self) -> None:
        self.accepted_distances = np.asarray(self.accepted_distances, np.float64)
        self.contrast_distances = np.asarray(self.contrast_distances, np.float64)
        self.purity = float(np.clip(self.purity, 0.0, 1.0))
        self.coverage = float(np.clip(self.coverage, 0.0, 1.0))

    @property
    def cohesion(self) -> float:
        if len(self.accepted_distances) == 0:
            return 1.0
        return float(np.mean(self.accepted_distances))

    @property
    def separation(self) -> float:
        if len(self.contrast_distances) == 0:
            return self.cohesion
        return float(np.mean(self.contrast_distances))

    @property
    def reliability(self) -> float:
        return float(np.clip(self.purity * self.coverage, 0.0, 1.0))


def _to_distances(scores) -> np.ndarray:
    return 1.0 - np.asarray(scores, dtype=np.float64)


def build_exact_search_diagnostics(dense_top_scores, *, local_k: int = 10,
                                   shell_k: int = 10) -> SearchDiagnostics:
    """Top-k shell vs next-k shell from exact (sorted) dense scores."""
    s = np.asarray(dense_top_scores, dtype=np.float64)
    if len(s) == 0:
        return SearchDiagnostics([], [], purity=0.0, coverage=0.0)
    local_k = max(1, min(local_k, len(s)))
    accepted = _to_distances(s[:local_k])
    shell_end = min(local_k + shell_k, len(s))
    contrast = (
        _to_distances(s[local_k:shell_end])
        if shell_end > local_k else np.empty(0, np.float64)
    )
    return SearchDiagnostics(accepted, contrast, purity=1.0, coverage=1.0)


def build_ivf_search_diagnostics(dense_top_scores, top_cell_ids, search_result,
                                 dense_index, *, local_k: int = 10,
                                 shell_k: int = 10) -> SearchDiagnostics:
    """Primary-cell purity + cross-cell contrast, with a centroid+residual
    fallback when every candidate sits in the primary cell."""
    s = np.asarray(dense_top_scores, dtype=np.float64)
    cells = np.asarray(top_cell_ids, dtype=np.int32)
    if len(s) == 0 or len(cells) == 0:
        return SearchDiagnostics([], [], purity=0.0, coverage=0.0)

    local_k = max(1, min(local_k, len(s), len(cells)))
    local_scores = s[:local_k]
    local_cells = cells[:local_k]

    uniq, counts = np.unique(local_cells, return_counts=True)
    primary = int(uniq[np.argmax(counts)])
    mask = local_cells == primary
    purity = float(np.mean(mask))
    accepted_scores = local_scores[mask]
    if len(accepted_scores) == 0:
        accepted_scores = local_scores
        purity = 1.0 / float(local_k)
    accepted = _to_distances(accepted_scores)

    cand_scores = np.asarray(search_result.candidate_scores, np.float64)
    cand_cells = np.asarray(search_result.candidate_cell_ids, np.int32)
    shell = cand_scores[cand_cells != primary]
    if len(shell) > 0:
        kk = max(1, min(shell_k, len(shell)))
        top = np.argpartition(-shell, kk - 1)[:kk]
        contrast = _to_distances(shell[top])
    else:
        cscores = np.asarray(search_result.centroid_scores, np.float64)
        other = np.ones(len(cscores), dtype=bool)
        if 0 <= primary < len(other):
            other[primary] = False
        if not other.any():
            contrast = np.empty(0, np.float64)
        else:
            other_ids = np.nonzero(other)[0]
            best = int(other_ids[int(np.argmax(cscores[other]))])
            cd = 1.0 - float(cscores[best])
            rd = float(0.5 * (dense_index.cell_residual_means[best]
                              + dense_index.cell_residual_q90[best]))
            contrast = np.asarray([min(2.0, cd + rd)], np.float64)

    return SearchDiagnostics(accepted, contrast, purity=purity, coverage=1.0)


def separability_gate(diagnostics: SearchDiagnostics, *, min_gate: float = 0.02,
                      max_gate: float = 0.98) -> float:
    """Silhouette-like gate (b - a)/max(a, b) * reliability, clipped."""
    if len(diagnostics.accepted_distances) == 0:
        return min_gate
    a = max(diagnostics.cohesion, 0.0)
    b = max(diagnostics.separation, 0.0)
    score = max(0.0, (b - a) / max(a, b, _EPSILON))
    score *= diagnostics.reliability
    return float(np.clip(score, min_gate, max_gate))
