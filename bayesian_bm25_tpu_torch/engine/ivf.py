"""IVF cosine index: Lloyd k-means on the device and multi-probe search.

Counterpart of ``bayesian_bm25_tpu/engine/ivf.py``. ``SimpleIVF.build``
runs the k-means assignment and update steps on the device (float32
products, a first-maximum ``argmax``, ``index_add_`` sums, empty cells
refilled from draws made up front from ``np.random.default_rng(seed)``
in the JAX package's order); the CSR layout, per-cell residuals and
percentiles stay host numpy, as there. ``search`` keeps the JAX
package's host selection (``argpartition`` / ``argsort``) over a device
scoring product. ``search_batch`` scores query chunks sized to
``_SCORES_BUDGET_BYTES`` against the whole corpus, masks the documents
outside each query's probed cells through an (nq, n_cells) table
gathered by the assignments (not JAX's (nq, n_docs, nprobe) compare),
and selects with ``lax.top_k``'s order: K3 (``cuda_topk.topk``) for the
probes, K1 + K3 (``split_index.exact_topk_blockwise``) for the k
documents, so ties and the -inf of short probed sets come back lowest
index first. Every float32 product is a full float32 one: the card's
TF32 mode must be off (PyTorch's default).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import cuda_topk
from bayesian_bm25_tpu_torch.engine.index import to_device
from bayesian_bm25_tpu_torch.engine.split_index import exact_topk_blockwise
from bayesian_bm25_tpu_torch.ops.mathx import resolve_device

_EPSILON = 1e-12
# Documents a leader-selection block holds (K1's block width).
_BLOCK = 128


def _l2_normalize_rows(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.float32)
    norms = np.linalg.norm(arr, axis=1, keepdims=True)
    return arr / np.maximum(norms, _EPSILON)


def _check_full_f32(device: torch.device) -> None:
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the IVF's cosine "
            "products must run in full float32")


def _lloyd(emb: torch.Tensor, init_centroids: torch.Tensor,
           refill_pool: torch.Tensor, n_cells: int, max_iterations: int):
    """Fixed-iteration Lloyd k-means with empty-cell refill: iteration t
    refills empty cell c with document refill_pool[t, c]. Returns
    (centroids, assignments, centroid_scores) on the device."""
    centroids = init_centroids
    for t in range(max_iterations):
        assign = torch.argmax(emb @ centroids.T, dim=1)
        sums = torch.zeros((n_cells, emb.shape[1]), dtype=emb.dtype,
                           device=emb.device).index_add_(0, assign, emb)
        counts = torch.bincount(assign, minlength=n_cells).to(emb.dtype)
        new_c = sums / torch.clamp(counts, min=1.0)[:, None]
        new_c = torch.where((counts == 0)[:, None], emb[refill_pool[t]],
                            new_c)
        norms = torch.sqrt(torch.sum(new_c * new_c, dim=1, keepdim=True))
        centroids = new_c / torch.clamp(norms, min=_EPSILON)
    final_sims = emb @ centroids.T
    assignments = torch.argmax(final_sims, dim=1)
    centroid_scores = torch.gather(final_sims, 1, assignments[:, None])[:, 0]
    return centroids, assignments, centroid_scores


@dataclass
class IVFSearchResult:
    """Per-query IVF search bundle."""

    indices: np.ndarray
    scores: np.ndarray
    cell_ids: np.ndarray
    cell_populations: np.ndarray
    candidate_indices: np.ndarray
    candidate_scores: np.ndarray
    candidate_cell_ids: np.ndarray
    candidate_cell_populations: np.ndarray
    probed_cell_ids: np.ndarray
    probed_cell_scores: np.ndarray
    centroid_scores: np.ndarray


class SimpleIVF:
    """Cosine IVF with a CSR-like cell layout; the embeddings, centroids
    and assignments are also kept on ``device`` (the card unless the
    caller names another), the embeddings padded with zero rows to a
    whole number of K1 blocks."""

    _SCORES_BUDGET_BYTES = 4 << 30

    def __init__(self, embeddings, centroids, assignments, sorted_doc_ids,
                 cell_offsets, *, default_nprobe: int, background_distances,
                 cell_residual_means, cell_residual_q90, device=None) -> None:
        self._device = resolve_device(device)
        self.embeddings = np.asarray(embeddings, dtype=np.float32)
        self.centroids = np.asarray(centroids, dtype=np.float32)
        self.assignments = np.asarray(assignments, dtype=np.int32)
        self.sorted_doc_ids = np.asarray(sorted_doc_ids, dtype=np.int32)
        self.cell_offsets = np.asarray(cell_offsets, dtype=np.int64)
        self.default_nprobe = int(default_nprobe)
        self.background_distances = np.asarray(background_distances, np.float64)
        self.cell_residual_means = np.asarray(cell_residual_means, np.float64)
        self.cell_residual_q90 = np.asarray(cell_residual_q90, np.float64)

        self.n_docs = int(self.embeddings.shape[0])
        self.dim = int(self.embeddings.shape[1])
        self.n_cells = int(self.centroids.shape[0])
        self.cell_populations = np.diff(self.cell_offsets).astype(np.int32)
        self.avg_population = float(np.mean(self.cell_populations))

        dev = self._device
        d_pad = -(-self.n_docs // _BLOCK) * _BLOCK
        self._emb_pad = torch.zeros((d_pad, self.dim), dtype=torch.float32,
                                    device=dev)
        self._emb_pad[: self.n_docs] = to_device(self.embeddings, dev)
        self._emb_dev = self._emb_pad[: self.n_docs]
        self._centroids_dev = to_device(self.centroids, dev)
        # Pad documents sit in cell n_cells, which no query probes.
        assign = np.full(d_pad, self.n_cells, dtype=np.int64)
        assign[: self.n_docs] = self.assignments
        self._assign_pad = to_device(assign, dev)

    @property
    def device(self) -> torch.device:
        return self._device

    @classmethod
    def build(cls, embeddings, *, n_cells: int | None = None,
              max_iterations: int = 10, seed: int = 42,
              device=None) -> "SimpleIVF":
        embeddings = _l2_normalize_rows(embeddings)
        n_docs, dim = embeddings.shape
        if n_docs == 0:
            raise ValueError("embeddings must contain at least one vector")
        if n_cells is None:
            n_cells = max(4, int(round(math.sqrt(n_docs))))
        n_cells = max(1, min(int(n_cells), n_docs))
        if max_iterations <= 0:
            raise ValueError(
                f"max_iterations must be positive, got {max_iterations}"
            )
        dev = resolve_device(device)
        _check_full_f32(dev)

        rng = np.random.default_rng(seed)
        init_idx = rng.choice(n_docs, size=n_cells, replace=False)
        refill_pool = rng.integers(
            0, n_docs, size=(max_iterations, n_cells)
        ).astype(np.int32)

        emb = to_device(embeddings, dev)
        centroids, assignments, centroid_scores = _lloyd(
            emb, emb[to_device(init_idx.astype(np.int64), dev)],
            to_device(refill_pool.astype(np.int64), dev), n_cells,
            max_iterations)
        del emb
        centroids = centroids.cpu().numpy()
        assignments = assignments.cpu().numpy().astype(np.int32)
        centroid_scores = centroid_scores.cpu().numpy()

        counts = np.bincount(assignments, minlength=n_cells).astype(np.int32)
        order = np.argsort(assignments, kind="stable")
        offsets = np.zeros(n_cells + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(counts, dtype=np.int64)

        background = 1.0 - centroid_scores.astype(np.float64)
        g_mean = float(np.mean(background))
        g_q90 = float(np.percentile(background, 90))
        res_means = np.full(n_cells, g_mean)
        res_q90 = np.full(n_cells, g_q90)
        for cell in np.flatnonzero(counts):
            # A cell's documents in ascending id order, as a boolean
            # mask over the corpus would list them.
            res = background[order[offsets[cell]:offsets[cell + 1]]]
            res_means[cell] = float(np.mean(res))
            res_q90[cell] = float(np.percentile(res, 90))

        return cls(
            embeddings=embeddings, centroids=centroids,
            assignments=assignments,
            sorted_doc_ids=order.astype(np.int32), cell_offsets=offsets,
            default_nprobe=max(1, int(round(math.sqrt(n_cells)))),
            background_distances=background,
            cell_residual_means=res_means, cell_residual_q90=res_q90,
            device=dev,
        )

    def _docs_for_cells(self, cell_ids) -> np.ndarray:
        groups = []
        for cell in cell_ids:
            start = int(self.cell_offsets[cell])
            end = int(self.cell_offsets[cell + 1])
            if end > start:
                groups.append(self.sorted_doc_ids[start:end])
        if not groups:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(groups).astype(np.int32, copy=False)

    def score_documents(self, query, doc_indices) -> np.ndarray:
        """Exact cosine scores for selected docs (a device product)."""
        q = np.asarray(query, dtype=np.float32)
        q = q / max(float(np.linalg.norm(q)), _EPSILON)
        doc_indices = np.asarray(doc_indices, dtype=np.int64)
        if len(doc_indices) == 0:
            return np.empty(0, dtype=np.float64)
        _check_full_f32(self._device)
        rows = self._emb_dev[to_device(doc_indices, self._device)]
        scores = rows @ to_device(q, self._device)
        return scores.cpu().numpy().astype(np.float64)

    def search(self, query, k: int, *, nprobe: int | None = None
               ) -> IVFSearchResult:
        q = np.asarray(query, dtype=np.float32)
        q = q / max(float(np.linalg.norm(q)), _EPSILON)
        if nprobe is None:
            nprobe = self.default_nprobe
        nprobe = max(1, min(int(nprobe), self.n_cells))

        centroid_scores = self.centroids @ q
        if nprobe >= self.n_cells:
            probed = np.arange(self.n_cells, dtype=np.int32)
        else:
            part = np.argpartition(-centroid_scores, nprobe - 1)[:nprobe]
            probed = part[np.argsort(-centroid_scores[part])].astype(np.int32)
        probed_scores = centroid_scores[probed].astype(np.float64)

        cand = self._docs_for_cells(probed)
        cand_scores = self.score_documents(q, cand)
        cand_cells = self.assignments[cand]
        cand_pops = self.cell_populations[cand_cells]

        k_eff = min(max(int(k), 0), len(cand))
        if k_eff == 0:
            empty_i = np.empty(0, dtype=np.int32)
            empty_f = np.empty(0, dtype=np.float64)
            return IVFSearchResult(
                empty_i, empty_f, empty_i, empty_i, cand, cand_scores,
                cand_cells, cand_pops, probed, probed_scores,
                centroid_scores.astype(np.float64),
            )

        if k_eff == len(cand):
            top = np.argsort(-cand_scores)
        else:
            top = np.argpartition(-cand_scores, k_eff - 1)[:k_eff]
            top = top[np.argsort(-cand_scores[top])]

        return IVFSearchResult(
            indices=cand[top].astype(np.int32),
            scores=cand_scores[top],
            cell_ids=cand_cells[top].astype(np.int32),
            cell_populations=cand_pops[top].astype(np.int32),
            candidate_indices=cand,
            candidate_scores=cand_scores,
            candidate_cell_ids=cand_cells.astype(np.int32),
            candidate_cell_populations=cand_pops.astype(np.int32),
            probed_cell_ids=probed,
            probed_cell_scores=probed_scores,
            centroid_scores=centroid_scores.astype(np.float64),
        )

    def _chunk_rows(self) -> int:
        """Largest power-of-two query chunk whose (nq, D_pad) float32
        score matrix fits _SCORES_BUDGET_BYTES (floor 1, cap 8192)."""
        d_pad = self._emb_pad.shape[0]
        b = 1
        while b * 2 * d_pad * 4 <= self._SCORES_BUDGET_BYTES and b < 8192:
            b *= 2
        return b

    def search_batch(self, queries, k: int, *, nprobe: int | None = None):
        """Exact search over each query's probed cells, batched: (nq, k)
        int32 ids and float64 scores, -inf (ids in index order) where
        the probed cells hold fewer than k documents."""
        qs = _l2_normalize_rows(np.asarray(queries, dtype=np.float32))
        if nprobe is None:
            nprobe = self.default_nprobe
        nprobe = max(1, min(int(nprobe), self.n_cells))
        k = int(k)
        if not 0 <= k <= self.n_docs:
            raise ValueError(f"k must be in [0, {self.n_docs}], got {k}")
        nq = qs.shape[0]
        if k == 0 or nq == 0:
            return (np.zeros((nq, k), np.int32),
                    np.zeros((nq, k), np.float64))
        _check_full_f32(self._device)
        step = self._chunk_rows()
        ids, scores = [], []
        for lo in range(0, nq, step):
            q = to_device(qs[lo:lo + step], self._device)
            top_s, top_i = _batch_search(q, self._centroids_dev,
                                         self._emb_pad, self._assign_pad,
                                         k, nprobe)
            ids.append(top_i)
            scores.append(top_s)
        return (torch.cat(ids).to(torch.int32).cpu().numpy(),
                torch.cat(scores).cpu().numpy().astype(np.float64))


def _batch_search(q, centroids, emb_pad, assign_pad, k: int, nprobe: int):
    """One query chunk of ``search_batch`` on the device: the probes by
    K3, a probe table (nq, n_cells + 1) gathered by each document's
    cell, the masked (nq, D_pad) cosine scores, and the k best by
    K1 + K3. Returns (scores, ids)."""
    n_cells = centroids.shape[0]
    _, probed = cuda_topk.topk(q @ centroids.T, nprobe)
    table = torch.zeros((q.shape[0], n_cells + 1), dtype=torch.bool,
                        device=q.device)
    table.scatter_(1, probed.long(), True)
    dscores = q @ emb_pad.T
    dscores.masked_fill_(~table[:, assign_pad], float("-inf"))
    return exact_topk_blockwise(dscores, k, block=_BLOCK)
