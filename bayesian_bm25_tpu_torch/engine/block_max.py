"""Block-max (BMW) index: per-block, per-term score maxima for safe
pruning.

Counterpart of ``bayesian_bm25_tpu/engine/block_max.py``. The maxima
live on ``device``, the card unless the caller names another
(``ops/mathx.resolve_device``), as a float64 (n_terms, n_blocks)
tensor. ``build`` reduces a dense (n_terms, n_docs) matrix with one
``amax`` over a view padded with -inf to whole blocks;
``from_bm25_index`` reads the doc-major term table (the dense matrix
never exists) with one ``scatter_reduce_(..., "amax")`` from zeros,
which is exact, so the result equals the JAX package's ``np.maximum.at``
bit for bit. Bayesian bounds go through the transform's WAND upper
bound.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.ops.mathx import resolve_device

_F64 = torch.float64


class BlockMaxIndex:
    """Per-block per-term BM25 maxima (blocks of ``block_size`` docs)."""

    def __init__(self, block_size: int = 128, device=None) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._block_size = block_size
        self._device = resolve_device(device)
        self._block_maxes: torch.Tensor | None = None
        self._n_docs = 0
        self._n_terms = 0

    @property
    def device(self) -> torch.device:
        return self._device

    def build(self, score_matrix) -> None:
        """Build from a dense (n_terms, n_docs) per-term score matrix."""
        m = torch.as_tensor(np.asarray(score_matrix, dtype=np.float64),
                            device=self._device)
        if m.ndim != 2:
            raise ValueError(
                f"score_matrix must be 2D (n_terms, n_docs), got {m.ndim}D"
            )
        self._n_terms, self._n_docs = m.shape
        n_blocks = -(-self._n_docs // self._block_size)
        padded = torch.nn.functional.pad(
            m, (0, n_blocks * self._block_size - self._n_docs),
            value=float("-inf"))
        self._block_maxes = torch.amax(
            padded.view(self._n_terms, n_blocks, self._block_size), dim=2)

    @classmethod
    def from_bm25_index(cls, index, block_size: int = 128,
                        device=None) -> "BlockMaxIndex":
        """Build from an index's doc-major (D_pad, T) term table without
        densifying: the maximum of each (term, block) pair's weights,
        zero where a term has no document in a block."""
        self = cls(block_size, device)
        dev = self._device
        tids = index.term_ids.to(dev)
        w = index.weights.to(device=dev, dtype=_F64)
        D, n_terms = index.n_docs, index.n_terms
        n_blocks = -(-D // block_size)
        rows = torch.arange(tids.shape[0], device=dev)
        valid = (tids >= 0) & (rows < D)[:, None]
        flat = (tids.to(torch.int64) * n_blocks
                + torch.div(rows, block_size, rounding_mode="floor")[:, None])
        bm = torch.zeros(n_terms * n_blocks, dtype=_F64, device=dev)
        bm.scatter_reduce_(0, flat[valid], w[valid], "amax")
        self._block_maxes = bm.view(n_terms, n_blocks)
        self._n_docs = D
        self._n_terms = n_terms
        return self

    def block_upper_bound(self, term_idx: int, block_id: int) -> float:
        if self._block_maxes is None:
            raise RuntimeError("Call build() before block_upper_bound().")
        return float(self._block_maxes[term_idx, block_id])

    def bayesian_block_upper_bound(self, term_idx: int, block_id: int,
                                   transform, p_max: float = 0.9) -> float:
        """Per-block Bayesian probability bound: the transform's WAND
        upper bound of the block maximum."""
        return float(transform.wand_upper_bound(
            self.block_upper_bound(term_idx, block_id), p_max
        ))

    @property
    def block_size(self) -> int:
        return self._block_size

    @property
    def n_blocks(self) -> int:
        if self._block_maxes is None:
            raise RuntimeError("Call build() before accessing n_blocks.")
        return self._block_maxes.shape[1]

    @property
    def block_maxes(self) -> np.ndarray:
        """The (n_terms, n_blocks) float64 maxima, copied to the host."""
        if self._block_maxes is None:
            raise RuntimeError("Call build() before accessing block_maxes.")
        return self._block_maxes.cpu().numpy()

    # -- vectorized pruning ------------------------------------------------

    def query_block_upper_bounds(self, term_indices, transform,
                                 p_max: float = 0.9) -> np.ndarray:
        """Per-block Bayesian upper bound for a query: the WAND bound of
        the sum of the query terms' block maxima (every document's score
        in a block is at most that sum). The rows are added in the
        query's term order, as numpy's ``sum(axis=0)`` adds them."""
        if self._block_maxes is None:
            raise RuntimeError("Call build() before pruning.")
        terms = torch.as_tensor(np.asarray(term_indices, dtype=np.int64),
                                device=self._device)
        rows = self._block_maxes[terms]
        score_ub = torch.zeros(rows.shape[1:], dtype=_F64,
                               device=self._device)
        for row in rows:
            score_ub = score_ub + row
        return np.asarray(transform.wand_upper_bound(score_ub, p_max))

    def prune_mask(self, term_indices, transform, threshold: float,
                   p_max: float = 0.9) -> np.ndarray:
        """Boolean keep-mask over blocks: bound >= threshold."""
        return self.query_block_upper_bounds(term_indices, transform, p_max) \
            >= threshold
