"""Multi-field BM25 search with weighted log-odds fusion of field signals.

Counterpart of ``bayesian_bm25_tpu/models/multi_field.py``: one
``BayesianBM25Scorer`` per field on one ``device`` (the card unless the
caller names another), field weights summing to 1, and fused dense
probabilities by the weighted log-odds conjunction. The fields' dense
probabilities stay on the device and are fused there
(``ops/fusion.log_odds_conjunction`` over the stacked fields, in
float64), with one copy of the fused matrix to the host. ``retrieve``
ranks the fused row on the host with the JAX package's numpy call, so
equal probabilities come back in its order.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import native
from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts
from bayesian_bm25_tpu_torch.models.scorer import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.ops import fusion as F
from bayesian_bm25_tpu_torch.ops.mathx import resolve_device


class MultiFieldScorer:
    """Fuses per-field Bayesian probabilities via log-odds conjunction.

    Parameters as in the JAX package, and ``device`` and ``prob_dtype``
    as ``BayesianBM25Scorer`` takes them (each field scorer gets both).
    """

    def __init__(self, fields: list[str], field_weights: dict | None = None,
                 alpha="auto", base_rate=None, k1: float = 1.2,
                 b: float = 0.75, method: str = "robertson",
                 score_scale: str = "classic", delta: float = 0.5, *,
                 device=None, prob_dtype: torch.dtype = torch.float32
                 ) -> None:
        if not fields:
            raise ValueError("fields must be a non-empty list")
        if len(fields) != len(set(fields)):
            raise ValueError("fields must not contain duplicates")

        self._device = resolve_device(device)
        self._prob_dtype = prob_dtype
        self._fields = list(fields)
        self._alpha = alpha
        self._base_rate = base_rate
        self._k1 = k1
        self._b = b
        self._method = method
        self._score_scale = score_scale
        self._delta = delta

        if field_weights is None:
            n = len(fields)
            self._field_weights = {f: 1.0 / n for f in fields}
        else:
            for f in fields:
                if f not in field_weights:
                    raise ValueError(f"field_weights missing key {f!r}")
            total = sum(field_weights[f] for f in fields)
            if abs(total - 1.0) > 1e-6:
                raise ValueError(f"field_weights must sum to 1, got {total}")
            self._field_weights = {f: field_weights[f] for f in fields}

        self._scorers: dict[str, BayesianBM25Scorer] = {}
        self._num_docs = 0

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_docs(self) -> int:
        return self._num_docs

    @property
    def fields(self) -> list[str]:
        return list(self._fields)

    @property
    def field_weights(self) -> dict:
        return dict(self._field_weights)

    @property
    def scorers(self) -> dict:
        """Per-field scorer instances (populated by index())."""
        return dict(self._scorers)

    def _new_scorer(self) -> BayesianBM25Scorer:
        return BayesianBM25Scorer(
            k1=self._k1, b=self._b, method=self._method,
            base_rate=self._base_rate, score_scale=self._score_scale,
            delta=self._delta, device=self._device,
            prob_dtype=self._prob_dtype)

    def index(self, documents: list[dict], show_progress: bool = True) -> None:
        """Build one index per field; every document must have all fields."""
        for i, doc in enumerate(documents):
            for field in self._fields:
                if field not in doc:
                    raise ValueError(f"Document {i} missing field {field!r}")
        self._scorers = {}
        for field in self._fields:
            scorer = self._new_scorer()
            scorer.index([doc[field] for doc in documents],
                         show_progress=show_progress)
            self._scorers[field] = scorer
        self._num_docs = len(documents)

    def index_jsonl(self, path: str, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> list[str]:
        """Index a BEIR corpus.jsonl as title and body fields (requires
        ``fields == ["title", "body"]``): the C++ loader of
        ``engine/native.py`` supplies both fields, and each field
        scorer indexes its texts through ``index_texts``. Without the
        library a Python json pass does the same (counted in
        ``native.fallbacks["jsonl"]``). Returns the corpus doc ids in
        index order."""
        if self._fields != ["title", "body"]:
            raise ValueError(
                "index_jsonl requires fields=['title', 'body'], got "
                f"{self._fields}")
        try:
            loaded = native.load_jsonl_native(path)
        except (ImportError, OSError):
            loaded = None
        if loaded is None:
            native.fallbacks["jsonl"] += 1
            ids, titles, texts = [], [], []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    did = str(row.get("_id", ""))
                    if not did:
                        continue
                    ids.append(did)
                    titles.append(row.get("title", "") or "")
                    texts.append(row.get("text", ""))
        else:
            ids, titles, texts = loaded
        self._scorers = {}
        for field, field_texts in (("title", titles), ("body", texts)):
            scorer = self._new_scorer()
            scorer.index_texts(field_texts, lowercase=lowercase,
                               remove_stopwords=remove_stopwords, stem=stem)
            self._scorers[field] = scorer
        self._num_docs = len(ids)
        return list(ids)

    def delete_documents(self, doc_ids) -> None:
        """Tombstone documents across every field scorer: fused
        probabilities become exactly 0 and the docs sort behind every
        live candidate (ids stay stable; ``restore_documents`` undoes)."""
        if not self._scorers:
            raise RuntimeError("Call index() before delete_documents().")
        for f in self._fields:
            self._scorers[f].delete_documents(doc_ids)

    def restore_documents(self, doc_ids) -> None:
        """Undo :meth:`delete_documents` across every field scorer."""
        if not self._scorers:
            raise RuntimeError("Call index() before restore_documents().")
        for f in self._fields:
            self._scorers[f].restore_documents(doc_ids)

    @property
    def deleted_mask(self):
        """Tombstone mask (None when nothing is deleted)."""
        if not self._scorers:
            return None
        return self._scorers[self._fields[0]].deleted_mask

    def _fused_device(self, query_tokens_batch) -> torch.Tensor:
        """Fused (nq, num_docs) float64 probabilities on the device, 0 at
        tombstoned docs."""
        stack = torch.stack([
            self._scorers[f]._dense_probs_device(query_tokens_batch)
            for f in self._fields], dim=-1).to(torch.float64)
        weights = torch.tensor([self._field_weights[f] for f in self._fields],
                               dtype=torch.float64, device=stack.device)
        fused = F.log_odds_conjunction(
            stack, alpha=F.resolve_alpha(self._alpha, default=0.5),
            weights=weights)
        mask = self.deleted_mask
        if mask is not None:
            fused[:, torch.from_numpy(mask).to(fused.device)] = 0.0
        return fused

    def get_probabilities(self, query_tokens: list[str]) -> np.ndarray:
        """Fused probabilities for all documents (weighted Log-OP)."""
        if not self._scorers:
            raise RuntimeError("Call index() before get_probabilities().")
        return self._fused_device([query_tokens])[0].cpu().numpy()

    def get_probabilities_batch(self, query_tokens_batch: list) -> np.ndarray:
        """Fused probabilities for a query batch: (nq, num_docs), one
        device pass per field and one fusion on the device."""
        if not self._scorers:
            raise RuntimeError("Call index() before get_probabilities_batch().")
        return self._fused_device(query_tokens_batch).cpu().numpy()

    def retrieve(self, query_tokens: list[str], k: int = 10):
        """Top-k by fused probability (descending); tombstoned docs
        carry probability 0 and rank behind every live candidate."""
        probs = self.get_probabilities(query_tokens)
        k = min(k, len(probs))
        top = np.argsort(probs)[::-1][:k]
        return top, probs[top]

    def retrieve_texts(self, query_text: str, k: int = 10):
        """Text-in retrieve: tokenize with the field scorers' options
        (set by ``index_jsonl``/``index_texts``) then fuse and rank."""
        if not self._scorers:
            raise RuntimeError("Call index() before retrieve_texts().")
        opts = self._scorers[self._fields[0]]._tok_opts
        return self.retrieve(tokenize_texts([query_text], **opts)[0], k=k)

    def add_documents(self, new_documents: list[dict],
                      show_progress: bool = True) -> None:
        """Append documents to every field scorer (IDF changes)."""
        if not self._scorers:
            raise RuntimeError("Call index() before add_documents().")
        for i, doc in enumerate(new_documents):
            for field in self._fields:
                if field not in doc:
                    raise ValueError(f"New document {i} missing field {field!r}")
        for field in self._fields:
            self._scorers[field].add_documents(
                [doc[field] for doc in new_documents],
                show_progress=show_progress,
            )
        self._num_docs += len(new_documents)
