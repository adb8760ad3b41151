"""BayesianBM25Scorer on PyTorch: index, calibrate and retrieve with
calibrated probabilities on one device.

Counterpart of ``bayesian_bm25_tpu/models/scorer.py`` for the slices the
port carries: the constructor and its validation, ``index`` (split or
doc-major index, pseudo-query calibration of alpha and beta, base-rate
estimation), the raw-text entry points (``index_texts``,
``index_jsonl``, ``retrieve_texts``: tokenized, counted and encoded by
the C++ library of ``engine/native.py`` where it builds),
``retrieve``, ``retrieve_many`` and ``retrieve_stream``,
``get_scores(_batch)``, ``get_probabilities(_batch)``,
``retrieve_thresholded``, and the document lifecycle
(``delete_documents``, ``restore_documents``, ``add_documents``).
Retrieval takes one of three paths: the split index's sparse-candidate
merge (its frequent-term product and block maxima in one K4 launch
on the card, ``cuda_matmul.fused_route``), its dense compare tail when the rare
postings exceed their budget (``retrieve_topk_split``), or the doc-major
compare (``engine/scoring.py``) for vocabularies of at most 256 terms.
``retrieve(explain=True)`` (and ``retrieve_texts(explain=True)``)
returns a ``RetrievalResult`` whose traces are computed for the whole
batch in one pass on the device (``utils/debug.bm25_trace_rows``). The
device is explicit: ``device="cuda"`` by default, the CPU only when the
caller asks for it; the transform lives on the same device.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import cuda_matmul
from bayesian_bm25_tpu_torch.engine import index as eidx
from bayesian_bm25_tpu_torch.engine import native, scoring
from bayesian_bm25_tpu_torch.engine import split_index as sidx
from bayesian_bm25_tpu_torch.engine.index import to_device
from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_py, tokenize_texts
from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform)
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.ops.mathx import resolve_device
from bayesian_bm25_tpu_torch.utils import spans

_VALID_BASE_RATE_METHODS = ("percentile", "mixture", "elbow")
_MATMUL_PRECISIONS = ("highest", "high", "default")


@dataclass
class RetrievalResult:
    """Result of ``retrieve(explain=True)``: ids, probabilities, and a
    BM25SignalTrace per (query, rank), None where the score is 0."""

    doc_ids: np.ndarray
    probabilities: np.ndarray
    explanations: list | None


class _LazyTokens:
    """Sequence view over raw texts that tokenizes a document when it is
    first read.

    ``index_texts`` keeps no token lists: only the documents actually
    read (the pseudo-query sample, whose tokens arrive in ``known``,
    and the recalibration samples of ``add_documents``) are tokenized.
    """

    def __init__(self, texts, *, lowercase, remove_stopwords, stem,
                 known=None):
        self._texts = texts
        self._opts = dict(lowercase=lowercase,
                          remove_stopwords=remove_stopwords, stem=stem)
        self._cache = dict(known or {})

    @property
    def n_tokenized(self) -> int:
        """Documents tokenized so far (the known ones included)."""
        return len(self._cache)

    def __len__(self):
        return len(self._texts)

    def __getitem__(self, i):
        i = int(i)
        if i not in self._cache:
            self._cache[i] = tokenize_py(self._texts[i], **self._opts)
        return self._cache[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __add__(self, other):
        # Chained, not materialized: listing the view would tokenize the
        # whole corpus.
        return _ChainedTokens([self, list(other)])


class _ChainedTokens:
    """Concatenated view over token sequences (lists or _LazyTokens)
    with per-doc random access and no materialization."""

    def __init__(self, parts):
        self._parts = []
        for p in parts:
            if isinstance(p, _ChainedTokens):
                self._parts.extend(p._parts)
            else:
                self._parts.append(p)
        self._offsets = np.cumsum([0] + [len(p) for p in self._parts])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        i = int(i)
        if i < 0:
            i += len(self)
        part = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self._parts[part][i - int(self._offsets[part])]

    def __iter__(self):
        for p in self._parts:
            yield from p

    def __add__(self, other):
        return _ChainedTokens(self._parts + [list(other)])


class BayesianBM25Scorer:
    """BM25 scorer that returns Bayesian-calibrated probabilities.

    Parameters as in the JAX package. ``matmul_precision`` only selects
    the impact storage when ``impact_storage`` is None ("high" -> the
    hilo bf16 pair, otherwise f32): every float32 product here runs in
    full float32. ``device`` holds the index and runs retrieval;
    ``prob_dtype`` is the dtype the Bayesian transform computes in
    (probabilities are returned as float64 arrays either way).
    """

    _SPLIT_BUDGET_BYTES = 4 << 30
    _SPLIT_INT8_MIN_DOCS = 1 << 18
    _SCORES_BUDGET_BYTES = 4 << 30

    def __init__(
        self,
        k1: float = 1.2,
        b: float = 0.75,
        method: str = "robertson",
        alpha: float | None = None,
        beta: float | None = None,
        base_rate: float | str | None = None,
        base_rate_method: str = "percentile",
        matmul_precision: str = "high",
        impact_storage: str | None = None,
        score_scale: str = "classic",
        delta: float = eidx.DEFAULT_DELTA,
        *,
        device="cuda",
        prob_dtype: torch.dtype = torch.float32,
    ) -> None:
        if base_rate_method not in _VALID_BASE_RATE_METHODS:
            raise ValueError(
                f"base_rate_method must be one of {_VALID_BASE_RATE_METHODS}, "
                f"got {base_rate_method!r}"
            )
        if method not in eidx.VALID_METHODS:
            raise ValueError(
                f"method must be one of {eidx.VALID_METHODS}, got {method!r}"
            )
        if score_scale not in eidx.VALID_SCORE_SCALES:
            raise ValueError(
                f"score_scale must be one of {eidx.VALID_SCORE_SCALES}, "
                f"got {score_scale!r}"
            )
        if not delta > 0:
            raise ValueError(f"delta must be positive, got {delta!r}")
        if matmul_precision not in _MATMUL_PRECISIONS:
            raise ValueError(
                f"matmul_precision must be one of "
                f"{_MATMUL_PRECISIONS}, got {matmul_precision!r}"
            )
        if impact_storage not in (None, "f32", "hilo", "bf16", "int8"):
            raise ValueError(
                "impact_storage must be one of (None, 'f32', 'hilo', "
                f"'bf16', 'int8'), got {impact_storage!r}"
            )
        if prob_dtype not in (torch.float32, torch.float64):
            raise ValueError(
                f"prob_dtype must be float32 or float64, got {prob_dtype}")
        self._device = resolve_device(device)
        if self._device.type == "cuda":
            # float32 products stay float32 on the card, as JAX's
            # preferred_element_type=f32 does; TF32 keeps ~3 digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._prob_dtype = prob_dtype
        self._impact_storage = impact_storage
        self._matmul_precision_name = matmul_precision
        self._k1 = k1
        self._b = b
        self._method = method
        self._score_scale = score_scale
        self._delta = delta
        self._user_alpha = alpha
        self._user_beta = beta
        self._user_base_rate = base_rate
        self._base_rate_method = base_rate_method
        self._index: eidx.BM25Index | None = None
        self._split: sidx.SplitBM25Index | None = None
        self._transform: BayesianProbabilityTransform | None = None
        self._corpus_tokens = None
        # Tokenizer options of index_texts: retrieve_texts must tokenize
        # queries the same way, or the vocabulary lookups miss.
        self._tok_opts = dict(lowercase=True, remove_stopwords=True,
                              stem=True)
        # Tombstones (host bool, length num_docs, True = deleted): excluded
        # from every query path without a rebuild; None until a delete.
        self._deleted: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _index_device(self) -> torch.device:
        """Where the index tables are built: the scorer's device (the
        sharded scorer builds on the host and places shards)."""
        return self._device

    def _doc_pad_multiple(self) -> int:
        """Doc-axis padding multiple of the initial build and of every
        append (the sharded scorer's divides its mesh)."""
        return 2048

    def _finalize_index(self) -> None:
        """Placement hook, called whenever the index or its split is
        (re)built (the sharded scorer places its shards here)."""

    def _doc_lengths_device(self) -> torch.Tensor:
        """The (D_pad,) float32 doc lengths on the scorer's device."""
        return self._index.doc_lengths

    def _split_plan(self, D_pad: int, n_terms: int):
        """(storage, K) of the split index for a corpus padded to
        ``D_pad`` documents with ``n_terms`` terms, or None where the
        doc-major compare serves it: small vocabularies, or a budget
        below one 128-column block."""
        if self._impact_storage is not None:
            storage = self._impact_storage
        elif D_pad >= self._SPLIT_INT8_MIN_DOCS:
            storage = "int8"
        else:
            storage = "hilo" if self._matmul_precision_name == "high" else "f32"
        # Bytes per K column: impact (int8 pair 2, hilo 4, bf16 2,
        # f32 4) + bf16 presence (2).
        impact_bytes = {"int8": 2, "hilo": 4, "bf16": 2}.get(storage, 4)
        k_budget = self._SPLIT_BUDGET_BYTES // max(D_pad * (impact_bytes + 2),
                                                   1)
        K = min(2048, (k_budget // 128) * 128,
                ((max(n_terms, 1) + 127) // 128) * 128)
        return (storage, int(K)) if K >= 128 and n_terms > 256 else None

    def _maybe_build_split(self) -> None:
        idx = self._index
        plan = self._split_plan(idx.term_ids_host.shape[0], idx.n_terms)
        self._split = None if plan is None else sidx.build_split_index(
            idx, n_frequent=plan[1], storage=plan[0],
            device=self._index_device)

    def _count_split(self, sp) -> None:
        """The split index's shape on the ``index.split`` span: K, the
        rare rows R and R2 (0 without a tier-2 rectangle) and the
        entries of each postings rectangle, sentinel rows included."""
        s = self._split
        if s is None:
            return
        sp.add("K", s.n_frequent)
        for tier, ids in (("", s.post_doc_ids), ("2", s.post2_doc_ids)):
            sp.add("R" + tier, 0 if ids is None else ids.shape[0] - 1)
            sp.add("entries" + tier, 0 if ids is None else ids.numel())

    # -- properties ----------------------------------------------------------

    @property
    def num_docs(self) -> int:
        if self._index is None:
            raise RuntimeError("Call index() before accessing num_docs.")
        return self._index.n_docs

    @property
    def doc_lengths(self) -> np.ndarray:
        if self._index is None:
            raise RuntimeError("Call index() before accessing doc_lengths.")
        return self._index.doc_lengths_host[: self._index.n_docs].astype(
            np.float32).astype(np.float64)

    @property
    def avgdl(self) -> float:
        if self._index is None:
            raise RuntimeError("Call index() before accessing avgdl.")
        return self._index.avgdl

    @property
    def bm25_index(self) -> eidx.BM25Index | None:
        """The underlying index (None before index())."""
        return self._index

    @property
    def base_rate(self) -> float | None:
        if self._transform is None:
            return None
        return self._transform.base_rate

    @property
    def transform(self) -> BayesianProbabilityTransform | None:
        return self._transform

    # -- indexing ------------------------------------------------------------

    def index(self, corpus_tokens: list[list[str]],
              show_progress: bool = True) -> None:
        """Build the index on the device and auto-calibrate the transform
        from <=50 sampled 5-token pseudo-queries (seed 42). Traced as
        ``index`` with ``index.build``, ``index.split`` and
        ``index.calibrate`` under it, each ended by a device
        synchronize while tracing is on."""
        del show_progress
        self._deleted = None  # fresh index, fresh lifecycle
        self._corpus_tokens = corpus_tokens
        with spans.span("index", sync=True):
            with spans.span("index.build", sync=True):
                self._index = eidx.build_index(
                    corpus_tokens, k1=self._k1, b=self._b,
                    method=self._method,
                    doc_pad_multiple=self._doc_pad_multiple(),
                    score_scale=self._score_scale, delta=self._delta,
                    device=self._index_device)
            with spans.span("index.split", sync=True) as sp:
                self._maybe_build_split()
                self._count_split(sp)
            with spans.span("index.calibrate", sync=True):
                self._finalize_index()
                self._calibrate()

    def index_texts(self, texts, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> None:
        """Index raw texts: one C++ pass tokenizes, builds the vocabulary
        and counts (``engine/index.build_index_from_texts``), then the
        index is calibrated as ``index`` does. No token lists are kept:
        the <= 50 pseudo-query documents are tokenized natively and the
        rest only when read (``add_documents``'s recalibration sample).
        ``retrieve_texts`` tokenizes queries with the same options."""
        self._deleted = None  # fresh index, fresh lifecycle
        self._split = None    # free the old device index first
        self._tok_opts = dict(lowercase=lowercase,
                              remove_stopwords=remove_stopwords, stem=stem)
        idx, corpus_tokens = eidx.build_index_from_texts(
            texts, k1=self._k1, b=self._b, method=self._method,
            return_tokens=False, score_scale=self._score_scale,
            delta=self._delta, device=self._index_device, **self._tok_opts)
        self._index = idx
        if corpus_tokens is None:
            # The native path: tokenize only the seed-42 sample that
            # calibration reads (_sample_pseudo_query_scores's draw).
            rng = np.random.default_rng(42)
            sample = rng.choice(len(texts), size=min(len(texts), 50),
                                replace=False)
            sampled = tokenize_texts([texts[i] for i in sample],
                                     **self._tok_opts)
            corpus_tokens = _LazyTokens(
                texts, **self._tok_opts,
                known=dict(zip((int(i) for i in sample), sampled)))
        self._corpus_tokens = corpus_tokens
        self._maybe_build_split()
        self._finalize_index()
        self._calibrate()

    def index_jsonl(self, path: str, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> list[str]:
        """Index a BEIR-format corpus.jsonl: the C++ loader parses it
        ("_id", "title", "text" at the top level; escapes and \\uXXXX
        decoded; lines without an "_id" dropped) and hands the bodies to
        ``index_texts`` as one blob. Returns the document ids in index
        order, so retrieved row indices map back to dataset ids. Without
        the library, a Python json pass does the same (counted in
        ``native.fallbacks["jsonl"]``)."""
        try:
            loaded = native.load_jsonl_native(path)
        except (ImportError, OSError):
            loaded = None
        if loaded is None:
            native.fallbacks["jsonl"] += 1
            ids: list[str] = []
            texts: list[str] = []
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    did = str(row.get("_id", ""))
                    if not did:
                        continue
                    ids.append(did)
                    texts.append(row.get("text", ""))
        else:
            ids, _titles, texts = loaded
        self.index_texts(texts, lowercase=lowercase,
                         remove_stopwords=remove_stopwords, stem=stem)
        return ids

    def _calibrate(self) -> None:
        """Fit alpha, beta and the base rate on the current corpus with
        the seed-42 pseudo-query protocol (tombstoned docs score 0 and
        drop out)."""
        per_query_scores = self._sample_pseudo_query_scores(
            self._corpus_tokens)
        alpha, beta = self._estimate_parameters(per_query_scores)
        base_rate: float | None = None
        if self._user_base_rate == "auto":
            base_rate = self._estimate_base_rate(per_query_scores,
                                                 len(self._corpus_tokens))
        elif isinstance(self._user_base_rate, (int, float)):
            base_rate = float(self._user_base_rate)
        self._transform = BayesianProbabilityTransform(
            alpha=alpha, beta=beta, base_rate=base_rate, device=self._device)

    def add_documents(self, new_corpus_tokens,
                      show_progress: bool = True) -> None:
        """Append documents: only the new ones are counted
        (``engine/index.append_to_index``, bit-identical to a full
        rebuild), the split index is rebuilt from the grown table, and
        alpha, beta and the base rate are re-estimated with the seed-42
        protocol, so the result equals ``index(old + new)``. Ids of
        existing documents and their tombstones are kept; new documents
        are alive."""
        del show_progress
        if self._corpus_tokens is None:
            raise RuntimeError("Call index() before add_documents().")
        new_list = list(new_corpus_tokens)
        # The split index (and K4's column-major copy of its matrices) is
        # rebuilt below from the grown table; the old one goes first.
        self._split = None
        self._index = eidx.append_to_index(
            self._index, new_list,
            doc_pad_multiple=self._doc_pad_multiple(),
            device=self._index_device)
        old = self._corpus_tokens
        # A text-indexed corpus stays a lazy view: chained, not listed.
        self._corpus_tokens = (
            old + new_list if isinstance(old, (_LazyTokens, _ChainedTokens))
            else list(old) + new_list)
        if self._deleted is not None:
            self._deleted = np.concatenate(
                [self._deleted, np.zeros(len(new_list), dtype=bool)])
        self._maybe_build_split()
        self._finalize_index()
        self._calibrate()

    def _sample_pseudo_query_scores(self, corpus_tokens) -> list[np.ndarray]:
        """<=50 sampled docs as 5-token pseudo-queries -> per-query
        nonzero score arrays, from one batched scoring call."""
        n = len(corpus_tokens)
        rng = np.random.default_rng(42)
        sample_indices = rng.choice(n, size=min(n, 50), replace=False)
        queries = [corpus_tokens[i][:5] for i in sample_indices
                   if corpus_tokens[i]]
        if not queries:
            return []
        out = []
        for row in self._scores_internal(queries):
            nz = row[row > 0]
            if len(nz) > 0:
                out.append(nz.astype(np.float64))
        return out

    def _estimate_parameters(self, per_query_scores) -> tuple[float, float]:
        """beta = median(pooled nonzero scores); alpha = 1 / std.
        User-supplied values override."""
        if self._user_alpha is not None and self._user_beta is not None:
            return self._user_alpha, self._user_beta
        if not per_query_scores:
            return (self._user_alpha or 1.0, self._user_beta or 0.0)
        pooled = np.concatenate(per_query_scores)
        est_beta = float(np.median(pooled))
        std = float(np.std(pooled))
        est_alpha = 1.0 / std if std > 0 else 1.0
        return (
            self._user_alpha if self._user_alpha is not None else est_alpha,
            self._user_beta if self._user_beta is not None else est_beta,
        )

    def _estimate_base_rate(self, per_query_scores, n_docs: int) -> float:
        if not per_query_scores:
            return 1e-6
        method = self._base_rate_method
        if method == "percentile":
            return self._base_rate_percentile(per_query_scores, n_docs)
        if method == "mixture":
            return self._base_rate_mixture(per_query_scores)
        return self._base_rate_elbow(per_query_scores)

    @staticmethod
    def _base_rate_percentile(per_query_scores, n_docs: int) -> float:
        """Mean fraction of docs at/above each query's 95th percentile."""
        ratios = []
        for s in per_query_scores:
            thr = float(np.percentile(s, 95))
            ratios.append(float(np.sum(s >= thr)) / n_docs)
        return float(np.clip(np.mean(ratios), 1e-6, 0.5))

    @staticmethod
    def _base_rate_mixture(per_query_scores) -> float:
        """2-component Gaussian EM on pooled scores; the higher-mean
        component's mixing weight is the base rate."""
        x = np.concatenate(per_query_scores)
        if len(x) < 2:
            return 1e-6
        med = float(np.median(x))
        lo = x <= med
        hi = ~lo
        mu0 = float(np.mean(x[lo])) if lo.any() else med - 1.0
        mu1 = float(np.mean(x[hi])) if hi.any() else med + 1.0
        var0 = max(float(np.var(x[lo])) if lo.any() else 1.0, 1e-8)
        var1 = max(float(np.var(x[hi])) if hi.any() else 1.0, 1e-8)
        pi1 = 0.5
        for _ in range(20):
            s0, s1 = np.sqrt(var0), np.sqrt(var1)
            lp0 = -0.5 * ((x - mu0) / s0) ** 2 - np.log(s0)
            lp1 = -0.5 * ((x - mu1) / s1) ** 2 - np.log(s1)
            lw0 = np.log(max(1.0 - pi1, 1e-10)) + lp0
            lw1 = np.log(max(pi1, 1e-10)) + lp1
            gamma = np.exp(lw1 - np.logaddexp(lw0, lw1))
            n1 = float(np.sum(gamma))
            n0 = float(np.sum(1.0 - gamma))
            if n0 < 1e-8 or n1 < 1e-8:
                break
            mu0 = float(np.sum((1 - gamma) * x) / n0)
            mu1 = float(np.sum(gamma * x) / n1)
            var0 = max(float(np.sum((1 - gamma) * (x - mu0) ** 2) / n0), 1e-8)
            var1 = max(float(np.sum(gamma * (x - mu1) ** 2) / n1), 1e-8)
            pi1 = n1 / len(x)
        rate = pi1 if mu1 >= mu0 else 1.0 - pi1
        return float(np.clip(rate, 1e-6, 0.5))

    @staticmethod
    def _base_rate_elbow(per_query_scores) -> float:
        """Max-perpendicular-distance knee of the sorted score curve; the
        fraction of scores above the knee."""
        x = np.sort(np.concatenate(per_query_scores))[::-1]
        n = len(x)
        if n < 3:
            return 1e-6
        dx = float(n - 1)
        dy = float(x[-1] - x[0])
        line_len = np.sqrt(dx * dx + dy * dy)
        if line_len < 1e-12:
            return 1e-6
        t = np.arange(n, dtype=np.float64)
        dist = np.abs(dy * t - dx * (x - x[0])) / line_len
        knee = int(np.argmax(dist))
        return float(np.clip(max(1, knee) / n, 1e-6, 0.5))

    # -- querying --------------------------------------------------------------

    def _encode(self, query_tokens_batch):
        """Queries -> (qids, qcnt) host arrays for the doc-major table,
        through the index's native encoder where the library builds."""
        return eidx.encode_queries(
            query_tokens_batch, self._index.vocab,
            native_encoder=eidx.get_native_encoder(self._index))

    def _dense_scores_tfs_device(self, query_tokens_batch):
        """Dense (scores, tfs) on the device, sliced to num_docs: the
        split index's matmul + compare tail, or the doc-major compare."""
        idx = self._index
        nq = len(query_tokens_batch)
        # An empty batch runs as one empty query, sliced off below.
        qs = list(query_tokens_batch) or [[]]
        if self._split is not None:
            enc = sidx.encode_queries_split(qs, self._split)
            scores, tfs = sidx.score_all_split(self._split, *enc)
        else:
            qids, qcnt = self._encode(qs)
            scores, tfs = scoring.score_all(
                idx.term_ids, idx.weights, to_device(qids, self._device),
                to_device(qcnt, self._device))
        return scores[:nq, : idx.n_docs], tfs[:nq, : idx.n_docs]

    def _scores_internal(self, query_tokens_batch) -> np.ndarray:
        """Engine scores (nq, num_docs) as float64 host arrays, without
        the bm25l/bm25+ shift: the quantity calibration and every
        probability path consume."""
        if self._index is None:
            raise RuntimeError("Call index() before scoring.")
        scores, _ = self._dense_scores_tfs_device(query_tokens_batch)
        return self._apply_deleted(scores.cpu().numpy().astype(np.float64))

    def _apply_deleted(self, dense: np.ndarray) -> np.ndarray:
        """Zero tombstoned docs' columns of a dense (nq, num_docs) host
        array, in place."""
        if self._deleted is not None:
            dense[:, self._deleted] = 0.0
        return dense

    def get_scores_batch(self, query_tokens_batch: list[list[str]]
                         ) -> np.ndarray:
        """Raw BM25 scores for every document, batched: (nq, num_docs)
        float64, exactly 0 for tombstoned docs. For bm25l/bm25+ the
        per-query nonoccurrence shift is included (score-level parity
        with bm25s; rank-neutral)."""
        out = self._scores_internal(query_tokens_batch)
        shift = eidx.query_score_shift(self._index, query_tokens_batch)
        if shift.any():
            out = self._apply_deleted(out + shift[:, None])
        return out

    def get_scores(self, query_tokens: list[str]) -> np.ndarray:
        """Raw BM25 scores for one query over all docs."""
        return self.get_scores_batch([query_tokens])[0]

    def _dense_probs_device(self, query_tokens_batch) -> torch.Tensor:
        """Dense (nq, num_docs) float32 probabilities on the device."""
        if self._transform is None:
            raise RuntimeError("Call index() before get_probabilities().")
        idx = self._index
        t = self._transform
        dev = self._device
        nq = len(query_tokens_batch)
        qs = list(query_tokens_batch) or [[]]
        common = dict(n_docs=idx.n_docs,
                      prior_free=t._training_mode == "prior_free")
        if self._split is not None:
            s = self._split
            enc = sidx.encode_queries_split(qs, s)
            probs = sidx.probabilities_all_split(
                s.dense_impact, s.dense_presence, s.tail_term_ids,
                s.tail_weights, idx.doc_lengths, idx.avgdl,
                *(to_device(a, dev) for a in enc),
                t.alpha, t.beta, t.base_rate, **common,
                overflow=sidx._overflow_of(s), impact_lo=s.dense_impact_lo,
                impact_scale=s.impact_scale,
                q_int8_ok=sidx._q_int8_ok(s, enc[1]),
                prob_dtype=self._prob_dtype)
        else:
            qids, qcnt = self._encode(qs)
            probs, _, _ = scoring.probabilities_all(
                idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
                to_device(qids, dev), to_device(qcnt, dev),
                t.alpha, t.beta, t.base_rate, **common,
                prob_dtype=self._prob_dtype)
        return probs[:nq]

    def get_probabilities_batch(self, query_tokens_batch: list[list[str]]
                                ) -> np.ndarray:
        """Dense calibrated probabilities, batched: (nq, num_docs)
        float64, exactly 0 for tombstoned docs."""
        return self._apply_deleted(
            self._dense_probs_device(query_tokens_batch).cpu().numpy(
            ).astype(np.float64))

    def get_probabilities(self, query_tokens: list[str]) -> np.ndarray:
        """Calibrated probability for every document (dense, one query)."""
        return self.get_probabilities_batch([query_tokens])[0]

    def retrieve_thresholded(self, query_tokens: list[list[str]],
                             threshold: float, k: int = 10, doc_mask=None):
        """The k most probable documents with P >= threshold, per query.

        The passing set is complete: a score-ordered filter could miss
        passing docs, since the prior depends on tf and doc length. The
        certified WAND bound turns the threshold into a score prefilter
        (``ops/transform.wand_score_threshold``); when few candidates
        survive, only they are transformed (output-identical), otherwise
        the score pass is finished densely; a threshold that prunes
        nothing takes one dense probability pass. ``doc_mask`` (as in
        ``retrieve``) and tombstones exclude docs from the passing count
        and the returned set. Batches are chunked at a quarter of the retrieve
        chunk (two (nq, D) matrices are live).

        Returns (doc_ids int32 (nq, k), probabilities float64 (nq, k),
        n_passing int (nq,)): -1 / 0.0 beyond each query's passing set;
        n_passing counts every doc at or above the threshold.
        """
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve_thresholded().")
        doc_mask = self._device_mask(doc_mask)
        chunk = max(self._auto_batch_size() // 4, 128)
        parts = [self._thresholded_launch(p, threshold, k, doc_mask)
                 for p in _chunks(query_tokens, chunk)]
        ids = torch.cat([p[0] for p in parts]).cpu().numpy()
        probs = torch.cat([p[1] for p in parts]).cpu().numpy()
        n_passing = torch.cat([p[2] for p in parts]).cpu().numpy()
        return ids, probs.astype(np.float64), n_passing.astype(int)

    def _host_mask(self, doc_mask):
        """A caller's ``doc_mask`` (length num_docs, False = excluded),
        checked and combined with the tombstones, as a host bool array;
        None when neither excludes anything."""
        if doc_mask is not None:
            doc_mask = np.asarray(doc_mask, dtype=bool)
            n = self._index.n_docs
            if doc_mask.shape != (n,):
                raise ValueError(
                    f"doc_mask must have shape ({n},), got {doc_mask.shape}")
        return self._combine_deleted(doc_mask)

    def _device_mask(self, doc_mask):
        """:meth:`_host_mask` copied to the device (or None)."""
        doc_mask = self._host_mask(doc_mask)
        return None if doc_mask is None else to_device(doc_mask,
                                                       self._device)

    # -- document lifecycle ----------------------------------------------------

    def _check_ids(self, doc_ids) -> np.ndarray:
        ids = np.asarray(list(doc_ids), dtype=np.int64)
        n = self._index.n_docs
        if ids.size and (ids.min() < 0 or ids.max() >= n):
            raise ValueError(
                f"doc ids must be in [0, {n}), got range "
                f"[{ids.min()}, {ids.max()}]")
        return ids

    def delete_documents(self, doc_ids) -> None:
        """Tombstone documents: excluded from every query path (retrieve,
        thresholded, scores, probabilities) without rebuilding the index.
        Idempotent; ids stay stable and ``num_docs`` keeps counting
        tombstoned docs."""
        if self._index is None:
            raise RuntimeError("Call index() before delete_documents().")
        ids = self._check_ids(doc_ids)
        if self._deleted is None:
            self._deleted = np.zeros(self._index.n_docs, dtype=bool)
        self._deleted[ids] = True

    def restore_documents(self, doc_ids) -> None:
        """Undo :meth:`delete_documents` for the given ids."""
        if self._deleted is None:
            return
        self._deleted[self._check_ids(doc_ids)] = False
        if not self._deleted.any():
            self._deleted = None

    @property
    def deleted_mask(self) -> np.ndarray | None:
        """Host bool mask of tombstoned docs (None when nothing is
        deleted)."""
        return None if self._deleted is None else self._deleted.copy()

    def _combine_deleted(self, doc_mask):
        """AND the alive mask into a host bool caller mask (or None)."""
        if self._deleted is None:
            return doc_mask
        alive = ~self._deleted
        return alive if doc_mask is None else (doc_mask & alive)

    def _thresholded_launch(self, query_tokens, threshold, k, doc_mask):
        """One chunk of :meth:`retrieve_thresholded` on the device:
        (ids, probs, n_passing) tensors."""
        nq = len(query_tokens)
        query_tokens = list(query_tokens) or [[]]
        idx = self._index
        t = self._transform
        k_eff = min(k, idx.n_docs)
        prior_free = t._training_mode == "prior_free"
        dl = self._doc_lengths_device()[: idx.n_docs]
        common = dict(prior_free=prior_free, prob_dtype=self._prob_dtype)
        s_min = T.wand_score_threshold(
            float(threshold), t.alpha, t.beta, t.base_rate,
            p_max=0.5 if prior_free else 0.9)
        if np.isfinite(s_min) or s_min > 0:
            scores, tfs = self._dense_scores_tfs_device(query_tokens)
            if doc_mask is not None:
                scores = torch.where(doc_mask[None, :], scores,
                                     float("-inf"))
            counts = scoring.count_above(scores, s_min)
            c_max = int(counts.max()) if counts.numel() else 0
            C = sidx._pow2_bucket(max(c_max, k_eff), 16)
            # Candidate selection wins only while C stays tiny; past
            # that, finish densely on the same score pass. k = 0 selects
            # nothing: the dense finish counts the passing docs with no
            # top-k (the counts are the same on either branch).
            if k_eff and C <= max(32, 2 * k_eff) and C <= idx.n_docs // 2:
                out = scoring.thresholded_topk_pruned(
                    scores, tfs, dl, idx.avgdl, float(threshold), s_min,
                    k_eff, min(C, idx.n_docs), t.alpha, t.beta,
                    t.base_rate, **common)
            else:
                out = scoring.thresholded_topk_from_scores(
                    scores, tfs, dl, idx.avgdl, float(threshold), k_eff,
                    t.alpha, t.beta, t.base_rate, **common)
        else:
            # The threshold prunes nothing: one dense probability pass.
            dense = self._dense_probs_device(query_tokens)
            if doc_mask is not None:
                dense = dense * doc_mask[None, :]
            out = scoring.thresholded_topk(dense, float(threshold), k_eff)
        return tuple(a[:nq] for a in out)

    def _auto_batch_size(self) -> int:
        """Largest power-of-two query chunk whose (nq, D_pad) f32 score
        matrix fits _SCORES_BUDGET_BYTES (floor 256, cap 8192)."""
        if self._index is None:
            return 8192
        D_pad = self._index.term_ids_host.shape[0]
        nq = self._SCORES_BUDGET_BYTES // max(D_pad * 4, 1)
        b = 256
        while b * 2 <= nq and b < 8192:
            b *= 2
        return b

    def retrieve(self, query_tokens: list[list[str]], k: int = 10,
                 show_progress: bool = False, explain: bool = False,
                 approx: bool = False, doc_mask=None, coarse: bool = False):
        """Top-k by BM25 score with calibrated probabilities: returns
        (doc_ids int32 (nq, k), probabilities float64 (nq, k)), or with
        ``explain=True`` a RetrievalResult holding the same two arrays
        and a BM25SignalTrace per (query, rank), None where the score is
        0. Oversized batches are split into chunks that are all launched
        before one device-to-host copy. ``doc_mask`` (length num_docs,
        False = excluded) and ``coarse`` (int8 only: drop the residual
        pass) as in the JAX package; unfilled slots are -1 / 0."""
        del show_progress
        with spans.request(len(query_tokens)) as req:
            launched = [self._retrieve_launch(p, k, approx, doc_mask,
                                              coarse=coarse)[1:]
                        for p in _chunks(query_tokens,
                                         self._auto_batch_size())]
            req.launched(self._device)
            doc_ids, probabilities = _pull([out[:2] for out in launched],
                                           request=req)[0]
        if not explain:
            return doc_ids, probabilities
        return RetrievalResult(doc_ids, probabilities, self._explain_from(
            *(torch.cat([out[i] for out in launched]) for i in (0, 2, 3))))

    def _explain_from(self, top_ids, top_scores, top_tfs) -> list:
        """The traces of a retrieval, from its device (nq, k) ids, scores
        and tf counts: the document-length ratio is float32, as the JAX
        package reads it, and every field is computed in one pass on
        the device (``utils/debug.bm25_trace_rows``)."""
        from bayesian_bm25_tpu_torch.utils.debug import bm25_trace_rows

        dl = self._doc_lengths_device()[top_ids.clamp(min=0).long()]
        return bm25_trace_rows(self._transform, top_scores, top_tfs,
                               T.true_div(dl, self._index.avgdl))

    def retrieve_texts(self, query_texts, k: int = 10, explain: bool = False,
                       approx: bool = False):
        """Text-in retrieval: tokenize the queries (the C++ tokenizer where
        it builds) with the options given to ``index_texts``, then
        ``retrieve``."""
        return self.retrieve(tokenize_texts(query_texts, **self._tok_opts),
                             k=k, explain=explain, approx=approx)

    def _launch_batch(self, qb, k, approx, coarse):
        """Open a request for one caller batch and launch it,
        auto-chunked: (the request's span, its (ids, probs) parts)."""
        req = spans.request(len(qb))
        with spans.under(req):
            parts = [self._retrieve_launch(p, k, approx, None,
                                           coarse=coarse)[1:3]
                     for p in _chunks(qb, self._auto_batch_size())]
        req.launched(self._device)
        return req, parts

    def retrieve_many(self, query_batches, k: int = 10,
                      approx: bool = False, coarse: bool = False):
        """Pipelined serving: launch every batch (host encode, copies
        and kernels are queued without waiting on the device), then make
        one device-to-host copy for all of them. Returns a list of
        (doc_ids, probabilities) in batch order, equal to per-batch
        ``retrieve``."""
        launched, n_parts, reqs = [], [], []
        for qb in query_batches:
            req, parts = self._launch_batch(qb, k, approx, coarse)
            reqs.append(req)
            n_parts.append(len(parts))
            launched += parts
        # The one copy waits for every batch: it is the last request's.
        last = reqs[-1] if reqs else spans.NULL
        with spans.under(last):
            out = _pull(launched, n_parts, request=last)
        for req in reqs:
            req.close()
        return out

    def retrieve_stream(self, query_batches, k: int = 10,
                        approx: bool = False, lookahead: int = 4,
                        coarse: bool = False):
        """Latency-shaped serving: a generator that yields each batch's
        (doc_ids, probabilities) as soon as it is copied back, while up
        to ``lookahead`` batches stay launched ahead on the device.
        ``query_batches`` may be any iterable, a live request generator
        included; batches auto-chunk as in ``retrieve_many``, and the
        values equal per-batch ``retrieve``."""
        pending = deque()
        it = iter(query_batches)
        exhausted = False
        while True:
            while not exhausted and len(pending) < max(lookahead, 1):
                qb = next(it, None)
                if qb is None:
                    exhausted = True
                else:
                    pending.append(self._launch_batch(qb, k, approx,
                                                      coarse))
            if not pending:
                return
            req, parts = pending.popleft()
            with spans.under(req):
                out = _pull(parts, request=req, inflight=len(pending))[0]
            req.close()
            del parts  # the batch's device results go before the yield
            yield out

    def _retrieve_launch(self, query_tokens, k, approx, doc_mask,
                         coarse: bool = False):
        """Encode on the host, copy to the device and queue the
        retrieval kernels of the index's path; no host sync. Returns
        (nq, top_ids, probs, top_scores, top_tfs) on the device. Traced
        as ``launch``, with ``encode``, ``h2d`` and the path's stages
        under it."""
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve().")
        with spans.span("launch"):
            idx = self._index
            s = self._split
            dev = self._device
            k_eff = min(k, idx.n_docs)
            nq = len(query_tokens)
            t = self._transform
            doc_mask = self._device_mask(doc_mask)

            if k_eff == 0:
                # Nothing to select: (nq, 0) results, as in the JAX package,
                # with no launch. (k < 0 goes on to raise in the top-k.)
                empty = torch.zeros((nq, 0), dtype=torch.float32, device=dev)
                return nq, empty.to(torch.int32), empty, empty, empty
            # An empty batch runs as one empty query (the merge indexes
            # query rows), sliced off below.
            queries = list(query_tokens) or [[]]
            prior_free = t._training_mode == "prior_free"
            if s is None:
                # The doc-major path is exact whatever ``approx`` says, as in
                # the JAX package.
                with spans.span("encode"):
                    qids, qcnt = self._encode(queries)
                qids, qcnt = to_device(qids, dev), to_device(qcnt, dev)
                with spans.span("score"):
                    out = scoring.retrieve_topk(
                        idx.term_ids, idx.weights, idx.doc_lengths, idx.avgdl,
                        qids, qcnt, k_eff, t.alpha, t.beta, t.base_rate,
                        n_docs=idx.n_docs, prior_free=prior_free,
                        doc_mask=doc_mask, prob_dtype=self._prob_dtype)
            elif s.post_doc_ids is None:
                # Rare postings over budget: the dense compare tail.
                with spans.span("encode"):
                    enc = sidx.encode_queries_split(queries, s)
                out = sidx.retrieve_topk_split(
                    s.dense_impact, s.dense_presence, s.tail_term_ids,
                    s.tail_weights, idx.doc_lengths, idx.avgdl,
                    *(to_device(a, dev) for a in enc), k_eff,
                    t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs,
                    prior_free=prior_free, approx=approx,
                    overflow=sidx._overflow_of(s), doc_mask=doc_mask,
                    impact_lo=s.dense_impact_lo, impact_scale=s.impact_scale,
                    q_int8_ok=sidx._q_int8_ok(s, enc[1]),
                    prob_dtype=self._prob_dtype)
            else:
                out = self._sparse_launch(queries, k_eff, approx, doc_mask,
                                          coarse)
            return (nq, *(a[:nq] for a in out))

    def _sparse_launch(self, queries, k_eff, approx, doc_mask, coarse):
        """The sparse-candidate path (split index with rare postings):
        host encode and group splits (traced as ``encode`` and
        ``split``), then ``retrieve_topk_split_sparse``."""
        idx = self._index
        s = self._split
        dev = self._device
        t = self._transform
        with spans.span("encode"):
            fslots, fcnt, trows, tqids, tqcnt = sidx.encode_queries_split(
                queries, s)
        with spans.span("split"):
            # Width-capped indexes split the tail group by tier (group B
            # carries >= 1 tier-2 term); light/heavy splits by postings
            # total.
            (trows, tslots, tqcnt), grpB = sidx.split_tail_groups(
                trows, tqids, tqcnt, s)
            lh = (sidx.split_light_heavy(trows, tslots, tqcnt, s, k_eff)
                  if sidx.LIGHT_HEAVY else None)
            R = s.post_doc_ids.shape[0] - 1
            kw: dict = {}
            if lh is not None:
                (trows, tslots, tqcnt), (hrows, hslots, hqcnt) = lh
                kw.update(tailH_rows=hrows, tailH_slots=hslots,
                          tailH_qcnt=hqcnt,
                          cand_capH=sidx.candidate_cap(s, hslots, k_eff))
                if sidx.PACKED_BUILD:
                    packedH, r_maxH = sidx.compact_tail_postings(
                        hslots, hqcnt, R)
                    if r_maxH < hslots.shape[1]:
                        kw.update(compactH=packedH, compactH_rmax=r_maxH)
            cap = sidx.candidate_cap(s, tslots, k_eff)
            if grpB is not None:
                trB, s1B, qcB, s2B, qc2B = grpB
                lhb = (sidx.split_light_heavy_b(trB, s1B, qcB, s2B, qc2B, s,
                                                k_eff)
                       if sidx.LIGHT_HEAVY else None)
                if lhb is not None:
                    (trB, s1B, qcB, s2B, qc2B), (trB2, s1B2, qcB2, s2B2,
                                                 qc2B2) = lhb
                    kw.update(tailB2_rows=trB2, tailB2_slots=s1B2,
                              tailB2_qcnt=qcB2, tailB2_slots2=s2B2,
                              tailB2_qcnt2=qc2B2,
                              cand_cap2H=sidx.candidate_cap2(s, s1B2, s2B2,
                                                             k_eff))
                kw.update(post2_ids=s.post2_doc_ids,
                          post2_w=s.post2_weights,
                          tailB_rows=trB, tailB_slots=s1B, tailB_qcnt=qcB,
                          tailB_slots2=s2B, tailB_qcnt2=qc2B,
                          cand_cap2=sidx.candidate_cap2(s, s1B, s2B, k_eff))
            compact, r_max = None, 0
            if sidx.PACKED_BUILD:
                packed, r_max = sidx.compact_tail_postings(tslots, tqcnt, R)
                if r_max < tslots.shape[1]:
                    compact = packed
                else:
                    r_max = 0
        q_int8_ok = sidx._q_int8_ok(s, fcnt)
        use_fmm = cuda_matmul.fused_route(
            s.dense_impact, s.dense_impact_lo, s.impact_scale, len(fslots),
            doc_mask=doc_mask, approx=approx, coarse=coarse,
            q_int8_ok=q_int8_ok)
        kw = {name: (to_device(v, dev) if isinstance(v, np.ndarray) else v)
              for name, v in kw.items()}
        return sidx.retrieve_topk_split_sparse(
            s.dense_impact, s.dense_presence, s.post_doc_ids,
            s.post_weights, idx.doc_lengths, idx.avgdl,
            to_device(fslots, dev), to_device(fcnt, dev),
            to_device(trows, dev), to_device(tslots, dev),
            to_device(tqcnt, dev), k_eff, cap,
            t.alpha, t.beta, t.base_rate, n_docs=idx.n_docs,
            prior_free=t._training_mode == "prior_free",
            approx=approx, doc_mask=doc_mask, impact_lo=s.dense_impact_lo,
            tf_from_sign=s.post_w_positive,
            compact=None if compact is None else to_device(compact, dev),
            compact_rmax=r_max, impact_scale=s.impact_scale,
            q_int8_ok=q_int8_ok, fused_mm=use_fmm,
            coarse=coarse, prob_dtype=self._prob_dtype,
            impact_cols=s.impact_columns() if use_fmm else None, **kw)


def _chunks(queries, chunk: int) -> list:
    """Consecutive slices of at most ``chunk`` queries (one, possibly
    empty, slice for a short batch)."""
    return [queries[i:i + chunk]
            for i in range(0, len(queries), chunk)] or [queries]


def _pull(launched, n_parts=None, request=spans.NULL, inflight: int = 0):
    """One device-to-host copy for launched (ids, probs) parts: ids
    travel bitcast to float32 beside the probabilities. Returns one
    (int32 ids, float64 probs) pair per group of ``n_parts`` parts (one
    group of all parts by default). Counted in ``spans.counts``
    (``d2h_copies``, ``d2h_bytes``). Traced as ``pull.own``, the wait
    for ``request``'s own launches, then ``pull.behind``, the copy,
    which also waits for the ``inflight`` batches launched after it."""
    if not launched:
        return []
    with spans.span("pull.own"):
        request.wait()
    with spans.span("pull.behind") as sp:
        sp.add("inflight", inflight)
        packed = torch.cat([torch.stack([ids.view(torch.float32), probs])
                            for ids, probs in launched], dim=1).cpu().numpy()
    spans.counts["d2h_copies"] += 1
    spans.counts["d2h_bytes"] += packed.nbytes
    pieces, off = [], 0
    for ids, _ in launched:
        nq = ids.shape[0]
        pieces.append((packed[0, off:off + nq].view(np.int32),
                       packed[1, off:off + nq].astype(np.float64)))
        off += nq
    groups = n_parts if n_parts is not None else [len(pieces)]
    out, pos = [], 0
    for n in groups:
        grp = pieces[pos:pos + n]
        pos += n
        out.append(grp[0] if n == 1 else
                   (np.concatenate([g[0] for g in grp]),
                    np.concatenate([g[1] for g in grp])))
    return out
