"""Host-side index build -> doc-major BM25 index with tensors on a device.

Counterpart of ``bayesian_bm25_tpu/engine/index.py``. The host work is
numpy, line for line the JAX package's, so the arrays it produces are
bit-equal to the JAX build (tests/test_torch_index.py pins that); only
the final upload differs: torch tensors on an explicit ``device``.

    term_ids : (D_pad, T) int32, each row the doc's unique term ids,
               padded with DOC_PAD
    weights  : (D_pad, T) f32, idf(t) * tf_saturation(tf, dl)

A fresh build counts its corpus in one C++ pass (``engine/native.py``,
over ``native/bb25_native.cpp``), and query encoding goes through a
native vocabulary cached on the index (``get_native_encoder``), as in
the JAX package. Their Python twins here (``_corpus_to_csr``, the
dict loop of ``query_term_pairs``) give the same arrays; they run when
the library cannot be built or a token cannot ship in its ASCII blob,
and each such run is counted in ``native.fallbacks``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import native
from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_py
from bayesian_bm25_tpu_torch.ops.mathx import resolve_device
from bayesian_bm25_tpu_torch.utils import spans

VALID_METHODS = ("robertson", "lucene", "atire", "bm25l", "bm25+")
VALID_SCORE_SCALES = ("classic", "bm25s")
DEFAULT_DELTA = 0.5  # bm25s's default delta for bm25l / bm25+

# Padding sentinels. Doc-side and query-side pads differ so a padded query
# slot never matches a padded doc slot.
DOC_PAD = -1
QUERY_PAD = -2


def nonoccurrence_score(method: str, k1: float, delta: float) -> float:
    """tf=0 saturation value; 0 for the classic variants, nonzero for
    bm25l / bm25+."""
    if method == "bm25l":
        return (k1 + 1.0) * delta / (k1 + delta)
    if method == "bm25+":
        return delta
    return 0.0


def tf_scale_factor(method: str, k1: float,
                    score_scale: str = "classic") -> float:
    """Constant multiplier on the tf-saturation term."""
    if score_scale not in VALID_SCORE_SCALES:
        raise ValueError(
            f"score_scale must be one of {VALID_SCORE_SCALES}, "
            f"got {score_scale!r}"
        )
    if method == "atire" or (method == "robertson"
                             and score_scale == "classic"):
        return k1 + 1.0
    return 1.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``: a pinned, non-blocking copy
    for a CUDA device (the caching host allocator keeps the pinned
    buffer alive until the copy has run). Counted in ``spans.counts``
    (``h2d_copies``, ``h2d_bytes``), and an ``h2d`` span while tracing
    is on."""
    arr = np.ascontiguousarray(arr)
    spans.counts["h2d_copies"] += 1
    spans.counts["h2d_bytes"] += arr.nbytes
    with spans.span("h2d") as sp:
        sp.add("bytes", arr.nbytes)
        if not arr.flags.writeable:  # torch.from_numpy wants a writable array
            arr = arr.copy()
        t = torch.from_numpy(arr)
        device = torch.device(device)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


@dataclass
class BM25Index:
    """Doc-major BM25 index: tensors on ``device`` + host-side vocabulary
    and mirrors. ``vocab`` maps token -> term id in [0, n_terms)."""

    k1: float
    b: float
    method: str
    vocab: dict = field(repr=False)
    term_ids: torch.Tensor = field(repr=False)     # (D_pad, T) int32
    weights: torch.Tensor = field(repr=False)      # (D_pad, T) f32
    doc_lengths: torch.Tensor = field(repr=False)  # (D_pad,) f32
    doc_frequencies: np.ndarray = field(repr=False)  # (n_terms,) host
    idf: np.ndarray = field(repr=False)            # (n_terms,) host
    n_docs: int = 0
    n_terms: int = 0
    avgdl: float = 0.0
    max_doc_terms: int = 0
    score_scale: str = "classic"
    delta: float = DEFAULT_DELTA
    term_ids_host: np.ndarray = field(repr=False, default=None)
    term_counts_host: np.ndarray = field(repr=False, default=None)
    weights_host: np.ndarray = field(repr=False, default=None)
    doc_lengths_host: np.ndarray = field(repr=False, default=None)

    @property
    def num_docs(self) -> int:
        return self.n_docs

    def __getstate__(self):
        # The native-encoder cache holds ctypes handles (process-local,
        # unpicklable); it is rebuilt at the first encode after a load.
        state = dict(self.__dict__)
        state.pop("_native_encoder_cache", None)
        return state


def compute_idf(df: np.ndarray, n_docs: int, method: str) -> np.ndarray:
    """Per-term inverse document frequency for a BM25 variant."""
    df = df.astype(np.float64)
    if method == "robertson":
        return np.maximum(np.log((n_docs - df + 0.5) / (df + 0.5)), 0.0)
    if method == "lucene":
        return np.log1p((n_docs - df + 0.5) / (df + 0.5))
    if method == "atire":
        return np.log(n_docs / df)
    if method == "bm25l":
        return np.log((n_docs + 1.0) / (df + 0.5))
    if method == "bm25+":
        return np.log((n_docs + 1.0) / df)
    raise ValueError(f"method must be one of {VALID_METHODS}, got {method!r}")


def tf_saturation(tf, doc_len, avgdl, k1: float, b: float, method: str,
                  score_scale: str = "classic",
                  delta: float = DEFAULT_DELTA):
    """BM25 term-frequency saturation for tf > 0 (the FULL saturation,
    including delta for bm25l/bm25+)."""
    norm = 1.0 - b + b * doc_len / max(avgdl, 1e-12)
    if method == "bm25l":
        c = tf / norm
        return (k1 + 1.0) * (c + delta) / (k1 + c + delta)
    if method == "bm25+":
        return (k1 + 1.0) * tf / (k1 * norm + tf) + delta
    sat = tf / (tf + k1 * norm)
    return tf_scale_factor(method, k1, score_scale) * sat


def _corpus_to_csr(corpus_tokens: list[list[str]], vocab: dict):
    """Per-doc unique (term_id, count) CSR arrays in first-occurrence
    order; new tokens extend ``vocab`` in place."""
    n_docs = len(corpus_tokens)
    indptr = np.zeros(n_docs + 1, dtype=np.int64)
    term_ids: list[int] = []
    term_counts: list[int] = []
    doc_lengths = np.zeros(n_docs, dtype=np.int64)
    for i, tokens in enumerate(corpus_tokens):
        doc_lengths[i] = len(tokens)
        counts: dict[int, int] = {}
        for tok in tokens:
            tid = vocab.get(tok)
            if tid is None:
                tid = len(vocab)
                vocab[tok] = tid
            counts[tid] = counts.get(tid, 0) + 1
        term_ids.extend(counts.keys())
        term_counts.extend(counts.values())
        indptr[i + 1] = len(term_ids)
    return (
        indptr,
        np.asarray(term_ids, dtype=np.int64),
        np.asarray(term_counts, dtype=np.int64),
        doc_lengths,
    )


def build_index(
    corpus_tokens: list[list[str]],
    k1: float = 1.2,
    b: float = 0.75,
    method: str = "robertson",
    vocab: dict | None = None,
    pad_multiple: int = 128,
    doc_pad_multiple: int = 2048,
    csr=None,
    score_scale: str = "classic",
    delta: float = DEFAULT_DELTA,
    *,
    device="cuda",
) -> BM25Index:
    """Tokenized corpus -> index with its tables on ``device`` (the
    card by default; ``ops/mathx.resolve_device``)."""
    device = resolve_device(device)
    if method not in VALID_METHODS:
        raise ValueError(
            f"method must be one of {VALID_METHODS}, got {method!r}")
    if score_scale not in VALID_SCORE_SCALES:
        raise ValueError(
            f"score_scale must be one of {VALID_SCORE_SCALES}, "
            f"got {score_scale!r}"
        )

    n_docs = len(corpus_tokens)
    if n_docs == 0:
        raise ValueError("corpus must contain at least one document")

    if vocab is None:
        vocab = {}
    if csr is None:
        built = None
        if not vocab:
            # A fresh vocabulary: one C++ pass over a token blob in place
            # of the per-token dict loop. Appends and builds that seed
            # from an existing vocabulary keep the Python path.
            try:
                built = native.build_corpus_tokens_native(corpus_tokens)
            except (ImportError, OSError):
                built = None
            if built is None:
                native.fallbacks["corpus_tokens"] += 1
        if built is not None:
            nvocab, indptr, tids_flat, counts_flat, doc_len_i = built
            vocab.update(nvocab)
        else:
            indptr, tids_flat, counts_flat, doc_len_i = _corpus_to_csr(
                corpus_tokens, vocab)
    else:
        indptr, tids_flat, counts_flat, doc_len_i = csr
    doc_lengths = doc_len_i.astype(np.float64)

    n_terms = len(vocab)
    avgdl = float(np.mean(doc_lengths)) if n_docs else 0.0

    df = np.bincount(tids_flat, minlength=n_terms).astype(np.int64)
    idf = compute_idf(np.maximum(df, 1), n_docs, method)

    per_doc_terms = np.diff(indptr)
    max_terms = int(per_doc_terms.max()) if n_docs else 1
    T = max(_round_up(max(max_terms, 1), pad_multiple), pad_multiple)

    # Pad rows have no terms and doc_length = avgdl: their score is 0, so
    # they never enter a top-k above a real match.
    D_pad = _round_up(n_docs, doc_pad_multiple)
    term_ids = np.full((D_pad, T), DOC_PAD, dtype=np.int32)
    counts = np.zeros((D_pad, T), dtype=np.int32)

    if len(tids_flat):
        row = np.repeat(np.arange(n_docs), per_doc_terms)
        col = np.arange(len(tids_flat)) - indptr[row]
        term_ids[row, col] = tids_flat
        counts[row, col] = counts_flat

    doc_lengths_pad = np.full(D_pad, max(avgdl, 1.0), dtype=np.float64)
    doc_lengths_pad[:n_docs] = doc_lengths

    weights = _compute_weight_table(
        term_ids, counts, doc_lengths_pad, avgdl, idf, k1, b, method,
        score_scale, delta)

    return BM25Index(
        k1=k1,
        b=b,
        method=method,
        score_scale=score_scale,
        delta=delta,
        vocab=vocab,
        term_ids=to_device(term_ids, device),
        weights=to_device(weights, device),
        doc_lengths=to_device(doc_lengths_pad.astype(np.float32), device),
        doc_frequencies=df,
        idf=idf,
        n_docs=n_docs,
        n_terms=n_terms,
        avgdl=avgdl,
        max_doc_terms=T,
        term_ids_host=term_ids,
        term_counts_host=counts,
        weights_host=weights,
        doc_lengths_host=doc_lengths_pad,
    )


def _compute_weight_table(term_ids, counts, doc_lengths_pad, avgdl, idf,
                          k1: float, b: float, method: str,
                          score_scale: str = "classic",
                          delta: float = DEFAULT_DELTA) -> np.ndarray:
    """(D_pad, T) float32 BM25 contributions from the counts table, in
    float64 throughout; pad slots (count 0) give weight 0 exactly."""
    cf = counts.astype(np.float64)
    norm = 1.0 - b + b * doc_lengths_pad / max(avgdl, 1e-12)
    if method == "bm25l":
        c = cf / norm[:, None]
        sat = (k1 + 1.0) * (c + delta) / (k1 + c + delta)
        sat -= nonoccurrence_score(method, k1, delta)
    elif method == "bm25+":
        sat = (k1 + 1.0) * cf / (k1 * norm[:, None] + cf)
        # the +delta and the -sat0 = -delta cancel exactly
    else:
        K = k1 * norm
        sat = tf_scale_factor(method, k1, score_scale) * (
            cf / (cf + K[:, None]))
    w = np.where(term_ids >= 0, idf[np.maximum(term_ids, 0)] * sat, 0.0)
    return w.astype(np.float32)


def append_to_index(
    idx: BM25Index,
    new_corpus_tokens: list[list[str]],
    *,
    pad_multiple: int = 128,
    doc_pad_multiple: int = 2048,
    device=None,
) -> BM25Index:
    """Append documents to an index without re-counting the old corpus.

    Only the new docs are counted (the (doc, term) count table is
    append-only); every weight is recomputed from the counts with the
    grown df, N and avgdl. The result is bit-identical to a full rebuild
    of old + new: new terms take ids in first-occurrence order, as a
    rebuild assigns them, the weight formula is the same float64 one,
    and avgdl is ``np.mean`` over the concatenated lengths, a rebuild's
    summation order. ``vocab`` is extended in place. Tensors go to
    ``device`` (default: the index's device).
    """
    if idx.term_counts_host is None:
        raise ValueError("index lacks its host count table; rebuild it "
                         "with build_index()")
    n_new = len(new_corpus_tokens)
    if n_new == 0:
        return idx
    device = idx.doc_lengths.device if device is None else device
    n_old = idx.n_docs
    vocab = idx.vocab
    indptr, tids_flat, counts_flat, new_len_i = _corpus_to_csr(
        new_corpus_tokens, vocab)
    n_terms = len(vocab)
    n_docs = n_old + n_new

    df = np.bincount(tids_flat, minlength=n_terms).astype(np.int64)
    df[: idx.n_terms] += idx.doc_frequencies
    idf = compute_idf(np.maximum(df, 1), n_docs, idx.method)

    old_dl = idx.doc_lengths_host[:n_old]
    avgdl = float(np.mean(np.concatenate(
        [old_dl, new_len_i.astype(np.float64)])))

    per_doc_terms = np.diff(indptr)
    T = max(idx.max_doc_terms,
            _round_up(max(int(per_doc_terms.max(initial=1)), 1),
                      pad_multiple))
    D_pad = _round_up(n_docs, doc_pad_multiple)

    term_ids = np.full((D_pad, T), DOC_PAD, dtype=np.int32)
    counts = np.zeros((D_pad, T), dtype=np.int32)
    T_old = idx.max_doc_terms
    term_ids[:n_old, :T_old] = idx.term_ids_host[:n_old]
    counts[:n_old, :T_old] = idx.term_counts_host[:n_old]
    if len(tids_flat):
        row = n_old + np.repeat(np.arange(n_new), per_doc_terms)
        col = np.arange(len(tids_flat)) - indptr[row - n_old]
        term_ids[row, col] = tids_flat
        counts[row, col] = counts_flat

    doc_lengths_pad = np.full(D_pad, max(avgdl, 1.0), dtype=np.float64)
    doc_lengths_pad[:n_old] = old_dl
    doc_lengths_pad[n_old:n_docs] = new_len_i

    weights = _compute_weight_table(
        term_ids, counts, doc_lengths_pad, avgdl, idf, idx.k1, idx.b,
        idx.method, idx.score_scale, idx.delta)

    return BM25Index(
        k1=idx.k1, b=idx.b, method=idx.method, score_scale=idx.score_scale,
        delta=idx.delta, vocab=vocab,
        term_ids=to_device(term_ids, device),
        weights=to_device(weights, device),
        doc_lengths=to_device(doc_lengths_pad.astype(np.float32), device),
        doc_frequencies=df, idf=idf,
        n_docs=n_docs, n_terms=n_terms, avgdl=avgdl, max_doc_terms=T,
        term_ids_host=term_ids, term_counts_host=counts,
        weights_host=weights, doc_lengths_host=doc_lengths_pad,
    )


def build_index_from_texts(
    texts,
    k1: float = 1.2,
    b: float = 0.75,
    method: str = "robertson",
    *,
    lowercase: bool = True,
    remove_stopwords: bool = True,
    stem: bool | str = True,
    use_native: bool | str = "auto",
    return_tokens: bool = True,
    score_scale: str = "classic",
    delta: float = DEFAULT_DELTA,
    device="cuda",
):
    """Raw texts -> (BM25Index on ``device``, corpus_tokens): one C++ pass
    tokenizes, builds the vocabulary and counts, when the library is
    available; otherwise the Python tokenizer and CSR build (counted in
    ``native.fallbacks["corpus"]``; ``use_native=True`` raises instead).
    With ``return_tokens=False`` the native path makes no per-doc token
    lists (corpus_tokens comes back None)."""
    device = resolve_device(device)
    opts = dict(lowercase=lowercase, remove_stopwords=remove_stopwords,
                stem=stem)
    if use_native in ("auto", True):
        try:
            vocab, indptr, tids, counts, dlens = native.build_corpus_native(
                texts, **opts)
            corpus_tokens = (native.tokenize_texts_native(texts, **opts)
                             if return_tokens else None)
        except (ImportError, OSError):
            if use_native is True:
                raise
            native.fallbacks["corpus"] += 1
        else:
            idx = build_index(
                [None] * len(texts), k1=k1, b=b, method=method, vocab=vocab,
                csr=(indptr, tids.astype(np.int64), counts.astype(np.int64),
                     dlens.astype(np.int64)),
                score_scale=score_scale, delta=delta, device=device)
            return idx, corpus_tokens
    corpus_tokens = [tokenize_py(t, **opts) for t in texts]
    return build_index(corpus_tokens, k1=k1, b=b, method=method,
                       score_scale=score_scale, delta=delta,
                       device=device), corpus_tokens


def get_native_encoder(index):
    """The native ``VocabEncoder`` for this index's vocabulary, cached on
    the index (dropped when the index is pickled); None when the library
    cannot be built. The cache is rebuilt when the vocabulary has grown
    (``append_to_index`` extends the shared dict in place)."""
    cached = getattr(index, "_native_encoder_cache", None)
    if cached is not None and cached[1] == len(index.vocab):
        return cached[0]
    try:
        enc = native.VocabEncoder(index.vocab)
    except (ImportError, OSError):
        enc = None
    index._native_encoder_cache = (enc, len(index.vocab))
    return enc


def query_term_pairs(query_tokens: list, vocab: dict, native_encoder=None):
    """Queries -> deduplicated (query, term, count) triples, grouped by
    query (ascending) with term ids ascending within each query, or None
    when no query token is in the vocabulary. ``native_encoder`` (a
    ``native.VocabEncoder``) makes one C++ pass; the dict loop below gives
    the same triples and runs when there is no encoder or it declines the
    batch (counted in ``native.fallbacks["encode_tokens"]``)."""
    if native_encoder is not None:
        out = native_encoder.encode_tokens(query_tokens)
        if out is not None:
            pq32, pt32, pc32 = out
            if len(pq32) == 0:
                return None
            return pq32.astype(np.int64), pt32.astype(np.int64), pc32
    native.fallbacks["encode_tokens"] += 1
    get = vocab.get
    flat_q: list = []
    flat_t: list = []
    for qi, tokens in enumerate(query_tokens):
        for tok in tokens:
            tid = get(tok)
            if tid is not None:
                flat_q.append(qi)
                flat_t.append(tid)
    if not flat_t:
        return None
    qarr = np.asarray(flat_q, dtype=np.int64)
    tarr = np.asarray(flat_t, dtype=np.int64)
    V = max(len(vocab), 1)
    pair, counts = np.unique(qarr * V + tarr, return_counts=True)
    return pair // V, pair % V, counts


def encode_queries(
    query_tokens: list[list[str]],
    vocab: dict,
    max_query_terms: int | None = None,
    pad_multiple: int = 8,
    native_encoder=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenized queries -> (qids, qcounts) padded host arrays for the
    doc-major compare.

    Each row holds the query's unique in-vocabulary term ids (ascending)
    and their multiplicities, padded with QUERY_PAD / 0; OOV tokens are
    dropped. Queries with more unique terms than the padded width keep
    the first ``max_query_terms`` in ascending term-id order.
    ``native_encoder`` as in :func:`query_term_pairs`.
    """
    nq = len(query_tokens)
    min_Q = _round_up(1, pad_multiple)
    pairs = query_term_pairs(query_tokens, vocab, native_encoder)
    if pairs is None:
        return (np.full((nq, min_Q), QUERY_PAD, np.int32),
                np.zeros((nq, min_Q), np.float32))
    pq, pt, counts = pairs
    uniq_q, start = np.unique(pq, return_index=True)
    per = np.diff(np.append(start, len(pq)))
    Q = _round_up(int(per.max()), pad_multiple)
    if max_query_terms is not None:
        Q = min(Q, _round_up(max_query_terms, pad_multiple))
    col = np.arange(len(pq)) - start[np.searchsorted(uniq_q, pq)]
    keep = col < Q  # first-Q unique terms when a query overflows
    qids = np.full((nq, Q), QUERY_PAD, dtype=np.int32)
    qcnt = np.zeros((nq, Q), dtype=np.float32)
    qids[pq[keep], col[keep]] = pt[keep]
    qcnt[pq[keep], col[keep]] = counts[keep]
    return qids, qcnt


def query_score_shift(idx: BM25Index,
                      query_tokens_batch: list[list[str]]) -> np.ndarray:
    """Per-query bm25l/bm25+ nonoccurrence shift, ``sat0 * sum_t idf_t``
    over the query's in-vocab token occurrences (zeros for the classic
    variants). Rank-neutral; the scorer adds it to the public raw scores
    for score-level parity with bm25s."""
    sat0 = nonoccurrence_score(idx.method, idx.k1, idx.delta)
    nq = len(query_tokens_batch)
    shift = np.zeros(nq, dtype=np.float64)
    if sat0 == 0.0:
        return shift
    vocab = idx.vocab
    idf = idx.idf
    for qi, toks in enumerate(query_tokens_batch):
        s = 0.0
        for tok in toks:
            tid = vocab.get(tok)
            if tid is not None and tid < len(idf):
                s += idf[tid]
        shift[qi] = sat0 * s
    return shift
