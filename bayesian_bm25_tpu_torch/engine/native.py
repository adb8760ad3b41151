"""ctypes bindings for the C++ host loops in ``native/bb25_native.cpp``.

Counterpart of ``bayesian_bm25_tpu/engine/native.py``: the port's own
loader over the same, unchanged C++ source. It exposes

  * ``tokenize_texts_native``      -- batch tokenization (strings out);
  * ``build_corpus_native``        -- tokenize + vocabulary + per-doc term
    counts in one pass, as numpy CSR arrays;
  * ``build_corpus_tokens_native`` -- the same from token lists;
  * ``VocabEncoder``               -- a persistent vocabulary for query
    encoding (``encode_tokens``, ``encode_tokens_split``,
    ``encode_texts``);
  * ``load_jsonl_native``          -- a BEIR ``corpus.jsonl`` parser, and
    ``BlobTexts``, the lazy text sequence it returns.

The library is built at first use with
``g++ -O3 -std=c++17 -shared -fPIC -pthread`` into
``bayesian_bm25_tpu_torch/_build/`` (never the JAX package's copy). Its
file name carries a hash of the source and the flags, as the CUDA
kernels' library does, so an edited source or other flags build anew
and a stale library is never loaded. g++ writes a temporary name that is
then renamed onto the library's, so processes that build at once end
with one complete library. ``ctypes`` loads it with its default
``RTLD_LOCAL``, so the JAX package's copy of the same symbols may share
the process. Every function here raises ImportError or OSError when the
toolchain or the source is missing; the callers (``engine/tokenize.py``,
``engine/index.py``, ``engine/split_index.py``, the scorer) then run the
Python twin of the call.

``calls`` counts the library calls by entry point and ``fallbacks`` the
times a Python twin ran in place of one (a token that cannot ship in the
NUL-joined ASCII blob, or no library), like the kernel wrappers'
``launches``; ``reset_counts`` zeroes both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from itertools import chain as _chain
from pathlib import Path

import numpy as np

from bayesian_bm25_tpu_torch.engine.tokenize import stem_mode as _stem_mode

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "bb25_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_KINDS = ("tokenize", "corpus", "corpus_tokens", "encode_tokens",
          "encode_split", "encode_texts", "jsonl")
# Library calls and Python fallbacks since the last reset, by entry point.
calls = dict.fromkeys(_KINDS, 0)
fallbacks = dict.fromkeys(_KINDS, 0)
# Seconds the last g++ run in this process took (None: no build here).
build_seconds: float | None = None

_LIB = None
_LOCK = threading.Lock()


def reset_counts() -> None:
    """Zero ``calls`` and ``fallbacks``."""
    for d in (calls, fallbacks):
        for kind in d:
            d[kind] = 0


def _encode_threads() -> int:
    """Lookup threads for batch encoding, respecting cgroup CPU limits."""
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return max(1, min(8, n))


def library_path(out_dir=BUILD_DIR) -> Path:
    """Path of the library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(out_dir) / f"libbb25_native_{h.hexdigest()[:16]}.so"


def build_library(out_dir=BUILD_DIR) -> Path:
    """Compile ``native/bb25_native.cpp`` into ``out_dir`` unless the
    library for this source and these flags is there; return its path.

    g++ writes a temporary file in ``out_dir`` that is then renamed onto
    the library's name, so processes that build at once each replace it
    with a complete copy and none loads a half-written file. Raises
    ImportError when the source is missing or g++ fails."""
    global build_seconds
    if not SOURCE.exists():
        raise ImportError(f"native source not found: {SOURCE}")
    so = library_path(out_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libbb25_native.", suffix=".so",
                               dir=so.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", None) or str(exc)
        raise ImportError(
            f"failed to build the native library: {detail}") from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class _TokenizeResult(ctypes.Structure):
    _fields_ = [
        ("token_blob", ctypes.c_char_p),
        ("token_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("doc_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_tokens", ctypes.c_int64),
        ("blob_size", ctypes.c_int64),
    ]


class _CorpusResult(ctypes.Structure):
    _fields_ = [
        ("doc_indptr", ctypes.POINTER(ctypes.c_int64)),
        ("term_ids", ctypes.POINTER(ctypes.c_int32)),
        ("term_counts", ctypes.POINTER(ctypes.c_int32)),
        ("doc_lengths", ctypes.POINTER(ctypes.c_int32)),
        ("vocab_blob", ctypes.c_char_p),
        ("vocab_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_vocab", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("vocab_blob_size", ctypes.c_int64),
    ]


class _EncodeResult(ctypes.Structure):
    _fields_ = [
        ("pair_q", ctypes.POINTER(ctypes.c_int32)),
        ("pair_t", ctypes.POINTER(ctypes.c_int32)),
        ("pair_c", ctypes.POINTER(ctypes.c_int32)),
        ("n_pairs", ctypes.c_int64),
    ]


class _SplitEncodeResult(ctypes.Structure):
    _fields_ = [
        ("fslots", ctypes.POINTER(ctypes.c_int32)),
        ("fcnt", ctypes.POINTER(ctypes.c_float)),
        ("trows", ctypes.POINTER(ctypes.c_int32)),
        ("qids", ctypes.POINTER(ctypes.c_int32)),
        ("qcnt", ctypes.POINTER(ctypes.c_float)),
        ("nq", ctypes.c_int64),
        ("Qf", ctypes.c_int64),
        ("nt", ctypes.c_int64),
        ("Qt", ctypes.c_int64),
        ("has_pairs", ctypes.c_int32),
    ]


class _JsonlResult(ctypes.Structure):
    _fields_ = [
        ("id_blob", ctypes.POINTER(ctypes.c_char)),
        ("id_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("title_blob", ctypes.POINTER(ctypes.c_char)),
        ("title_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("text_blob", ctypes.POINTER(ctypes.c_char)),
        ("text_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_docs", ctypes.c_int64),
        ("id_blob_size", ctypes.c_int64),
        ("title_blob_size", ctypes.c_int64),
        ("text_blob_size", ctypes.c_int64),
    ]


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
# (restype, argtypes) of the library functions the port calls.
_SIGNATURES = {
    "bb25_tokenize": (ctypes.POINTER(_TokenizeResult), [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]),
    "bb25_free_tokenize": (None, [ctypes.POINTER(_TokenizeResult)]),
    "bb25_build_corpus": (ctypes.POINTER(_CorpusResult), [
        ctypes.c_char_p, _I64P, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]),
    "bb25_free_corpus": (None, [ctypes.POINTER(_CorpusResult)]),
    "bb25_build_corpus_tokens": (ctypes.POINTER(_CorpusResult), [
        ctypes.c_char_p, ctypes.c_int64, _I64P, ctypes.c_int64]),
    "bb25_vocab_create": (ctypes.c_void_p, [
        ctypes.c_char_p, _I64P, ctypes.c_int64]),
    "bb25_vocab_free": (None, [ctypes.c_void_p]),
    "bb25_encode_tokens_sep": (ctypes.POINTER(_EncodeResult), [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _I64P,
        ctypes.c_int64, ctypes.c_int]),
    "bb25_encode_texts": (ctypes.POINTER(_EncodeResult), [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "bb25_free_encode": (None, [ctypes.POINTER(_EncodeResult)]),
    "bb25_encode_tokens_split": (ctypes.POINTER(_SplitEncodeResult), [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _I64P,
        ctypes.c_int64, _I32P, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]),
    "bb25_free_encode_split": (None, [ctypes.POINTER(_SplitEncodeResult)]),
    "bb25_load_jsonl": (ctypes.POINTER(_JsonlResult), [ctypes.c_char_p]),
    "bb25_free_jsonl": (None, [ctypes.POINTER(_JsonlResult)]),
}


def load_library(path) -> ctypes.CDLL:
    """Load a built library (``RTLD_LOCAL``) with every signature set."""
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The library of this process, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = load_library(build_library())
    return _LIB


class BlobTexts:
    """Texts held as one bytes blob + int64 offsets; items decode lazily.

    A sequence (len, index, iteration), so it serves wherever a list of
    texts does, while bulk consumers (``_pack_texts``) ship the blob
    without making a Python string per document.
    """

    def __init__(self, blob: bytes, offsets: np.ndarray):
        self._blob = blob
        self._offsets = np.asarray(offsets, dtype=np.int64)

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> str:
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        o = self._offsets
        return self._blob[o[i]:o[i + 1]].decode("utf-8", errors="replace")

    def __iter__(self):
        o = self._offsets
        for i in range(len(self)):
            yield self._blob[o[i]:o[i + 1]].decode("utf-8",
                                                   errors="replace")


def _pack_texts(texts):
    if isinstance(texts, BlobTexts):
        return texts._blob, texts._offsets
    encoded = [t.encode("utf-8", errors="ignore") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _token_blob(token_lists, n_tokens: int) -> bytes | None:
    """The NUL-joined token blob, or None when a token is non-ASCII or
    holds a NUL (the two cases the layout cannot represent)."""
    joined = "\x00".join(_chain.from_iterable(token_lists))
    try:
        blob = joined.encode("utf-8")
    except UnicodeEncodeError:
        return None
    if len(blob) != len(joined) or joined.count("\x00") != n_tokens - 1:
        return None
    return blob


def tokenize_texts_native(texts, *, lowercase=True, remove_stopwords=True,
                          stem=True) -> list[list[str]]:
    """Batch tokenize via the C++ pipeline; returns per-doc token lists."""
    lib = load()
    blob, offsets = _pack_texts(texts)
    calls["tokenize"] += 1
    res = lib.bb25_tokenize(
        blob, offsets.ctypes.data_as(_I64P), len(texts), int(lowercase),
        int(remove_stopwords), _stem_mode(stem))
    try:
        r = res.contents
        n_tok = int(r.n_tokens)
        tok_off = np.ctypeslib.as_array(r.token_offsets, shape=(n_tok + 1,))
        doc_off = np.ctypeslib.as_array(r.doc_offsets, shape=(len(texts) + 1,))
        token_blob = ctypes.string_at(r.token_blob, int(r.blob_size))
        tokens = [token_blob[tok_off[i]:tok_off[i + 1]].decode("utf-8")
                  for i in range(n_tok)]
        return [tokens[doc_off[d]:doc_off[d + 1]]
                for d in range(len(texts))]
    finally:
        lib.bb25_free_tokenize(res)


def _unpack_corpus(lib, res, n_docs: int):
    try:
        r = res.contents
        nnz = int(r.nnz)
        n_vocab = int(r.n_vocab)
        indptr = np.array(
            np.ctypeslib.as_array(r.doc_indptr, shape=(n_docs + 1,)))
        term_ids = np.array(
            np.ctypeslib.as_array(r.term_ids, shape=(max(nnz, 1),)))[:nnz]
        term_counts = np.array(
            np.ctypeslib.as_array(r.term_counts, shape=(max(nnz, 1),)))[:nnz]
        doc_lengths = np.array(
            np.ctypeslib.as_array(r.doc_lengths,
                                  shape=(max(n_docs, 1),)))[:n_docs]
        voc_off = np.ctypeslib.as_array(r.vocab_offsets, shape=(n_vocab + 1,))
        vocab_blob = ctypes.string_at(r.vocab_blob, int(r.vocab_blob_size))
        vocab = {vocab_blob[voc_off[i]:voc_off[i + 1]].decode("utf-8"): i
                 for i in range(n_vocab)}
        return vocab, indptr, term_ids, term_counts, doc_lengths
    finally:
        lib.bb25_free_corpus(res)


def build_corpus_native(texts, *, lowercase=True, remove_stopwords=True,
                        stem=True):
    """Tokenize + vocab + per-doc unique-term counts in one native pass.

    Returns (vocab: dict[str, int], doc_indptr (n+1,), term_ids (nnz,),
    term_counts (nnz,), doc_lengths (n,)).
    """
    lib = load()
    blob, offsets = _pack_texts(texts)
    calls["corpus"] += 1
    res = lib.bb25_build_corpus(
        blob, offsets.ctypes.data_as(_I64P), len(texts), int(lowercase),
        int(remove_stopwords), _stem_mode(stem))
    return _unpack_corpus(lib, res, len(texts))


def build_corpus_tokens_native(corpus_tokens):
    """Pre-tokenized corpus -> vocab + CSR in one C++ pass.

    Same return contract as :func:`build_corpus_native`; vocabulary ids
    and per-doc term order equal the Python ``index._corpus_to_csr``
    (first occurrence, globally and within a doc). Returns None for a
    corpus with no token, or one that cannot ship as a NUL-joined ASCII
    blob (non-ASCII or NUL-containing tokens): callers then run the
    Python CSR build.
    """
    lib = load()
    n_docs = len(corpus_tokens)
    dc = np.fromiter(map(len, corpus_tokens), np.int64, n_docs)
    n_tokens = int(dc.sum())
    if n_tokens == 0:
        return None
    blob = _token_blob(corpus_tokens, n_tokens)
    if blob is None:
        return None
    calls["corpus_tokens"] += 1
    res = lib.bb25_build_corpus_tokens(blob, len(blob),
                                       dc.ctypes.data_as(_I64P), n_docs)
    if not res:
        return None
    return _unpack_corpus(lib, res, n_docs)


def _unpack_pairs(lib, res):
    try:
        r = res.contents
        n = int(r.n_pairs)
        if n == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        pq = np.array(np.ctypeslib.as_array(r.pair_q, shape=(n,)))
        pt = np.array(np.ctypeslib.as_array(r.pair_t, shape=(n,)))
        pc = np.array(np.ctypeslib.as_array(r.pair_c, shape=(n,)))
        return pq, pt, pc
    finally:
        lib.bb25_free_encode(res)


class VocabEncoder:
    """Persistent native vocabulary for batch query encoding.

    Replaces the per-token ``dict.get`` loop of
    ``index.query_term_pairs`` and the numpy group-by of
    ``split_index.encode_queries_split`` with one C++ pass over a token
    blob. Output triples (query, term id, count) are grouped by query
    with term ids ascending within each query: bit-identical to the
    ``np.unique`` dedup of those functions.
    """

    def __init__(self, vocab: dict):
        lib = load()
        terms = [None] * len(vocab)
        for tok, tid in vocab.items():
            terms[tid] = tok
        joined = "".join(terms)
        blob = joined.encode("utf-8")
        if len(blob) == len(joined):  # pure ASCII: char lengths == bytes
            lens = np.fromiter(map(len, terms), np.int64, len(terms))
        else:
            lens = np.fromiter((len(t.encode("utf-8")) for t in terms),
                               np.int64, len(terms))
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        self._lib = lib
        self._free = lib.bb25_vocab_free  # bound for __del__ at shutdown
        self._h = lib.bb25_vocab_create(blob, offsets.ctypes.data_as(_I64P),
                                        len(terms))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._free(h)
            self._h = None

    def encode_tokens(self, query_tokens: list) -> tuple | None:
        """Pre-tokenized queries -> (pair_q, pair_t, pair_c) int32 arrays.

        Ships one NUL-joined blob; token boundaries are found by a memchr
        scan in C++. Returns None when a token is non-ASCII or contains
        NUL (callers fall back to the Python dict loop).
        """
        qc = np.fromiter(map(len, query_tokens), np.int64,
                         len(query_tokens))
        n_tokens = int(qc.sum())
        if n_tokens == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        blob = _token_blob(query_tokens, n_tokens)
        if blob is None:
            return None
        calls["encode_tokens"] += 1
        res = self._lib.bb25_encode_tokens_sep(
            self._h, blob, len(blob), qc.ctypes.data_as(_I64P),
            len(query_tokens), _encode_threads() if n_tokens >= 4096 else 1)
        return _unpack_pairs(self._lib, res)

    def encode_tokens_split(self, query_tokens: list, slot_of, K: int,
                            query_pad: int, freq_pad: int, tail_pad: int,
                            nt_min: int):
        """Pre-tokenized queries -> the padded split-encode arrays
        (fslots, fcnt, trows, qids, qcnt) in one native pass: lookup,
        dedup, frequency partition and group-by all in C++
        (``split_index.encode_queries_split``'s numpy group-by is the
        contract). Returns None when the token blob cannot be represented
        (non-ASCII or NUL) or when no token is in the vocabulary (callers
        make the empty-batch block). ``slot_of`` must be an int32 array
        over the vocabulary."""
        qc = np.fromiter(map(len, query_tokens), np.int64,
                         len(query_tokens))
        n_tokens = int(qc.sum())
        if n_tokens == 0:
            return None
        blob = _token_blob(query_tokens, n_tokens)
        if blob is None:
            return None
        calls["encode_split"] += 1
        res = self._lib.bb25_encode_tokens_split(
            self._h, blob, len(blob), qc.ctypes.data_as(_I64P),
            len(query_tokens), slot_of.ctypes.data_as(_I32P),
            K, query_pad, freq_pad, tail_pad, nt_min)
        try:
            r = res.contents
            if not r.has_pairs:
                return None
            nq, Qf, nt, Qt = int(r.nq), int(r.Qf), int(r.nt), int(r.Qt)
            fslots = np.array(np.ctypeslib.as_array(r.fslots, (nq, Qf)))
            fcnt = np.array(np.ctypeslib.as_array(r.fcnt, (nq, Qf)))
            trows = np.array(np.ctypeslib.as_array(r.trows, (nt,)))
            qids = np.array(np.ctypeslib.as_array(r.qids, (nt, Qt)))
            qcnt = np.array(np.ctypeslib.as_array(r.qcnt, (nt, Qt)))
            return fslots, fcnt, trows, qids, qcnt
        finally:
            self._lib.bb25_free_encode_split(res)

    def encode_texts(self, texts, *, lowercase=True, remove_stopwords=True,
                     stem=True):
        """Raw query texts -> (pair_q, pair_t, pair_c): tokenize + vocab
        lookup + dedup in one native pass (no Python token objects)."""
        blob, offsets = _pack_texts(texts)
        calls["encode_texts"] += 1
        res = self._lib.bb25_encode_texts(
            self._h, blob, offsets.ctypes.data_as(_I64P), len(texts),
            int(lowercase), int(remove_stopwords), _stem_mode(stem))
        return _unpack_pairs(self._lib, res)


def load_jsonl_native(path: str):
    """BEIR-format .jsonl -> (ids, titles, texts), titles and texts as
    lazy :class:`BlobTexts` (the bodies flow blob to blob into the corpus
    build without a Python string per document).

    Returns None when the file cannot be opened. The C++ parser walks
    each top-level object with depth tracking (a "text" key nested
    inside "metadata" is skipped), decodes JSON escapes including
    \\uXXXX surrogate pairs to UTF-8, and keeps only lines with a
    non-empty "_id".
    """
    lib = load()
    calls["jsonl"] += 1
    res = lib.bb25_load_jsonl(os.fsencode(path))
    if not res:
        return None
    try:
        r = res.contents
        n = int(r.n_docs)

        def unpack(blob_p, off_p, size):
            off = np.array(np.ctypeslib.as_array(off_p, shape=(n + 1,)))
            return ctypes.string_at(blob_p, int(size)), off

        id_blob, id_off = unpack(r.id_blob, r.id_offsets, r.id_blob_size)
        # errors="replace": a lone \uD800-style escape in an _id decodes
        # to invalid UTF-8 (an unpaired surrogate); keep the document.
        ids = [id_blob[id_off[i]:id_off[i + 1]].decode("utf-8", "replace")
               for i in range(n)]
        titles = BlobTexts(*unpack(r.title_blob, r.title_offsets,
                                   r.title_blob_size))
        texts = BlobTexts(*unpack(r.text_blob, r.text_offsets,
                                  r.text_blob_size))
        return ids, titles, texts
    finally:
        lib.bb25_free_jsonl(res)
