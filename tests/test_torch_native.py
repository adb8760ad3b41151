"""PyTorch port: the tokenizers and the C++ host loops against JAX.

The port carries its own copies of the tokenizers and its own ctypes
loader over the unchanged ``native/bb25_native.cpp``, built into
``bayesian_bm25_tpu_torch/_build/``. Held here to the JAX package on the
same numpy-seeded inputs: the Python tokenizer and both stemmers token
for token; every native output bit for bit (the corpus CSR, query pairs,
the padded split encode, text encode, the JSONL loader); the Python
twins on the inputs the native blob cannot carry (non-ASCII, NUL,
unpaired surrogates), counted as fallbacks; and two processes building
the library at once into one directory.
"""

import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import native as jnative
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.engine import tokenize as jtok
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.engine import native as tnative
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.engine import tokenize as ttok
from bayesian_bm25_tpu_torch.utils import convert

MINI_BEIR = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "data", "mini_beir", "corpus.jsonl")

# Words on which the stemmers and the tokenizer have edges: Porter's and
# Porter2's suffix classes, irregular forms, short words, stopwords, digits.
WORDS = ("caresses ponies ties caress cats feed agreed plastered bled "
         "motoring sing conflated troubled sized hopping tanned falling "
         "hissing fizzed failing filing happy sky relational conditional "
         "rational valenci hesitanci digitizer conformabli radicalli "
         "vietnamization predication operator feudalism decisiveness "
         "hopefulness callousness formaliti sensitiviti sensibiliti "
         "triplicate formative formalize electriciti electrical hopeful "
         "goodness revival allowance inference airliner gyroscopic "
         "adjustable defensible irritant replacement adjustment dependent "
         "adoption homologou communism activate angulariti homologous "
         "effective bowdlerize probate rate cease controll roll generously "
         "skies dying lying tying idly gently ugly early only singly news "
         "howe atlas cosmos bias andes innings outings cannings herrings "
         "earrings proceeding exceeded succeeds generate generations "
         "arsenal community communication consign consigned a an and the "
         "of to in is it x y z ab abc 42 1984 b2b mp3 aaa yyy eeing "
         "ization ational ness ies").split()


def _texts(seed, n, vocab=400, length=40):
    """Seeded raw texts: Zipf draws over a word list with suffixes,
    mixed case, stopwords and punctuation."""
    rng = np.random.default_rng(seed)
    stems = [f"w{i}" for i in range(vocab)]
    suffixes = ["", "", "ing", "ies", "ational", "ness", "s", "ed"]
    words = [s + suffixes[i % len(suffixes)] for i, s in enumerate(stems)]
    words += WORDS
    out = []
    for _ in range(n):
        draw = rng.zipf(1.3, size=length) % len(words)
        toks = [words[i] for i in draw]
        toks = [t.upper() if j % 7 == 0 else t.capitalize() if j % 5 == 0
                else t for j, t in enumerate(toks)]
        out.append(", ".join(" ".join(toks[i:i + 6])
                             for i in range(0, length, 6)) + ".")
    return out


def _corpus(seed=0, D=500, V=900, L=40):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.3, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=97, V=1000):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.3, size=int(rng.integers(1, 9)))
             % V] for _ in range(n)]


CORPUS = _corpus()
EDGE_BATCHES = [
    [[]],
    [["zzz-oov", "yyy-oov"]],
    [["t1", "t1", "t1"]],
    [["t1"], [], ["t2", "t1"], []],
    [[]] * 5,
    [["t0"]],
    [[], ["zzz-oov"], ["t1"], ["t1", "t1", "t5", "zzz"]],
]
STEMS = [False, True, "porter", "snowball", "none"]


@pytest.fixture(scope="module")
def pair():
    """A doc-major index of each package over one corpus, and a split
    index of each (K = 256, so the queries have a rare tail)."""
    j = jidx.build_index(CORPUS)
    t = tidx.build_index(CORPUS, device="cpu")
    js = jsidx.build_split_index(j, n_frequent=256)
    ts = tsidx.build_split_index(t, n_frequent=256, device="cpu")
    if jidx.get_native_encoder(j) is None:
        pytest.fail("the JAX package's native library did not build")
    return j, t, js, ts


def _equal(a, b, what="", dtypes=True):
    """Equal tuples of arrays (or both None); ``dtypes=False`` for a
    native result against its Python twin, whose counts are int64."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert not dtypes or x.dtype == y.dtype, (what, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=what)


def _numpy_split(queries, split):
    """The port's numpy twin of the split encode (no native encoder)."""
    orig = tidx.get_native_encoder
    tidx.get_native_encoder = lambda index: None
    try:
        return tsidx.encode_queries_split(queries, split)
    finally:
        tidx.get_native_encoder = orig


# -- tokenizers --------------------------------------------------------------


@pytest.mark.parametrize("stem", STEMS)
def test_stemmers_equal_jax(stem):
    fn = ttok._stem_fn(stem)
    jfn = jtok._stem_fn(stem)
    assert (fn is None) == (jfn is None)
    if fn is not None:
        assert [fn(w) for w in WORDS] == [jfn(w) for w in WORDS]


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("lowercase,remove_stopwords",
                         [(True, True), (False, True), (True, False)])
def test_tokenizers_equal_jax(stem, lowercase, remove_stopwords):
    """The port's Python tokenizer, its native tokenizer and the JAX
    package's Python tokenizer give the same tokens."""
    texts = _texts(3, 40) + ["", "   ", "The THE the", "a1b2 c3-d4_e5",
                             "été café naïve 42x"]
    opts = dict(lowercase=lowercase, remove_stopwords=remove_stopwords,
                stem=stem)
    want = [jtok.tokenize_py(t, **opts) for t in texts]
    assert [ttok.tokenize_py(t, **opts) for t in texts] == want
    assert ttok.tokenize_texts(texts, **opts, use_native=True) == want
    assert ttok.tokenize_texts(texts, **opts, use_native=False) == want
    assert ttok.STOPWORDS == jtok.STOPWORDS


def test_stem_mode_rejects_unknown():
    with pytest.raises(ValueError, match="stem must be"):
        ttok.stem_mode("lancaster")


# -- native outputs, bit for bit ---------------------------------------------


def test_corpus_csr_equal_jax():
    corpus = [list(d) for d in CORPUS[:300]]
    corpus[3] = []                       # empty doc
    corpus[5] = ["dup", "dup", "dup"]    # one repeated term
    corpus[7] = ["x" * 300, "t1"]        # a long token
    got = tnative.build_corpus_tokens_native(corpus)
    want = jnative.build_corpus_tokens_native(corpus)
    vocab_py: dict = {}
    py = tidx._corpus_to_csr(corpus, vocab_py)
    assert got[0] == want[0] == vocab_py
    _equal(got[1:], want[1:], "native CSR")
    for a, b in zip(got[1:], py):
        np.testing.assert_array_equal(a, b)


def test_build_index_native_equals_jax():
    before = tnative.calls["corpus_tokens"]
    t = tidx.build_index(CORPUS, device="cpu")
    assert tnative.calls["corpus_tokens"] == before + 1
    j = jidx.build_index(CORPUS)
    assert t.vocab == j.vocab
    for name in ("term_ids_host", "term_counts_host", "weights_host",
                 "doc_lengths_host"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("batch", range(len(EDGE_BATCHES) + 2))
def test_encode_tokens_equal_jax(pair, batch):
    j, t, _, _ = pair
    queries = (_queries(seed=batch) if batch >= len(EDGE_BATCHES)
               else EDGE_BATCHES[batch])
    tenc, jenc = tidx.get_native_encoder(t), jidx.get_native_encoder(j)
    _equal(tenc.encode_tokens(queries), jenc.encode_tokens(queries))
    got = tidx.query_term_pairs(queries, t.vocab, tenc)
    _equal(got, jidx.query_term_pairs(queries, j.vocab, jenc))
    _equal(got, tidx.query_term_pairs(queries, t.vocab, None), "twin",
           dtypes=False)
    _equal(tidx.encode_queries(queries, t.vocab, native_encoder=tenc),
           jidx.encode_queries(queries, j.vocab, native_encoder=jenc))


@pytest.mark.parametrize("batch", range(len(EDGE_BATCHES) + 2))
def test_encode_split_equal_jax(pair, batch):
    """The one-pass split encode: equal to the JAX package's and to the
    port's own numpy twin (shapes, dtypes, padding, row order)."""
    _, _, js, ts = pair
    queries = (_queries(seed=10 + batch) if batch >= len(EDGE_BATCHES)
               else EDGE_BATCHES[batch])
    before = tnative.calls["encode_split"]
    got = tsidx.encode_queries_split(queries, ts)
    if any(queries):
        assert tnative.calls["encode_split"] == before + 1
    _equal(got, jsidx.encode_queries_split(queries, js), "JAX")
    _equal(got, _numpy_split(queries, ts), "numpy twin")


@pytest.mark.parametrize("stem", [True, "snowball", False])
def test_encode_texts_equal_jax(pair, stem):
    j, t, _, _ = pair
    texts = ["t1 T17 t17 running quickly", "zzz unknown", "", "The t1 T2"]
    texts += [" ".join(q) for q in _queries(seed=4, n=20)]
    for opts in (dict(stem=stem),
                 dict(lowercase=False, remove_stopwords=False, stem=stem)):
        got = tidx.get_native_encoder(t).encode_texts(texts, **opts)
        _equal(got, jidx.get_native_encoder(j).encode_texts(texts, **opts))
        want = tidx.query_term_pairs(ttok.tokenize_texts(texts, **opts),
                                     t.vocab, None)
        _equal((got[0].astype(np.int64), got[1].astype(np.int64), got[2]),
               want, "twin", dtypes=False)


def _write_jsonl(path, rows, raw_lines=()):
    with open(path, "w") as f:
        for i, row in enumerate(rows):
            f.write(json.dumps(row) + "\n")
            if i == 1:
                f.write("\n")
        for line in raw_lines:
            f.write(line + "\n")
    return str(path)


EDGE_ROWS = [
    {"_id": "d1", "title": "First", "text": "the quick brown fox"},
    {"_id": "d2", "text": "esc \"q\" \\ back / sl\nnl\ttab\r\b\f",
     "title": ""},
    {"_id": "d3", "title": "café",
     "text": "pair \U0001F600 and é end"},
    {"_id": "d4", "metadata": {"text": "DECOY", "nested": {"_id": "x"}},
     "text": "real text four", "title": "T4"},
    {"_id": "d5", "text": "n 1 true null", "extra": [1, {"text": "deep"}]},
    {"_id": "", "text": "an empty id is dropped"},
    {"text": "no id is dropped"},
    {"title": "title first", "_id": "d8", "text": "keys reordered"},
]
RAW_LINES = ['{"_id": "d9\\ud800", "text": "a lone surrogate escape"}',
             '{"text": "\\ud83d\\ude00 escaped pair", "_id": "d10"}']


@pytest.mark.parametrize("which", ["mini_beir", "edges"])
def test_load_jsonl_equal_jax(tmp_path, which):
    path = (MINI_BEIR if which == "mini_beir"
            else _write_jsonl(tmp_path / "c.jsonl", EDGE_ROWS, RAW_LINES))
    before = tnative.calls["jsonl"]
    ids, titles, texts = tnative.load_jsonl_native(path)
    assert tnative.calls["jsonl"] == before + 1
    jids, jtitles, jtexts = jnative.load_jsonl_native(path)
    assert ids == jids
    for a, b in ((titles, jtitles), (texts, jtexts)):
        assert a._blob == b._blob
        np.testing.assert_array_equal(a._offsets, b._offsets)
        assert list(a) == list(b)
    if which == "edges":
        kept = [r for r in EDGE_ROWS if r.get("_id")]
        assert ids[:len(kept)] == [r["_id"] for r in kept]
        assert [texts[i] for i in range(len(kept))] == [r["text"]
                                                       for r in kept]
        assert texts[-1] == "\U0001F600 escaped pair"
        assert ids[-2].startswith("d9")
    assert tnative.load_jsonl_native(str(tmp_path / "missing.jsonl")) is None


# -- what the blob cannot carry: the Python twins, counted -------------------


@pytest.mark.parametrize("bad", ["café", "a\x00b", "\ud800bad"])
def test_fallbacks_equal_jax(pair, bad):
    j, t, js, ts = pair
    tenc = tidx.get_native_encoder(t)
    queries = [[bad, "t1"], ["t2", "t3", "t1"], []]
    assert tenc.encode_tokens(queries) is None
    slot = np.ascontiguousarray(ts.freq_slot_of_term, np.int32)
    assert tenc.encode_tokens_split(queries, slot, ts.n_frequent, -2, 8, 4,
                                    16) is None
    assert tnative.build_corpus_tokens_native([[bad], ["t1"]]) is None
    tnative.reset_counts()
    _equal(tidx.query_term_pairs(queries, t.vocab, tenc),
           jidx.query_term_pairs(queries, j.vocab,
                                 jidx.get_native_encoder(j)))
    _equal(tsidx.encode_queries_split(queries, ts),
           jsidx.encode_queries_split(queries, js))
    corpus = [[bad, "t1", "t2"], ["t2", "t2"], []]
    tb = tidx.build_index(corpus, device="cpu")
    assert tb.vocab == jidx.build_index(corpus).vocab
    assert tnative.fallbacks["encode_tokens"] == 2
    assert tnative.fallbacks["encode_split"] == 1
    assert tnative.fallbacks["corpus_tokens"] == 1
    assert sum(tnative.calls.values()) == 0


def test_encoder_cache_rebuilt_and_dropped_when_pickled(pair):
    _, t, _, _ = pair
    enc = tidx.get_native_encoder(t)
    assert tidx.get_native_encoder(t) is enc
    t.vocab["__new_term__"] = len(t.vocab)
    try:
        enc2 = tidx.get_native_encoder(t)
        assert enc2 is not enc
        assert list(enc2.encode_tokens([["__new_term__"]])[1]) == [
            len(t.vocab) - 1]
    finally:
        del t.vocab["__new_term__"]
    state = convert.index_to_numpy(t)
    clone = pickle.loads(pickle.dumps(tidx.build_index(CORPUS[:50],
                                                       device="cpu")))
    assert "_native_encoder_cache" not in clone.__dict__
    assert tidx.get_native_encoder(clone) is not None
    assert state["vocab"] == t.vocab


# -- the build --------------------------------------------------------------

# Each process loads the loader alone: empty parent packages keep the
# package's torch import out, so both are ready in well under a second.
_BUILD_SCRIPT = """
import sys, time, types
from pathlib import Path
for name, sub in (("bayesian_bm25_tpu_torch", ""),
                  ("bayesian_bm25_tpu_torch.engine", "/engine")):
    pkg = types.ModuleType(name)
    pkg.__path__ = [sys.argv[3] + sub]
    sys.modules[name] = pkg
from bayesian_bm25_tpu_torch.engine import native
out, go = Path(sys.argv[1]), Path(sys.argv[2])
print("ready", flush=True)
deadline = time.monotonic() + 60
while not go.exists() and time.monotonic() < deadline:
    time.sleep(0.005)
print(native.build_library(out), flush=True)
"""


def test_two_processes_build_one_library(tmp_path, monkeypatch):
    """Two processes build into one fresh directory at once: both return
    the same complete library, no temporary file is left, and it loads."""
    out, go = tmp_path / "build", tmp_path / "go"
    pkg = Path(tnative.__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(out),
                               str(go), str(pkg)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "ready"
        go.touch()
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
    so = tnative.library_path(out)
    assert {stdout.strip() for stdout, _ in results} == {str(so)}
    assert [f.name for f in out.iterdir()] == [so.name]
    lib = tnative.load_library(so)
    assert not lib.bb25_load_jsonl(str(tmp_path / "none.jsonl").encode())
    # The library for this source and these flags is reused, not rebuilt;
    # other flags name another library.
    mtime = so.stat().st_mtime
    time.sleep(0.01)
    assert tnative.build_library(out) == so
    assert so.stat().st_mtime == mtime
    monkeypatch.setattr(tnative, "CXX_FLAGS", [*tnative.CXX_FLAGS, "-g"])
    assert tnative.library_path(out) != so
