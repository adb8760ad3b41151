"""PyTorch port: host-side index build and encoders against JAX.

The port carries its own numpy host code (importing anything from the
JAX package loads jax), pinned here bit-for-bit to the JAX package's on
one seeded corpus: doc-major tables, the frequency-split index in all
four storage modes (bf16 arrays compared through their uint16 bits), the
tier-2 and overflow tables, and every host encoder and split of the
retrieve path. Also: the state converter round-trips, and importing the
port leaves jax unloaded.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=48, V=900):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    return qs + [["t1", "t1", "t2"], ["zzz-oov"], [], [f"t{V - 1}"]]


CORPUS = _corpus()


def _assert_state_equal(a: dict, b: dict, path=""):
    assert a.keys() == b.keys(), path
    for key in a:
        x, y = a[key], b[key]
        where = f"{path}{key}"
        if isinstance(x, dict):
            _assert_state_equal(x, y, where + ".")
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, where
            assert x.dtype == y.dtype, (where, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=where)
        else:
            assert x == y, (where, x, y)


@pytest.mark.parametrize("method", ["robertson", "lucene", "atire",
                                    "bm25l", "bm25+"])
def test_build_index_bit_equal(method):
    j = jidx.build_index(CORPUS, method=method)
    t = tidx.build_index(CORPUS, method=method, device="cpu")
    assert t.vocab == j.vocab
    for name in ("n_docs", "n_terms", "avgdl", "max_doc_terms"):
        assert getattr(t, name) == getattr(j, name)
    for name in ("term_ids", "weights", "doc_lengths"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    for name in ("doc_frequencies", "idf", "term_ids_host",
                 "term_counts_host", "weights_host", "doc_lengths_host"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def _split_pair(storage, monkeypatch=None, budget=None, overflow="auto",
                n_frequent=256):
    if budget is not None:
        monkeypatch.setattr(jsidx, "_POSTINGS_MAX_ENTRIES", budget)
        monkeypatch.setattr(tsidx, "_POSTINGS_MAX_ENTRIES", budget)
    j = jsidx.build_split_index(jidx.build_index(CORPUS), n_frequent,
                                storage=storage, enable_overflow=overflow)
    t = tsidx.build_split_index(tidx.build_index(CORPUS, device="cpu"),
                                n_frequent, storage=storage,
                                enable_overflow=overflow)
    return j, t


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16", "f32"])
def test_build_split_index_bit_equal(storage):
    j, t = _split_pair(storage)
    _assert_state_equal(convert.split_index_to_numpy(t),
                        convert.split_index_to_numpy(j))
    assert t.post2_doc_ids is None


def test_split_tier2_and_overflow_bit_equal(monkeypatch):
    j, t = _split_pair("int8", monkeypatch, budget=20000, overflow=True,
                       n_frequent=128)
    assert j.post2_doc_ids is not None and j.over_term_ids is not None
    _assert_state_equal(convert.split_index_to_numpy(t),
                        convert.split_index_to_numpy(j))


def test_host_encoders_equal(monkeypatch):
    j, t = _split_pair("int8", monkeypatch, budget=20000)
    for name in ("_LH_MIN_SAVE", "_LHB_MIN_SAVE"):
        monkeypatch.setattr(jsidx, name, 0)
        monkeypatch.setattr(tsidx, name, 0)
    for name in ("_LH_MIN_RATIO", "_LHB_MIN_RATIO"):
        monkeypatch.setattr(jsidx, name, 1.0)
        monkeypatch.setattr(tsidx, name, 1.0)
    qs = _queries()
    enc_j = jsidx.encode_queries_split(qs, j)
    enc_t = tsidx.encode_queries_split(qs, t)
    for a, b in zip(enc_t, enc_j):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    A_t, B_t = tsidx.split_tail_groups(*enc_t[2:], t)
    A_j, B_j = jsidx.split_tail_groups(*enc_j[2:], j)
    assert B_j is not None
    for a, b in zip(A_t + B_t, A_j + B_j):
        np.testing.assert_array_equal(a, b)
    lh_t = tsidx.split_light_heavy(*A_t, t, 10)
    lh_j = jsidx.split_light_heavy(*A_j, j, 10)
    assert lh_j is not None
    for gt, gj in zip(lh_t, lh_j):
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a, b)
    lhb_t = tsidx.split_light_heavy_b(*B_t, t, 10)
    lhb_j = jsidx.split_light_heavy_b(*B_j, j, 10)
    assert (lhb_t is None) == (lhb_j is None)
    for gt, gj in zip(lhb_t or (), lhb_j or ()):
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a, b)
    R = t.post_doc_ids.shape[0] - 1
    pt, rt = tsidx.compact_tail_postings(A_t[1], A_t[2], R)
    pj, rj = jsidx.compact_tail_postings(A_j[1], A_j[2], R)
    assert rt == rj
    np.testing.assert_array_equal(pt, pj)
    assert tsidx.candidate_cap(t, A_t[1], 10) == jsidx.candidate_cap(
        j, A_j[1], 10)
    assert tsidx.candidate_cap2(t, B_t[1], B_t[3], 10) == \
        jsidx.candidate_cap2(j, B_j[1], B_j[3], 10)
    assert tsidx._q_int8_ok(t, enc_t[1]) == jsidx._q_int8_ok(j, enc_j[1])
    assert not tsidx._q_int8_ok(t, np.full((1, 8), 128.0, np.float32))


def test_query_term_pairs_equal():
    j = jidx.build_index(CORPUS)
    qs = _queries()
    pj = jidx.query_term_pairs(qs, j.vocab)
    pt = tidx.query_term_pairs(qs, j.vocab)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    assert tidx.query_term_pairs([["zzz-oov"], []], j.vocab) is None
    assert (tidx.DOC_PAD, tidx.QUERY_PAD) == (jidx.DOC_PAD, jidx.QUERY_PAD)


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_convert_round_trips(storage):
    j, t = _split_pair(storage)
    state_j = convert.split_index_to_numpy(j)
    # JAX -> port: the port's arrays equal the JAX package's
    from_j = convert.split_index_from_numpy(state_j, "cpu")
    _assert_state_equal(convert.split_index_to_numpy(from_j), state_j)
    if storage == "hilo":
        assert from_j.dense_impact.dtype.is_floating_point
        assert str(from_j.dense_impact.dtype) == "torch.bfloat16"
    # port -> numpy -> port is the identity
    again = convert.split_index_from_numpy(
        convert.split_index_to_numpy(t), "cpu")
    _assert_state_equal(convert.split_index_to_numpy(again),
                        convert.split_index_to_numpy(t))


def test_convert_doc_major_round_trip():
    """The JAX package's doc-major ``build_index`` arrays carried to the
    port, and a scorer with no split index built from them."""
    j = jidx.build_index(CORPUS[:200], method="bm25l")
    state_j = convert.index_to_numpy(j)
    assert "base" not in state_j and state_j["term_ids"].dtype == np.int32
    from_j = convert.index_from_numpy(state_j, "cpu")
    _assert_state_equal(convert.index_to_numpy(from_j), state_j)
    again = convert.index_from_numpy(convert.index_to_numpy(from_j), "cpu")
    _assert_state_equal(convert.index_to_numpy(again), state_j)
    scorer = convert.scorer_from_numpy(state_j, 0.8, 1.0, 0.01, device="cpu")
    assert scorer._split is None and scorer.num_docs == 200
    assert scorer._index.method == "bm25l"
    assert (scorer.transform.alpha, scorer.transform.beta,
            scorer.base_rate) == (0.8, 1.0, 0.01)


@pytest.mark.parametrize("build", [
    lambda **kw: tidx.build_index(CORPUS[:8], **kw),
    lambda **kw: tidx.build_index_from_texts(["a small text", "another"],
                                             **kw)])
def test_builders_resolve_the_device_at_entry(build, monkeypatch):
    # Without CUDA the default device raises the port's own error, as
    # every other entry point does; an explicit CPU still builds.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build()
    idx = build(device="cpu")
    idx = idx[0] if isinstance(idx, tuple) else idx
    assert idx.term_ids.device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, bayesian_bm25_tpu_torch as p\n"
            "from bayesian_bm25_tpu_torch.utils import convert\n"
            "from bayesian_bm25_tpu_torch.engine import cuda_reduce, "
            "cuda_gather, cuda_topk, cuda_bm25, scoring, _cuda_build, "
            "native, tokenize, snowball\n"
            "from bayesian_bm25_tpu_torch.models import probability\n"
            "from bayesian_bm25_tpu_torch.ops import transform\n"
            "from bayesian_bm25_tpu_torch.ops import density\n"
            "from bayesian_bm25_tpu_torch.engine import ivf\n"
            "from bayesian_bm25_tpu_torch.models import multi_field, "
            "vector_probability\n"
            "from bayesian_bm25_tpu_torch.utils import diagnostics, io\n"
            "from bayesian_bm25_tpu_torch import compat\n"
            "compat.install()\n"
            "[getattr(p, n) for n in p.__all__]\n"
            "native.load()\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'bayesian_bm25_tpu' or "
            "m.startswith('bayesian_bm25_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
