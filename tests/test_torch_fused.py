"""PyTorch port: the fused matmul + block-max (K4) path against the JAX
package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_matmul.py does; the port's wrapper runs its plain
version on CPU tensors. Held to: int8 scores bit-equal (both evaluate
the epilogue as one fused multiply-add); hilo and bf16 scores within
1 ulp (the float products may add their few nonzero terms in another
order); maxima equal to the masked maxima of the returned scores; ids
and tf counts bit-equal; probabilities within 1.2e-7 (float64 transform
on both sides, returned as float32). ``approx=True`` selects exactly on
both split paths and equals the JAX package's ``lax.approx_max_k``
results on the CPU bit for bit.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import pallas_matmul as pm
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import cuda_matmul, cuda_reduce
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401

ALPHA, BETA, BASE_RATE = 0.8, 1.0, 0.01


def _port(a):
    """A JAX or numpy operand as a CPU tensor (bf16 kept bf16)."""
    return convert.array_from_numpy(convert.array_to_numpy(a), "cpu")


def _mats(rng, D, K, storage):
    """tests/test_pallas_matmul.py's operands: a sparse gamma impact
    matrix in the storage mode's form."""
    w = rng.gamma(2.0, 2.0, (D, K)).astype(np.float32)
    w[rng.random((D, K)) < 0.85] = 0.0
    if storage == "hilo":
        hi = jnp.asarray(w, jnp.bfloat16)
        lo = jnp.asarray(w - np.asarray(hi, np.float32), jnp.bfloat16)
        return hi, lo, None
    if storage == "int8":
        amax = np.abs(w).max(axis=1)
        s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = w / s[:, None]
        hi = np.clip(np.rint(q), -127, 127)
        resid = (q - hi) * s[:, None]
        rmax = np.abs(resid).max(axis=1)
        s2 = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
        lo = np.clip(np.rint(resid / s2[:, None]), -127, 127)
        return (jnp.asarray(hi.astype(np.int8)),
                jnp.asarray(lo.astype(np.int8)),
                jnp.asarray(np.stack([s, s2])))
    return jnp.asarray(w, jnp.bfloat16), None, None


def _within_ulp(got, want):
    want = np.asarray(want)
    return (np.abs(got.astype(np.float64) - want)
            <= np.spacing(np.abs(want).astype(np.float32))).all()


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16"])
def test_plain_k4_vs_pallas(storage):
    rng = np.random.default_rng(5)
    nq, D, K = 256, 2048, 128
    hi, lo, scale = _mats(rng, D, K, storage)
    qvec = rng.integers(0, 4, (nq, K)).astype(np.float32)
    n_docs = D - 700                       # the maxima's validity mask
    js, jb = (np.asarray(a) for a in pm.impact_matmul_bmax(
        jnp.asarray(qvec), hi, lo, scale, n_docs))
    ts, tb = cuda_matmul.impact_matmul_bmax(
        torch.from_numpy(qvec), _port(hi).t().contiguous(),
        None if lo is None else _port(lo).t().contiguous(),
        None if scale is None else _port(scale), n_docs)
    assert ts.shape == (nq, D) and tb.shape == (nq, D // 256)
    if storage == "int8":
        np.testing.assert_array_equal(ts.numpy(), js)
    else:
        assert _within_ulp(ts.numpy(), js)
    own = cuda_reduce.block_max_plain(ts, 256, valid_upto=n_docs)
    assert torch.equal(tb, own)
    np.testing.assert_array_equal(tb.numpy()[:, -2:], -np.inf)  # past n_docs
    assert _within_ulp(tb.numpy()[:, :-2], jb[:, :-2])


def test_single_f32_raises():
    w = torch.rand(2048, 128)
    wt = w.t().contiguous()                # the port takes (K, D)
    q = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="single"):
        cuda_matmul.impact_matmul_bmax(q, wt, None, None, 2048)
    with pytest.raises(ValueError):
        pm.impact_matmul_bmax(jnp.asarray(q.numpy()), jnp.asarray(w.numpy()),
                              None, None, 2048)
    # An empty residual is no pair, and a non-bf16 pair is refused.
    with pytest.raises(ValueError, match="single"):
        cuda_matmul.impact_matmul_bmax(q, wt, torch.zeros(0, 2048), None,
                                       2048)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_matmul.impact_matmul_bmax(q, wt, wt, None, 2048)


def test_eligibility_is_the_kernels_own():
    assert cuda_matmul.eligible(255, 130, 1024, 256)    # JAX: no
    assert not pm.eligible(255, 130, 1024, 256)
    assert not cuda_matmul.eligible(256, 128, 2048, 128)
    assert not cuda_matmul.eligible(256, 128, 2000, 256)
    assert not cuda_matmul.eligible(256, 1 << 16, 2048, 256)
    assert not cuda_matmul.eligible(256, 0, 2048, 256)


def _fused_split(storage):
    """TestSparseKernelFused's operands (tests/test_pallas_matmul.py):
    a 1,200-doc index, K = 128, 16 queries padded to 256."""
    rng = np.random.default_rng(9)
    corpus = [[f"t{t}" for t in rng.zipf(1.35, size=40) % 1200]
              for _ in range(1200)]
    idx = jidx.build_index(corpus)
    split = jsidx.build_split_index(idx, n_frequent=128, storage=storage)
    assert split.post_doc_ids is not None
    queries = [[f"t{t}" for t in rng.zipf(1.35, size=5) % 1200]
               for _ in range(14)] + [[], ["t1199"]]
    queries += [[]] * (256 - len(queries))
    return split, queries


@pytest.mark.parametrize("storage", ["hilo", "int8", "bf16"])
def test_sparse_fused_vs_jax(storage):
    split, queries = _fused_split(storage)
    idx = split.base
    fslots, fcnt, trows, tqids, tqcnt = jsidx.encode_queries_split(
        queries, split)
    tslots = jsidx.map_tail_slots(tqids, split)
    cap = jsidx.candidate_cap(split, tslots, 7)
    host = (fslots, fcnt, trows, tslots, tqcnt)
    jout = jsidx.retrieve_topk_split_sparse(
        split.dense_impact, split.dense_presence, split.post_doc_ids,
        split.post_weights, idx.doc_lengths, idx.avgdl,
        *(jnp.asarray(a) for a in host), 7, cap, ALPHA, BETA, BASE_RATE,
        n_docs=idx.n_docs, impact_lo=split.dense_impact_lo,
        impact_scale=split.impact_scale, tf_from_sign=split.post_w_positive,
        fused_mm=True)
    p = convert.split_index_from_numpy(convert.split_index_to_numpy(split),
                                       "cpu")
    tout = tsidx.retrieve_topk_split_sparse(
        p.dense_impact, p.dense_presence, p.post_doc_ids, p.post_weights,
        p.base.doc_lengths, p.base.avgdl,
        *(torch.from_numpy(np.asarray(a)) for a in host), 7, cap,
        ALPHA, BETA, BASE_RATE, n_docs=p.n_docs, impact_lo=p.dense_impact_lo,
        impact_scale=p.impact_scale, tf_from_sign=p.post_w_positive,
        fused_mm=True, prob_dtype=torch.float64,
        impact_cols=p.impact_columns())
    ji, jp, js, jt = (np.asarray(a) for a in jout)
    ti, tp, ts, tt = (a.numpy() for a in tout)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tt, jt)
    assert _within_ulp(ts, js)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1.2e-7)
    assert (ti[:14] >= 0).any()


# -- the scorer's gate ---------------------------------------------------------


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


CORPUS = _corpus()
_rng = np.random.default_rng(3)
QUERIES = [[f"t{t}" for t in _rng.zipf(1.3, size=6) % 900]
           for _ in range(252)] + [["t1", "t1", "t2"], ["zzz-oov"], [],
                                   ["t899"]]


@pytest.fixture
def k4_calls(monkeypatch):
    """K = 128 in both packages, and a spy on the port's K4 that records
    each call's n_docs."""
    for cls in (JaxScorer, BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)
    calls = []
    real = cuda_matmul.impact_matmul_bmax

    def spy(qvec, impact_t, impact_lo_t, impact_scale, n_docs):
        # The scorer hands K4 the index's kept column-major copy.
        assert impact_t.shape[0] == qvec.shape[1] and impact_t.is_contiguous()
        calls.append(n_docs)
        return real(qvec, impact_t, impact_lo_t, impact_scale, n_docs)

    monkeypatch.setattr(cuda_matmul, "impact_matmul_bmax", spy)
    return calls


@pytest.fixture
def fused(k4_calls, monkeypatch):
    """FUSED_MM on in both packages, and the K4 spy."""
    monkeypatch.setattr(jsidx, "FUSED_MM", True)
    monkeypatch.setattr(tsidx, "FUSED_MM", True)
    return k4_calls


def _stand_ins(device, storage, D=59392, K=2048):
    """(impact, impact_lo, impact_scale) as the route reads them: device,
    shape and dtype, without memory."""
    def mat(dtype, shape=(D, K)):
        return SimpleNamespace(device=torch.device(device), shape=shape,
                               dtype=dtype)

    bf16 = torch.bfloat16
    return {"int8": (mat(torch.int8), mat(torch.int8),
                     mat(torch.float32, (2, D))),
            "hilo": (mat(bf16), mat(bf16), None),
            "bf16": (mat(bf16), None, None),
            "f32": (mat(torch.float32), None, None)}[storage]


@pytest.mark.parametrize("flag, device, storage, D, kw, takes", [
    (None, "cuda", "int8", 59392, {}, True),
    (None, "cuda", "hilo", 59392, {}, True),
    (None, "cuda", "bf16", 59392, {}, True),
    (None, "cuda", "f32", 59392, {}, False),
    (None, "cuda", "bf16", 59392 + 8, {}, False),
    (None, "cuda", "int8", 59392, dict(doc_mask=np.ones(4, bool)), False),
    (None, "cuda", "int8", 59392, dict(approx=True), False),
    (None, "cuda", "int8", 59392, dict(coarse=True), False),
    (None, "cuda", "int8", 59392, dict(q_int8_ok=False), False),
    (None, "cpu", "int8", 59392, {}, False),
    (False, "cuda", "int8", 59392, {}, False),
    (True, "cpu", "int8", 59392, {}, True),
    (True, "cpu", "int8", 59392, dict(approx=True), False),
])
def test_fused_route_rule(monkeypatch, flag, device, storage, D, kw, takes):
    """cuda_matmul.fused_route, the one rule of both scorers: FUSED_MM
    None takes K4 on a card only, True and False force either route,
    and the rest of the gate refuses in every case."""
    monkeypatch.setattr(tsidx, "FUSED_MM", flag)
    assert cuda_matmul.fused_route(*_stand_ins(device, storage, D), 8192,
                                   **kw) is takes


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_default_route_on_the_cpu(k4_calls, storage, monkeypatch):
    """Under the default (FUSED_MM None) a scorer on the CPU takes the
    library product: no K4 call and no column-major copy. Forcing
    FUSED_MM on reaches K4's plain version, with the same answers."""
    assert tsidx.FUSED_MM is None
    t = BayesianBM25Scorer(alpha=ALPHA, beta=BETA, base_rate=BASE_RATE,
                           impact_storage=storage, device="cpu",
                           prob_dtype=torch.float64)
    t.index(CORPUS, show_progress=False)
    ids, probs = t.retrieve(QUERIES, k=10)
    assert k4_calls == [] and t._split._impact_cols is None
    monkeypatch.setattr(tsidx, "FUSED_MM", True)
    fi, fp = t.retrieve(QUERIES, k=10)
    assert k4_calls == [800]
    np.testing.assert_array_equal(fi, ids)
    np.testing.assert_allclose(fp, probs, rtol=0, atol=1e-7)


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_scorer_gate(fused, storage):
    kw = dict(alpha=ALPHA, beta=BETA, base_rate=BASE_RATE,
              impact_storage=storage)
    j = JaxScorer(**kw)
    j.index(CORPUS, show_progress=False)
    t = BayesianBM25Scorer(**kw, device="cpu", prob_dtype=torch.float64)
    t.index(CORPUS, show_progress=False)
    assert len(QUERIES) == 256          # JAX's fused rule: nq % 256 == 0
    assert pm.eligible(256, 128, 2048, 256)
    ji, jp = j.retrieve(QUERIES, k=10)
    ti, tp = t.retrieve(QUERIES, k=10)
    assert fused == [800]
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    fused.clear()
    mask = np.ones(800, bool)
    mask[::3] = False
    ids, _ = t.retrieve(QUERIES, k=10, doc_mask=mask)
    assert fused == [] and mask[ids[ids >= 0]].all()
    t.retrieve(QUERIES, k=10, approx=True)
    assert fused == []
    t.delete_documents([int(ti[0, 0])])
    ids, _ = t.retrieve(QUERIES, k=10)
    assert fused == [] and int(ti[0, 0]) not in ids
    t.restore_documents([int(ti[0, 0])])
    np.testing.assert_array_equal(t.retrieve(QUERIES, k=10)[0], ti)
    assert fused == [800]
    if storage == "int8":
        fused.clear()
        t.retrieve(QUERIES, k=10, coarse=True)
        assert fused == []


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_kept_layout_through_the_lifecycle(fused, storage):
    """K4's column-major copy equals the impact matrices transposed
    after index, after a delete and restore (kept, not rebuilt) and
    after add_documents (dropped with the old index, rebuilt from the
    grown one); a fused retrieve after add_documents finds the new
    documents and equals the JAX package."""
    kw = dict(alpha=ALPHA, beta=BETA, base_rate=BASE_RATE,
              impact_storage=storage)
    j = JaxScorer(**kw)
    t = BayesianBM25Scorer(**kw, device="cpu", prob_dtype=torch.float64)
    for s in (j, t):
        s.index(CORPUS[:600], show_progress=False)

    def held():
        s = t._split
        hi, lo = s.impact_columns()
        assert hi.is_contiguous() and lo.is_contiguous()
        assert torch.equal(hi, s.dense_impact.t())
        assert torch.equal(lo, s.dense_impact_lo.t())
        assert s.impact_columns()[0] is hi
        return hi

    ti, _ = t.retrieve(QUERIES, k=10)
    assert fused == [600]
    np.testing.assert_array_equal(ti, j.retrieve(QUERIES, k=10)[0])
    kept = held()
    t.delete_documents([1, 2])
    t.restore_documents([1, 2])
    assert held() is kept
    np.testing.assert_array_equal(t.retrieve(QUERIES, k=10)[0], ti)
    for s in (j, t):
        s.add_documents(CORPUS[600:], show_progress=False)
    assert t._split._impact_cols is None
    fused.clear()
    qs = [CORPUS[i][:4] for i in range(600, 800, 4)]
    ti, tp = t.retrieve(qs, k=10)
    assert fused == [800] and (ti >= 600).any()
    ji, jp = j.retrieve(qs, k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert held().shape == (128, t._split.dense_impact.shape[0])


def test_scorer_gate_skips_f32(fused):
    t = BayesianBM25Scorer(alpha=ALPHA, beta=BETA, base_rate=BASE_RATE,
                           impact_storage="f32", device="cpu")
    t.index(CORPUS, show_progress=False)
    t.retrieve(QUERIES[:8], k=10)
    assert fused == []


# -- approx=True ----------------------------------------------------------------


def _pair(storage="int8", postings=True):
    with pytest.MonkeyPatch.context() as mp:
        if not postings:
            for mod in (jsidx, tsidx):
                mp.setattr(mod, "_POSTINGS_MAX_ENTRIES", 0)
        split = jsidx.build_split_index(jidx.build_index(CORPUS), 128,
                                        storage=storage)
    assert (split.post_doc_ids is not None) == postings
    j = JaxScorer(base_rate=BASE_RATE)
    j._index, j._split = split.base, split
    j._transform = JaxTransform(ALPHA, BETA, BASE_RATE)
    t = convert.scorer_from_numpy(
        convert.split_index_to_numpy(split), ALPHA, BETA, BASE_RATE,
        device="cpu", prob_dtype=torch.float64)
    return j, t


@pytest.mark.parametrize("postings", [True, False])
def test_approx_selects_exactly(postings):
    """Sparse-candidate path (postings) and compare-tail path: ids,
    scores and tf bit-equal to JAX's approx=True."""
    j, t = _pair(postings=postings)
    qs = QUERIES[:60] + QUERIES[-4:]
    nq, ji, jp, js, jt = j._retrieve_launch(qs, 10, True, None)
    _, ti, tp, ts, tt = t._retrieve_launch(qs, 10, True, None)
    ji, jp, js, jt = (np.asarray(a)[:nq] for a in (ji, jp, js, jt))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1.2e-7)
    exact = t._retrieve_launch(qs, 10, False, None)
    assert torch.equal(exact[1], ti) and torch.equal(exact[3], ts)
