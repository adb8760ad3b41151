"""PyTorch port: the public ops take numpy arrays, lists and Python
scalars as the JAX package's ``jnp`` functions do, and the port's
``score_all_xla``, on the CPU.

Each op (``ops/mathx``, ``ops/density``, ``ops/fusion``, the gradients
of ``ops/fusion_learn``, ``engine/scoring``) is called three ways on the
same numpy-seeded values: with tensors, with numpy arrays and with
lists, Python floats in its scalar arguments, and with float32 arrays.
The array-like calls equal the tensor call bit for bit
(``mathx.as_input`` reads every array-like as float64, float32 arrays
too, as the JAX package's ``as_float`` does under x64), and all equal
the JAX package's (x64, the CPU) in dtype and within the tolerances of
``tests/test_torch_density.py``: rtol 1e-12 for the closed forms, 1e-9
for the EM fit. Array-likes with no tensor beside
them compute on the port's default device, the card; the tests make the
CPU the default, and one test holds the policy. ``score_all_xla`` is
bit-equal to JAX's on a seeded corpus with query counts 3, 5 and 7, and
launches no kernel.
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import scoring as jscoring
from bayesian_bm25_tpu.ops import density as JD
from bayesian_bm25_tpu.ops import fusion as JF
from bayesian_bm25_tpu.ops import fusion_learn as JL
from bayesian_bm25_tpu.ops import mathx as JM
from bayesian_bm25_tpu_torch.engine import cuda_bm25
from bayesian_bm25_tpu_torch.engine import index as tidx
from bayesian_bm25_tpu_torch.engine import scoring as tscoring
from bayesian_bm25_tpu_torch.ops import density as PD
from bayesian_bm25_tpu_torch.ops import fusion as PF
from bayesian_bm25_tpu_torch.ops import fusion_learn as PL
from bayesian_bm25_tpu_torch.ops import mathx as PM

from torch_helpers import one_thread  # noqa: F401

RNG = np.random.default_rng(13)
Z = RNG.normal(0, 3, (5, 4))
SEG = np.array([0, 0, 1, 2, 2])
D = np.concatenate([RNG.normal(0.25, 0.04, 30), RNG.normal(0.8, 0.1, 90)])
W = RNG.uniform(0, 1, D.shape[0])
E = np.linspace(0.0, 1.2, 25)
MASK = (RNG.uniform(size=D.shape[0]) < 0.9).astype(np.float64)
PROBS = RNG.uniform(0.05, 0.95, (30, 3))
XL = np.log(PROBS / (1 - PROBS))
Y = RNG.integers(0, 2, 30).astype(np.float64)
QF = RNG.normal(0, 1, (30, 2))
AW, AB = RNG.normal(0, 0.5, (3, 2)), RNG.normal(0, 0.2, 3)
COS = RNG.uniform(-1, 1, 30)
FW = np.array([0.2, 0.3, 0.5])

# (name, the port's op, JAX's, arguments, keyword arguments, rtol)
OPS = [
    ("stable_softmax", PM.stable_softmax, JM.stable_softmax, (Z,), {}, 1e-12),
    ("stable_softmax_dim0", PM.stable_softmax, JM.stable_softmax, (Z, 0), {},
     1e-12),
    ("min_max_normalize", PM.min_max_normalize, JM.min_max_normalize, (Z,),
     {}, 1e-12),
    ("min_max_normalize_dim", PM.min_max_normalize, JM.min_max_normalize,
     (Z, -2), {}, 1e-12),
    ("segment_min_max_normalize", PM.segment_min_max_normalize,
     JM.segment_min_max_normalize, (Z, SEG, 3), {}, 1e-12),
    ("gaussian_pdf", PD.gaussian_pdf, JD.gaussian_pdf, (D, 0.25, 0.04), {},
     1e-12),
    ("gaussian_pdf_float", PD.gaussian_pdf, JD.gaussian_pdf, (0.3, 0.0, 1.0),
     {}, 1e-12),
    ("silverman_bandwidth", PD.silverman_bandwidth, JD.silverman_bandwidth,
     (D, W), {}, 1e-12),
    ("kernel_density", PD.kernel_density, JD.kernel_density,
     (E, D, W, 0.05), {}, 1e-12),
    ("gmm_fixed_background", PD.gmm_fixed_background,
     JD.gmm_fixed_background, (D, 0.8, 0.1, 0.3, 0.08, 0.3), {"mask": MASK},
     1e-9),
    ("detect_gap_index", PD.detect_gap_index, JD.detect_gap_index, (D,), {},
     0),
    ("gap_weights", PD.gap_weights, JD.gap_weights, (D,), {}, 0),
    ("sharpen_weights", PD.sharpen_weights, JD.sharpen_weights, (W, 0.1), {},
     1e-12),
    ("distance_density_weights", PD.distance_density_weights,
     JD.distance_density_weights, (D,), {}, 1e-12),
    ("cosine_to_probability", PF.cosine_to_probability,
     JF.cosine_to_probability, (COS,), {}, 1e-12),
    ("prob_not", PF.prob_not, JF.prob_not, (PROBS,), {}, 1e-12),
    ("prob_and", PF.prob_and, JF.prob_and, (PROBS,), {}, 1e-12),
    ("prob_or", PF.prob_or, JF.prob_or, (PROBS,), {}, 1e-12),
    ("apply_gating", PF.apply_gating, JF.apply_gating, (XL, "swish", 2.0),
     {}, 1e-12),
    ("log_odds_conjunction", PF.log_odds_conjunction,
     JF.log_odds_conjunction, (PROBS,), {"weights": FW}, 1e-12),
    ("balanced_log_odds_fusion", PF.balanced_log_odds_fusion,
     JF.balanced_log_odds_fusion, (PROBS[:, 0], COS), {}, 1e-12),
    ("learnable_grads", PL._learnable_grads, JL._learnable_grads,
     (Z[0, :3], XL, Y, 1.5, None), {}, 1e-12),
    ("attention_grads", PL._attention_grads, JL._attention_grads,
     (JL.AttentionParams(AW, AB), XL, Y, QF, 3 ** 0.5, None), {}, 1e-12),
]


@pytest.fixture
def cpu_default(monkeypatch):
    """The port's default device (the card) is the CPU here."""
    def on_cpu(device=None):
        return torch.device("cpu" if device is None else device)

    for mod in (PM, tscoring):
        monkeypatch.setattr(mod, "resolve_device", on_cpu)


def _convert(args, how):
    """Arrays (also inside tuples) as tensors, numpy or lists; or their
    floating ones rounded to float32, as numpy (``float32``) or as
    float64 tensors of those values (``tensor32``); a Python float in
    the first argument as a 0-dim tensor for the tensor calls."""
    def one(a, first):
        if isinstance(a, tuple):
            parts = [one(b, False) for b in a]
            return a._make(parts) if hasattr(a, "_make") else tuple(parts)
        if isinstance(a, np.ndarray):
            if how in ("float32", "tensor32") and a.dtype.kind == "f":
                a = a.astype(np.float32)
            return {"tensor": torch.from_numpy(a), "numpy": a,
                    "list": a.tolist(), "float32": a,
                    "tensor32": torch.from_numpy(a).to(
                        torch.float64 if a.dtype.kind == "f"
                        else torch.int64)}[how]
        if first and isinstance(a, float) and how.startswith("tensor"):
            return torch.tensor(a, dtype=torch.float64)
        return a

    return tuple(one(a, i == 0) for i, a in enumerate(args))


def _arrays(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def _call(op, args, kwargs, how):
    return op(*_convert(args, how),
              **dict(zip(kwargs, _convert(tuple(kwargs.values()), how))))


# JAX's private _attention_grads converts nothing: with float32 arrays
# it forms qf @ W.T + b in float32 before its softmax goes to float64;
# the port converts at entry and forms it in float64 (float32's epsilon
# is 1.2e-7).
RTOL_F32 = {"attention_grads": 1e-6}


@pytest.mark.parametrize("how", ["numpy", "list", "float32"])
@pytest.mark.parametrize("name, port, jax_op, args, kwargs, rtol", OPS,
                         ids=[o[0] for o in OPS])
def test_array_likes_equal_the_tensor_call_and_jax(cpu_default, how, name,
                                                   port, jax_op, args,
                                                   kwargs, rtol):
    f32 = how == "float32"
    got = _call(port, args, kwargs, how)
    want = _call(port, args, kwargs, "tensor32" if f32 else "tensor")
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got_t, want_t):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert torch.equal(g, w), name
    jax_out = _call(jax_op, args, kwargs, how) if f32 else jax_op(*args,
                                                                  **kwargs)
    for g, j in zip(_arrays(got), _arrays(jax_out)):
        assert g.dtype == j.dtype, name
        # atol 1e-300: XLA on the CPU flushes subnormal results to zero.
        np.testing.assert_allclose(g, j, rtol=RTOL_F32.get(name, rtol) if f32
                                   else rtol, atol=1e-300)


def test_array_likes_alone_go_to_the_card():
    """With no tensor argument an op computes on the default device: the
    card, which raises here, as every entry point of the port does
    without CUDA."""
    if torch.cuda.is_available():
        assert PM.stable_softmax(Z).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.stable_softmax(Z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PD.gaussian_pdf(0.3, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PF.prob_and(PROBS)
    x = torch.from_numpy(D)
    assert PD.kernel_density(x, D, W, 0.05).device == x.device


def _scoring_inputs():
    rng = np.random.default_rng(5)
    corpus = [[f"w{t}" for t in rng.zipf(1.3, size=40) % 150]
              for _ in range(300)]
    queries = [[f"w{t}" for t in rng.zipf(1.3, size=6) % 150]
               for _ in range(20)]
    queries += [["w1"] * 3 + ["w90"] * 5 + ["w7"] * 7, [], ["zzz-oov"]]
    j = jidx.build_index(corpus)
    t = tidx.build_index(corpus, device="cpu")
    qids, qcnt = jidx.encode_queries(queries, j.vocab)
    return j, t, qids, qcnt


J_IDX, T_IDX, QIDS, QCNT = _scoring_inputs()


def test_score_all_xla_equals_jax_and_launches_no_kernel(monkeypatch):
    assert {3.0, 5.0, 7.0} <= set(np.unique(QCNT))

    def no_kernel(*args):
        raise AssertionError("score_all_xla reached the K5 wrapper")

    monkeypatch.setattr(cuda_bm25, "compare", no_kernel)
    before = cuda_bm25.launches
    js, jt = (np.asarray(a) for a in jscoring.score_all_xla(
        J_IDX.term_ids, J_IDX.weights, QIDS, QCNT))
    ts, tt = tscoring.score_all_xla(T_IDX.term_ids, T_IDX.weights, QIDS,
                                    QCNT)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (js > 0).sum() > 1000
    assert cuda_bm25.launches == before


def test_scoring_takes_numpy_operands(cpu_default):
    """score_all and probabilities_all with every operand numpy (on the
    default device) or the queries alone numpy (on the index's) equal
    the tensor call, and JAX's."""
    tensors = (T_IDX.term_ids, T_IDX.weights, torch.from_numpy(QIDS),
               torch.from_numpy(QCNT))
    arrays = tuple(t.numpy() for t in tensors)
    want = tscoring.score_all(*tensors)
    for args in (arrays, (*tensors[:2], QIDS, QCNT)):
        for g, w in zip(tscoring.score_all(*args), want):
            assert torch.equal(g, w)
    js, _ = jscoring.score_all_xla(J_IDX.term_ids, J_IDX.weights, QIDS, QCNT)
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(js))

    rest = (J_IDX.avgdl, 0.9, 1.5, 0.01)
    dl = T_IDX.doc_lengths
    kw = dict(n_docs=T_IDX.n_docs, prob_dtype=torch.float64)
    want_p = tscoring.probabilities_all(*tensors[:2], dl, rest[0],
                                        *tensors[2:], *rest[1:], **kw)
    got_p = tscoring.probabilities_all(*arrays[:2], dl.numpy(), rest[0],
                                       *arrays[2:], *rest[1:], **kw)
    for g, w in zip(got_p, want_p):
        assert torch.equal(g, w)
    jp = jscoring.probabilities_all(
        J_IDX.term_ids, J_IDX.weights, J_IDX.doc_lengths, J_IDX.avgdl, QIDS,
        QCNT, *rest[1:], n_docs=J_IDX.n_docs)[0]
    np.testing.assert_allclose(got_p[0].numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("bad", ["int64_ids", "float64_weights"])
def test_score_all_passes_table_tensors_through(bad):
    """Table tensors reach K5's wrapper as they are given: one of the
    wrong dtype is refused there, not cast (numpy operands alone are
    converted)."""
    ids, w = T_IDX.term_ids, T_IDX.weights
    if bad == "int64_ids":
        ids = ids.long()
    else:
        w = w.double()
    with pytest.raises(ValueError, match="compare: table_"):
        tscoring.score_all(ids, w, torch.from_numpy(QIDS),
                           torch.from_numpy(QCNT))
