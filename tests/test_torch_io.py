"""PyTorch port: ``utils/io.py`` checkpoints across the two packages,
and ``compat.install()``.

Every model kind is saved by one package and loaded by the other, both
ways; the loaded state must equal the saved one exactly (the archive
holds float64 numbers and arrays; the two values each package derives
from them, a logit and a decay rate, within rtol 1e-15) and compute
the same outputs (rtol 1e-12). A scorer saved by either package loads
in the other and retrieves the same ids as the scorer it was saved
from, with
probabilities within 1e-6 across packages (the scorers' own parity,
``test_torch_scorer.py``) and equal within one package. The JAX
package's older archive variants load in the port as in JAX.
``compat.install()`` of the port runs under a fixture that uninstalls
it, so nothing leaks into other tests.
"""

import sys
import types

import numpy as np
import pytest
import torch

import bayesian_bm25_tpu as jbb
from bayesian_bm25_tpu.utils import io as jio
import bayesian_bm25_tpu_torch as tbb
from bayesian_bm25_tpu_torch import compat
from bayesian_bm25_tpu_torch.utils import convert
from bayesian_bm25_tpu_torch.utils import io as tio

CPU = dict(device="cpu")


def _jax_models():
    """One JAX model of each kind with its whole state set from a seed."""
    rng = np.random.default_rng(1)
    tr = jbb.BayesianProbabilityTransform(0.7, 1.3, base_rate=0.02)
    tr._training_mode, tr._n_updates = "prior_free", 4
    tr._grad_alpha_ema, tr._grad_beta_ema = 0.01, -0.02
    tr._alpha_avg, tr._beta_avg = 0.69, 1.31
    temporal = jbb.TemporalBayesianTransform(1.1, 0.4, decay_half_life=50.0)
    temporal._timestamp, temporal._n_updates = 12, 3
    learn = jbb.LearnableLogOddsWeights(3, alpha=0.5, base_rate=0.1)
    learn._logits = rng.normal(size=3)
    learn._grad_logits_ema = rng.normal(size=3)
    learn._weights_avg = np.array([0.2, 0.3, 0.5])
    learn._n_updates = 7
    attn = jbb.AttentionLogOddsWeights(2, 4, normalize=True, base_rate=0.3)
    attn._W, attn._b = rng.normal(size=(2, 4)), rng.normal(size=2)
    attn._W_avg, attn._b_avg = rng.normal(size=(2, 4)), rng.normal(size=2)
    attn._grad_W_ema = rng.normal(size=(2, 4))
    attn._grad_b_ema = rng.normal(size=2)
    attn._n_updates = 9
    heads = jbb.MultiHeadAttentionLogOddsWeights(3, 2, 4, alpha=0.3)
    for h in heads.heads:
        h._W, h._b = rng.normal(size=(2, 4)), rng.normal(size=2)
        h._W_avg, h._b_avg = rng.normal(size=(2, 4)), rng.normal(size=2)
    platt = jbb.PlattCalibrator(1.7, -0.3)
    iso = jbb.IsotonicCalibrator()
    iso.fit(rng.normal(size=200), rng.uniform(size=200) < 0.4)
    return {"transform": tr, "temporal": temporal, "learnable": learn,
            "attention": attn, "multihead": heads, "platt": platt,
            "isotonic": iso}


def _state(model):
    """A model's whole state, the same way for either package."""
    if hasattr(model, "alpha") and hasattr(model, "_training_mode"):
        return convert.transform_to_numpy(model)
    if hasattr(model, "_heads") or hasattr(model, "_logits") or hasattr(
            model, "_W"):
        return convert.weights_to_numpy(model)
    if hasattr(model, "a"):
        return {"a": model.a, "b": model.b}
    return {"x": convert.array_to_numpy(model._x),
            "y": convert.array_to_numpy(model._y)}


# Recomputed by each package from the archived numbers (log, logit).
DERIVED = ("_logit_base_rate", "_decay_rate")


def _assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "heads":
            for ha, hb in zip(a[k], b[k]):
                _assert_same_state(ha, hb)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(b[k], np.float64),
                                          np.asarray(a[k], np.float64))
        elif k in DERIVED:
            assert b[k] == pytest.approx(a[k], rel=1e-15), k
        else:
            assert a[k] == b[k], k


def _outputs(model):
    rng = np.random.default_rng(2)
    if hasattr(model, "_training_mode"):
        s = rng.uniform(0, 5, 20)
        return model.score_to_probability(s, np.ones(20), np.ones(20))
    p = rng.uniform(0.05, 0.95, (20, 2 if not hasattr(model, "_logits")
                                 else 3))
    if hasattr(model, "_logits"):
        return model(p)
    if hasattr(model, "_heads") or hasattr(model, "_W"):
        return model(p, rng.normal(size=(20, 4)))
    return model.calibrate(rng.normal(size=20))


KINDS = list(_jax_models())


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saves_port_loads(tmp_path, kind):
    j = _jax_models()[kind]
    path = str(tmp_path / f"{kind}.npz")
    jio.save_model(path, j)
    t = tio.load_model(path, **CPU)
    assert type(t).__name__ == type(j).__name__
    assert t.device == torch.device("cpu")
    _assert_same_state(_state(j), _state(t))
    np.testing.assert_allclose(_outputs(t), _outputs(j), rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_port_saves_jax_loads(tmp_path, kind):
    first = str(tmp_path / "first.npz")
    jio.save_model(first, _jax_models()[kind])
    t = tio.load_model(first, **CPU)
    path = str(tmp_path / f"{kind}.npz")
    tio.save_model(path, t)
    j = jio.load_model(path)
    _assert_same_state(_state(t), _state(j))
    np.testing.assert_allclose(_outputs(j), _outputs(t), rtol=1e-12)
    # The port's own round trip.
    _assert_same_state(_state(t), _state(tio.load_model(path, **CPU)))


def test_model_errors(tmp_path):
    with pytest.raises(TypeError, match="Unsupported"):
        tio.save_model(str(tmp_path / "x.npz"), object())
    with pytest.raises(ValueError, match="fitted"):
        tio.save_model(str(tmp_path / "x.npz"), tbb.IsotonicCalibrator(**CPU))
    np.savez(str(tmp_path / "bad.npz"), _meta=np.array(["nope", "1"]))
    with pytest.raises(ValueError, match="Unknown model kind"):
        tio.load_model(str(tmp_path / "bad.npz"), **CPU)


def _corpus(seed, n, V, L):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(n)]


CORPUS = _corpus(0, 600, 900, 60)
SMALL_VOCAB = _corpus(2, 300, 150, 40)
QUERIES = [[f"t{t}" for t in np.random.default_rng(3).zipf(1.3, 5) % 900]
           for _ in range(40)] + [[], ["oov"]]


@pytest.fixture
def small_budget(monkeypatch):
    from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer

    for cls in (JaxScorer, tbb.BayesianBM25Scorer):
        monkeypatch.setattr(cls, "_SPLIT_BUDGET_BYTES", 2_000_000)


def _jax_scorer(kind):
    kw = dict(base_rate=0.01)
    if kind == "int8":
        kw["impact_storage"] = "int8"
    s = jbb.BayesianBM25Scorer(**kw)
    if kind == "texts":
        s.index_texts([" ".join(d) + " running runs" for d in CORPUS],
                      stem="snowball")
    else:
        s.index(SMALL_VOCAB if kind == "doc-major" else CORPUS,
                show_progress=False)
    if kind == "deleted":
        s.delete_documents([0, 5, 77])
    return s


def _assert_retrieve_close(a, b, exact=False):
    (ai, ap), (bi, bp) = a, b
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_allclose(ap, bp, rtol=0, atol=0 if exact else 1e-6)


@pytest.mark.parametrize("kind", ["hilo", "int8", "doc-major", "deleted",
                                  "texts"])
def test_scorer_checkpoints_both_ways(small_budget, tmp_path, kind):
    j = _jax_scorer(kind)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_scorer(jpath, j)
    t = tio.load_scorer(jpath, device="cpu", prob_dtype=torch.float64)
    assert (t._split is None) == (j._split is None)
    assert t._impact_storage == j._impact_storage
    assert t._tok_opts == j._tok_opts
    np.testing.assert_array_equal(t.deleted_mask, j.deleted_mask)
    qs = QUERIES if kind != "doc-major" else [[f"t{i}" for i in range(5)]]
    ref = j.retrieve(qs, k=10)
    _assert_retrieve_close(t.retrieve(qs, k=10), ref)
    tio.save_scorer(tpath, t)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key])
    back = jio.load_scorer(tpath)
    _assert_retrieve_close(back.retrieve(qs, k=10), ref, exact=True)
    again = tio.load_scorer(tpath, device="cpu", prob_dtype=torch.float64)
    _assert_retrieve_close(again.retrieve(qs, k=10), t.retrieve(qs, k=10),
                           exact=True)
    if kind == "texts":
        _assert_retrieve_close(t.retrieve_texts(["t1 running", "t7"], k=5),
                               j.retrieve_texts(["t1 running", "t7"], k=5))


@pytest.mark.parametrize("drop", ["vocab_offsets", "kernel_cfg",
                                  "score_scale", "delta", "tok_opts",
                                  "deleted_ids"])
def test_older_archive_variants(small_budget, tmp_path, drop):
    j = _jax_scorer("deleted")
    full = str(tmp_path / "full.npz")
    jio.save_scorer(full, j)
    with np.load(full) as data:
        arrays = {k: data[k] for k in data.files if k != drop}
    if drop == "vocab_offsets":
        terms = [None] * j.bm25_index.n_terms
        for tok, tid in j.bm25_index.vocab.items():
            terms[tid] = tok
        arrays["vocab_blob"] = np.frombuffer(
            "\n".join(terms).encode("utf-8"), dtype=np.uint8)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **arrays)
    jl = jio.load_scorer(old)
    tl = tio.load_scorer(old, device="cpu", prob_dtype=torch.float64)
    assert tl.bm25_index.vocab == jl.bm25_index.vocab
    assert tl._tok_opts == jl._tok_opts
    np.testing.assert_array_equal(tl.deleted_mask, jl.deleted_mask)
    _assert_retrieve_close(tl.retrieve(QUERIES, k=10),
                           jl.retrieve(QUERIES, k=10))


@pytest.mark.parametrize("kw", [dict(mesh=2), dict(n_devices=3),
                                dict(mesh_shape=(2, 4))])
def test_sharded_load_waits_for_the_sharding_slice(small_budget, tmp_path,
                                                   kw):
    """A JAX archive (with tombstones) loaded into a sharded scorer by
    ``mesh``, ``n_devices`` (3 shards: the doc axis re-pads from 2048 to
    6144) or ``mesh_shape``: equal to JAX's ``load_scorer`` of it on the
    same mesh (ids; probabilities within 1e-5, the JAX bodies' float32
    scalars) and to the port's single-device load (ids; probabilities
    equal where both hold the same split index)."""
    from bayesian_bm25_tpu.parallel import sharded as jsh
    from bayesian_bm25_tpu_torch.parallel import sharded as tsh

    path = str(tmp_path / "j.npz")
    jio.save_scorer(path, _jax_scorer("deleted"))
    if "mesh" in kw:
        jkw = dict(mesh=jsh.make_mesh(kw["mesh"]))
        tkw = dict(mesh=tsh.make_mesh(kw["mesh"], device="cpu"))
    else:
        jkw, tkw = kw, dict(kw, device="cpu")
    jl = jio.load_scorer(path, **jkw)
    tl = tio.load_scorer(path, prob_dtype=torch.float64, **tkw)
    single = tio.load_scorer(path, device="cpu", prob_dtype=torch.float64)
    assert isinstance(tl, tbb.ShardedBayesianBM25Scorer)
    assert tl.mesh.shape == dict(jl.mesh.shape)
    D_pad = tl.bm25_index.term_ids_host.shape[0]
    assert D_pad == (6144 if kw.get("n_devices") == 3 else 2048)
    assert D_pad == jl.bm25_index.term_ids_host.shape[0]
    np.testing.assert_array_equal(tl.deleted_mask, jl.deleted_mask)
    ti, tp = tl.retrieve(QUERIES, k=10)
    # At 6144 padded docs the small split budget admits no split (JAX's
    # choice too): the doc-major compare, within the hilo split's error.
    assert (tl._split is None) == (jl._split is None) == (D_pad == 6144)
    _assert_retrieve_close((ti, tp), single.retrieve(QUERIES, k=10),
                           exact=D_pad == 2048)
    ji, jp = jl.retrieve(QUERIES, k=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-5)


def test_scorer_errors(tmp_path):
    with pytest.raises(ValueError, match="indexed"):
        tio.save_scorer(str(tmp_path / "x.npz"),
                        tbb.BayesianBM25Scorer(**CPU))
    path = str(tmp_path / "m.npz")
    tio.save_model(path, tbb.PlattCalibrator(**CPU))
    with pytest.raises(ValueError, match="not a scorer"):
        tio.load_scorer(path, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tio.load_model(path)


@pytest.fixture
def compat_installed():
    yield compat
    compat.uninstall()
    assert "bayesian_bm25" not in sys.modules


def test_compat_install(compat_installed):
    compat.install()
    import bayesian_bm25
    from bayesian_bm25.vector_probability import VectorProbabilityTransform
    from bayesian_bm25.multi_field import MultiFieldScorer

    assert bayesian_bm25.BayesianBM25Scorer is tbb.BayesianBM25Scorer
    assert VectorProbabilityTransform is tbb.VectorProbabilityTransform
    assert MultiFieldScorer is tbb.MultiFieldScorer
    assert bayesian_bm25.scorer.BlockMaxIndex is tbb.BlockMaxIndex
    assert bayesian_bm25.fusion.LearnableLogOddsWeights is (
        tbb.LearnableLogOddsWeights)
    assert bayesian_bm25.__version__ == tbb.__version__
    for name in compat._TOP_LEVEL:
        assert getattr(bayesian_bm25, name) is getattr(tbb, name)
    compat.install()  # idempotent
    assert sys.modules["bayesian_bm25"].BayesianBM25Scorer is (
        tbb.BayesianBM25Scorer)


def test_compat_replaces_jax_alias_and_refuses_a_real_package(
        compat_installed):
    from bayesian_bm25_tpu import compat as jcompat

    jcompat.install()
    assert sys.modules["bayesian_bm25"].BayesianBM25Scorer is (
        jbb.BayesianBM25Scorer)
    compat.install()
    assert sys.modules["bayesian_bm25"].BayesianBM25Scorer is (
        tbb.BayesianBM25Scorer)
    compat.uninstall()
    real = types.ModuleType("bayesian_bm25")
    sys.modules["bayesian_bm25"] = real
    try:
        with pytest.raises(RuntimeError, match="real"):
            compat.install()
        compat.uninstall()  # leaves a real package alone
        assert sys.modules["bayesian_bm25"] is real
        compat.install(force=True)
        assert sys.modules["bayesian_bm25"] is not real
    finally:
        compat.uninstall()
        if sys.modules.get("bayesian_bm25") is real:
            del sys.modules["bayesian_bm25"]
