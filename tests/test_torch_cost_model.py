"""PyTorch port: the sharded-retrieval cost model
(``bayesian_bm25_tpu_torch/parallel/cost_model.py``) against the JAX
package's, and pinned to the H100 stage times it is calibrated on.

(a) The same model: with the port's constants set to the JAX module's,
every public function returns the JAX package's numbers within rel 1e-12
over a grid of corpus sizes, shard counts 1-64, ``local_k``, extra merge
passes, ``matmul_passes`` and ``peak_flops``. (b) On its own constants,
each stage lands within 5% of the card's stage time at the point it is
calibrated on (``STAGE_MS``), and the other point reads off by the ratio
the module states. (c) The scaling properties of
``tests/test_cost_model.py``, on the H100 constants.
"""

import inspect
import math
import re

import pytest

from bayesian_bm25_tpu.parallel import cost_model as J
from bayesian_bm25_tpu_torch.parallel import cost_model as P

from torch_helpers import one_thread  # noqa: F401

CONSTANTS = ("PEAK_BF16_FLOPS", "PEAK_INT8_OPS", "HBM_BW", "ICI_BW",
             "MATMUL_EFF", "BMAX_BW", "EXTRACT_BW", "MERGE_REF_S",
             "MERGE_REF_CELLS", "TF_REF_S", "TF_REF_CELLS",
             "MERGE_BYTES_PER_CAND", "SBASE_GATHER_S_PER_ELEM")
FUNCTIONS = ("merge_pass_cost", "retrieval_cost", "scaling_table",
             "crossover_shards")
FIELDS = ("matmul", "selection", "merge", "tf_transform", "all_gather",
          "ici_bytes", "n_shards", "nq", "total")
EXTRA = ((256, 2058), (256, 8202))
# The unfused int8 path, on which the rates are calibrated.
INT8 = dict(matmul_passes=2, peak_flops=P.PEAK_INT8_OPS)


def _close(a, b, rel=1e-12):
    if isinstance(a, int) and isinstance(b, int):
        return a == b
    return a == pytest.approx(b, rel=rel, abs=0)


@pytest.fixture
def jax_constants(monkeypatch):
    for name in CONSTANTS:
        monkeypatch.setattr(P, name, getattr(J, name))


def test_public_surface_is_jax_s():
    for name in CONSTANTS + FUNCTIONS + ("StageCosts",):
        assert hasattr(P, name), name
    for name in FUNCTIONS:
        jp = inspect.signature(getattr(J, name)).parameters
        pp = inspect.signature(getattr(P, name)).parameters
        assert list(jp) == list(pp), name
        for arg, par in jp.items():
            want = par.default
            if arg == "peak_flops":   # each package's own bf16 peak
                assert want == J.PEAK_BF16_FLOPS
                want = P.PEAK_BF16_FLOPS
            assert pp[arg].default == want, (name, arg)
    assert list(inspect.signature(J.StageCosts).parameters) == list(
        inspect.signature(P.StageCosts).parameters)
    assert set(J.StageCosts(1, 2, 3, 4, 5, 6, 7).breakdown()) == set(
        P.StageCosts(1, 2, 3, 4, 5, 6, 7).breakdown())


def test_module_imports_no_jax_and_cites_no_tpu():
    src = inspect.getsource(P)
    assert "import jax" not in src and "bayesian_bm25_tpu." not in src
    for tpu in (r"\b197\b", r"\b394\b", r"\b819\b", "v5e", "TPU"):
        assert not re.search(tpu, src), tpu


@pytest.mark.parametrize("n_docs", [51_200, 1_000_000])
@pytest.mark.parametrize("extra", [(), EXTRA])
@pytest.mark.parametrize("local_k", [None, 5])
@pytest.mark.parametrize("mm", [dict(), dict(matmul_passes=1,
                                             peak_flops=J.PEAK_INT8_OPS)])
def test_retrieval_cost_equals_jax(jax_constants, n_docs, extra, local_k,
                                   mm):
    kw = dict(local_k=local_k, extra_passes=extra,
              peak_flops=mm.get("peak_flops", J.PEAK_BF16_FLOPS),
              matmul_passes=mm.get("matmul_passes", 2))
    if n_docs == 1_000_000:
        kw.update(nq=1024, K=1024, cand_cap=138, tail_row_frac=0.7)
    for s in range(1, 65):
        try:
            want = J.retrieval_cost(n_docs, n_shards=s, **kw)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)):
                P.retrieval_cost(n_docs, n_shards=s, **kw)
            continue
        got = P.retrieval_cost(n_docs, n_shards=s, **kw)
        for f in FIELDS:
            assert _close(getattr(got, f), getattr(want, f)), (s, f)
        assert got.breakdown().keys() == want.breakdown().keys()
        for key, v in want.breakdown().items():
            assert _close(got.breakdown()[key], v), (s, key)
        assert _close(got.throughput(777), want.throughput(777))


def test_merge_pass_table_and_crossover_equal_jax(jax_constants):
    for rows, cap in EXTRA + ((1, 11), (4096, 266)):
        for s in range(1, 65):
            for k in (1, 10):
                assert _close(P.merge_pass_cost(rows, cap, s, k),
                              J.merge_pass_cost(rows, cap, s, k))
    for n_docs in (51_200, 1_000_000):
        # peak_flops given: its default was bound to each module's own
        # peak when the function was defined.
        for kw in (dict(peak_flops=J.PEAK_BF16_FLOPS),
                   dict(extra_passes=EXTRA, local_k=5,
                        peak_flops=J.PEAK_INT8_OPS)):
            shards = (1, 2, 3, 4, 8, 16, 64)
            for got, want in zip(P.scaling_table(n_docs, shards, **kw),
                                 J.scaling_table(n_docs, shards, **kw)):
                assert got.keys() == want.keys()
                assert all(_close(got[k], want[k]) for k in want)
            for mx in (1, 8, 64, 1024):
                assert P.crossover_shards(n_docs, mx, **kw) == \
                    J.crossover_shards(n_docs, mx, **kw)


# -- (b) pinned to the card ----------------------------------------------------

def _ref_50k():
    rows, cap = P.REF_50K_MERGE
    return P.retrieval_cost(51_200, nq=8192, K=2048, k=10,
                            tail_row_frac=rows / 8192, cand_cap=cap, **INT8)


def _ref_1m(n_shards=1):
    rows, cap = P.REF_1M_TIER1
    return P.retrieval_cost(
        1_001_472, nq=1024, K=1024, k=10, n_shards=n_shards,
        tail_row_frac=rows / 1024, cand_cap=cap,
        extra_passes=P.REF_1M_EXTRA, **INT8)


def test_hardware_constants_are_the_h100_s():
    assert (P.PEAK_BF16_FLOPS, P.PEAK_INT8_OPS, P.PEAK_F32_FLOPS,
            P.HBM_BW) == (989e12, 1979e12, 67e12, 3.35e12)
    assert P.ICI_BW == 900e9
    assert 0 < P.MATMUL_EFF < 1


@pytest.mark.parametrize("stage", ["matmul", "selection", "merge",
                                   "tf_transform"])
def test_50k_stages_land_on_the_card_s(stage):
    want = P.STAGE_MS["50k"][stage] * 1e-3
    assert getattr(_ref_50k(), stage) == pytest.approx(want, rel=0.05)


def test_1m_wide_passes_land_on_the_card_s():
    m = P.STAGE_MS["1m"]
    got = sum(P.merge_pass_cost(rows, cap) for rows, cap in P.REF_1M_EXTRA)
    assert got == pytest.approx((m["merge_heavy"] + m["merge_tier2"])
                                * 1e-3, rel=0.05)


def test_1m_reads_off_by_the_stated_ratios():
    # One rate a stage, calibrated at (a): at (b) the model under-reads
    # the epilogue-bound matmul and the launch-bound light merge and tf,
    # and over-reads the selection (module docstring).
    m, c = P.STAGE_MS["1m"], _ref_1m()
    rows, cap = P.REF_1M_TIER1
    tier1 = P.MERGE_REF_S * rows * cap / P.MERGE_REF_CELLS * 1e3
    ratio = {"matmul": c.matmul * 1e3 / m["matmul"],
             "selection": c.selection * 1e3 / m["selection"],
             "tier1": tier1 / m["merge_tier1"],
             "tf": c.tf_transform * 1e3 / m["tf_transform"],
             "total": c.total * 1e3 / sum(m[s] for s in (
                 "matmul", "selection", "merge_tier1", "merge_heavy",
                 "merge_tier2", "tf_transform"))}
    want = {"matmul": 0.62, "selection": 1.72, "tier1": 0.10, "tf": 0.16,
            "total": 0.70}
    assert ratio == pytest.approx(want, abs=0.01)


def test_matmul_absorbs_the_epilogue():
    # At int8 peak the two products take ~1.74 ms of the ~10.8 measured.
    peak_ms = 2.0 * 8192 * 2048 * 51200 * 2 / P.PEAK_INT8_OPS * 1e3
    assert peak_ms == pytest.approx(1.736, rel=1e-3)
    assert _ref_50k().matmul * 1e3 > 5 * peak_ms


# -- (c) the scaling properties on the H100 constants --------------------------

REF = dict(n_docs=51_200, nq=8192, K=2048, k=10, **INT8)
KW = {k: v for k, v in REF.items() if k != "n_docs"}


def test_merge_traffic_accounting():
    for s in (2, 4, 8):
        c = P.retrieval_cost(**REF, n_shards=s)
        assert c.ici_bytes == 8192 * 10 * 16 * s
        assert c.breakdown()["ici_bytes_per_query"] == 10 * 16 * s
        assert c.all_gather == pytest.approx(
            8192 * 10 * 16 * (s - 1) / P.ICI_BW)


def test_local_k_halves_the_traffic():
    exact = P.retrieval_cost(**REF, n_shards=8)
    lean = P.retrieval_cost(**REF, n_shards=8, local_k=5)
    assert lean.ici_bytes == exact.ici_bytes // 2
    assert lean.all_gather == pytest.approx(exact.all_gather / 2)


@pytest.mark.parametrize("n_docs", [51_200, 1_000_000])
def test_speedup_monotone_never_superlinear(n_docs):
    rows = P.scaling_table(n_docs, shards=(1, 2, 4, 8), **KW)
    sp = [r["predicted_speedup"] for r in rows]
    assert sp[0] == pytest.approx(1.0)
    assert all(b > a for a, b in zip(sp, sp[1:]))
    assert all(r["efficiency"] <= 1.0 + 1e-9 for r in rows)


def test_efficiency_improves_with_corpus_size():
    small = P.scaling_table(51_200, shards=(8,), **KW)[0]["efficiency"]
    big = P.scaling_table(1 << 20, shards=(8,), **KW)[0]["efficiency"]
    assert big > small


def test_crossover_grows_with_corpus():
    for mx in (64, 4096):
        assert (P.crossover_shards(1 << 20, mx, **KW)
                >= P.crossover_shards(51_200, mx, **KW))


def test_sharding_shrinks_the_extra_passes():
    c1, c8 = _ref_1m(), _ref_1m(8)
    assert c1.merge > c8.merge * 4
    assert c1.total > c8.total
    assert all(math.isfinite(v) for v in c8.breakdown().values())


def test_guards():
    with pytest.raises(ValueError):
        P.retrieval_cost(51_200, n_shards=0)
    with pytest.raises(ValueError):
        # 64 shards of 800 docs cannot each return 1000 candidates
        P.retrieval_cost(51_200, n_shards=64, local_k=1000)
