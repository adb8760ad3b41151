"""PyTorch port: sparse-candidate retrieval against the JAX package.

Both packages serve the same index state (carried from the JAX build
through utils/convert.py) with the same pinned transform, and run
``retrieve_topk_split_sparse`` through their scorers' launch paths on one
query set. Ids and tf counts must be bit-equal, scores too (the int8
epilogue is the same fused multiply-add; the float matmuls of the other
storage modes may round their few nonzero terms in another order, 1 ulp
at most). Probabilities are computed in float64 on both sides and
returned as float32: equal to 1 float32 ulp.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_bm25_tpu import BayesianBM25Scorer as JaxScorer
from bayesian_bm25_tpu.engine import index as jidx
from bayesian_bm25_tpu.engine import split_index as jsidx
from bayesian_bm25_tpu.models.probability import (
    BayesianProbabilityTransform as JaxTransform)
from bayesian_bm25_tpu_torch.engine import split_index as tsidx
from bayesian_bm25_tpu_torch.utils import convert

from torch_helpers import one_thread  # noqa: F401

ALPHA, BETA, BASE_RATE = 0.8, 1.0, 0.01


def _corpus(seed=0, D=800, V=900, L=80):
    rng = np.random.default_rng(seed)
    return [[f"t{t}" for t in rng.zipf(1.25, size=L) % V] for _ in range(D)]


def _queries(seed=1, n=60, V=900):
    rng = np.random.default_rng(seed)
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % V] for _ in range(n)]
    return qs + [["t1", "t1", "t2"], ["zzz-oov"], [], [f"t{V - 1}"]]


CORPUS = _corpus()
QUERIES = _queries()
MASK = np.ones(800, bool)
MASK[::3] = False


def _pair(storage, n_frequent=128, post_w_positive=None):
    """JAX scorer and port scorer (CPU) on one index state."""
    split = jsidx.build_split_index(jidx.build_index(CORPUS), n_frequent,
                                    storage=storage)
    if post_w_positive is not None:
        split.post_w_positive = post_w_positive
    j = JaxScorer(base_rate=BASE_RATE)
    j._index, j._split = split.base, split
    j._transform = JaxTransform(ALPHA, BETA, BASE_RATE)
    t = convert.scorer_from_numpy(
        convert.split_index_to_numpy(split), ALPHA, BETA, BASE_RATE,
        device="cpu", prob_dtype=torch.float64)
    return j, t


def _compare(j, t, k=10, doc_mask=None, coarse=False, exact_scores=True):
    nq, ji, jp, js, jt = j._retrieve_launch(
        QUERIES, k, False, None if doc_mask is None else doc_mask,
        coarse=coarse)
    _, ti, tp, ts, tt = t._retrieve_launch(QUERIES, k, False, doc_mask,
                                           coarse=coarse)
    ji, jp, js, jt = (np.asarray(a)[:nq] for a in (ji, jp, js, jt))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tt.numpy(), jt)
    if exact_scores:
        np.testing.assert_array_equal(ts.numpy(), js)
    else:
        ulp = np.spacing(np.abs(js).astype(np.float32))
        assert (np.abs(ts.numpy() - js) <= ulp).all()
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1.2e-7)
    assert tp.dtype == torch.float32 and ti.dtype == torch.int32
    return ti.numpy()


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16", "f32"])
def test_storage_modes(storage):
    j, t = _pair(storage)
    ids = _compare(j, t, exact_scores=storage == "int8")
    assert (ids >= 0).all()


def test_int8_coarse():
    j, t = _pair("int8")
    _compare(j, t, coarse=True)


def test_doc_mask():
    j, t = _pair("int8")
    ids = _compare(j, t, k=8, doc_mask=MASK)
    assert MASK[ids[ids >= 0]].all()


def test_tf_from_postings_operand():
    """The three-operand sort (tf co-sorted) when weights may be 0."""
    j, t = _pair("int8", post_w_positive=False)
    assert not t._split.post_w_positive
    _compare(j, t)


def test_dense_build(monkeypatch):
    monkeypatch.setattr(jsidx, "PACKED_BUILD", False)
    monkeypatch.setattr(tsidx, "PACKED_BUILD", False)
    j, t = _pair("int8")
    _compare(j, t)


def _force_splits(monkeypatch):
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_LH_MIN_SAVE", 0)
        monkeypatch.setattr(mod, "_LH_MIN_RATIO", 1.0)
        monkeypatch.setattr(mod, "_LHB_MIN_SAVE", 0)
        monkeypatch.setattr(mod, "_LHB_MIN_RATIO", 1.0)


def test_light_heavy(monkeypatch):
    _force_splits(monkeypatch)
    j, t = _pair("int8")
    s = t._split
    enc = tsidx.encode_queries_split(QUERIES, s)
    (tr, ts, tc), _ = tsidx.split_tail_groups(*enc[2:], s)
    assert tsidx.split_light_heavy(tr, ts, tc, s, 10) is not None
    _compare(j, t)


def test_tier2_groups_and_mask(monkeypatch):
    """Tier-2 postings, the group-B pass and its light/heavy split, with
    a doc_mask flowing through every pass."""
    _force_splits(monkeypatch)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    j, t = _pair("int8")
    assert t._split.post2_doc_ids is not None
    enc = tsidx.encode_queries_split(QUERIES, t._split)
    _, grpB = tsidx.split_tail_groups(*enc[2:], t._split)
    assert grpB is not None
    _compare(j, t)
    _compare(j, t, k=8, doc_mask=MASK)


def test_pass_recorder_sees_every_merge_pass(monkeypatch):
    """chip_smoke.py's 1M phase records the merge schedule by wrapping
    the split and merge functions: at toy size with the thresholds forced
    it sees the group-A light/heavy split, the group-B passes and the
    group-B split, one K2 shape per pass, and leaves the results and the
    module functions as they were."""
    import chip_smoke

    _force_splits(monkeypatch)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    _, t = _pair("int8")
    before = (tsidx.split_tail_groups, tsidx._sparse_merge)
    batches = [QUERIES, QUERIES[:30]]
    out, chunks = chip_smoke.record_passes(
        lambda: t.retrieve_many(batches, k=10))
    assert (tsidx.split_tail_groups, tsidx._sparse_merge) == before
    chip_smoke.require_passes(chunks, "toy")
    assert len(chunks) == 2
    for c in chunks:
        kinds = [p[0] for p in c["passes"]]
        assert kinds == ["tier-1", "heavy", "tier-2", "tier-2"]
        assert all(len(p) == 2 and p[1][1] >= 10 for p in c["passes"])
    for (ids, probs), (wi, wp) in zip(out, t.retrieve_many(batches, k=10)):
        np.testing.assert_array_equal(ids, wi)
        np.testing.assert_array_equal(probs, wp)
    # At the default thresholds the toy index splits nothing: the phase
    # would fail rather than pass without the passes it exists for.
    monkeypatch.undo()
    _, t = _pair("int8")
    _, chunks = chip_smoke.record_passes(lambda: t.retrieve_many(batches))
    assert not any(c["light_heavy"] or c["group_b"] for c in chunks)
    with pytest.raises(SystemExit):
        chip_smoke.require_passes(chunks, "toy")


@pytest.mark.parametrize("fused", [False, True])
def test_stage_ranges_cover_every_stage(monkeypatch, fused):
    """chip_smoke.staged (phase 20 and scripts/profile_torch_slice.py)
    wraps each stage of the split path in a profiler range: at toy size
    with every pass forced, the CPU profiler sees each stage, the results
    are unchanged, and the module functions come back."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from bayesian_bm25_tpu_torch.engine import cuda_matmul
    from bayesian_bm25_tpu_torch.ops import transform as T

    _force_splits(monkeypatch)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    monkeypatch.setattr(tsidx, "FUSED_MM", fused)
    _, t = _pair("int8")
    want = t.retrieve(QUERIES, k=10)
    before = (tsidx._impact_matmul, tsidx.exact_topk_blockwise,
              tsidx._sparse_merge, cuda_matmul.impact_matmul_bmax,
              tsidx._topk_from_bmax, tsidx._winner_tf_freq,
              T.score_to_probability)
    restore = chip_smoke.staged(tsidx)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = t.retrieve(QUERIES, k=10)
    finally:
        restore()
    assert (tsidx._impact_matmul, tsidx.exact_topk_blockwise,
            tsidx._sparse_merge, cuda_matmul.impact_matmul_bmax,
            tsidx._topk_from_bmax, tsidx._winner_tf_freq,
            T.score_to_probability) == before
    stages = {e.name[len(chip_smoke.STAGE):] for e in prof.events()
              if e.name.startswith(chip_smoke.STAGE)}
    assert stages == {"matmul", "leader selection", "merge tier-1",
                      "merge heavy", "merge tier-2", "tf + transform"}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_stage_device_ms_reads_the_launching_ranges():
    """chip_smoke.stage_device_ms credits each range with the device
    events whose runtime call it holds (matched by correlation id), an
    event whose call was not traced with the range's device span that
    holds it, and leaves the rest outside."""
    from types import SimpleNamespace as NS

    import chip_smoke

    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, kind, start, end, id=0):
        return NS(name=name, device_type=kind, id=id,
                  time_range=NS(start=float(start), end=float(end)))

    events = [
        ev("stage: matmul", cpu, 0, 100),
        ev("cudaLaunchKernel", cpu, 10, 12, id=1),
        ev("cudaLaunchKernel", cpu, 20, 22, id=2),
        ev("stage: leader selection", cpu, 100, 150),
        ev("cuLaunchKernel", cpu, 110, 111, id=3),
        ev("stage: leader selection", cpu, 150, 160),
        ev("cudaMemcpyAsync", cpu, 170, 171, id=5),
        # on the device: the kernels run long after their launches
        ev("stage: matmul", dev, 400, 9000),   # spans are not read ...
        ev("sm90_xmma_gemm_s8", dev, 400, 4400, id=1),
        ev("elementwise_kernel", dev, 4400, 5900, id=2),
        ev("block_max_kernel", dev, 5900, 6400, id=3),
        ev("stage: leader selection", dev, 6400, 6500),
        ev("topk_warp_kernel", dev, 6400, 6470, id=4),  # ... unless untraced
        ev("Memcpy DtoH", dev, 6600, 6630, id=5)]
    stages, rest = chip_smoke.stage_device_ms(events)
    assert stages == {
        "matmul": {"calls": 1, "gemm": 4.0, "other": 1.5},
        "leader selection": {"calls": 2, "K1 block_max": 0.5,
                             "K3 topk": 0.07}}
    assert rest == pytest.approx({"other": 0.03})


@pytest.mark.parametrize("fused", [False, True])
def test_stage_ranges_open_on_range_once_a_stage(monkeypatch, fused):
    """chip_smoke.staged's ``on_range`` (phase 20's CUDA events) wraps
    every stage call that no other stage call holds, once, with the
    stage's label, and the results are unchanged."""
    import chip_smoke

    _force_splits(monkeypatch)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    monkeypatch.setattr(tsidx, "FUSED_MM", fused)
    _, t = _pair("int8")
    want = t.retrieve(QUERIES, k=10)
    opened, depth = [], [0]

    @contextlib.contextmanager
    def on_range(label):
        depth[0] += 1
        assert depth[0] == 1
        opened.append(label)
        yield
        depth[0] -= 1

    restore = chip_smoke.staged(tsidx, on_range)
    try:
        got = t.retrieve(QUERIES, k=10)
    finally:
        restore()
    assert set(opened) == {"matmul", "leader selection", "merge tier-1",
                           "merge heavy", "merge tier-2", "tf + transform"}
    assert depth[0] == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_stage_ranges_follow_the_route_each_retrieve_takes(monkeypatch):
    """chip_smoke.staged wraps K4 and its leader selection whatever
    FUSED_MM reads when it is installed (None by default: K4 on the
    card), and each leader selection opens one range, none inside
    another, on either route."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    from bayesian_bm25_tpu_torch.engine import cuda_matmul

    _force_splits(monkeypatch)
    for mod in (jsidx, tsidx):
        monkeypatch.setattr(mod, "_POSTINGS_MAX_ENTRIES", 20000)
    _, t = _pair("int8")
    k4, opened = cuda_matmul.impact_matmul_bmax, []

    def on_range(label):
        opened.append(label)
        return contextlib.nullcontext()

    restore = chip_smoke.staged(tsidx, on_range)
    try:
        assert cuda_matmul.impact_matmul_bmax is not k4
        for fused in (False, True):
            monkeypatch.setattr(tsidx, "FUSED_MM", fused)
            opened.clear()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                t.retrieve(QUERIES, k=10)
            ranges = [e for e in prof.events() if e.name
                      == chip_smoke.STAGE + "leader selection"]
            assert len(ranges) == opened.count("leader selection") > 0
    finally:
        restore()


def test_launch_lag_reads_the_device_clock_against_the_host():
    """chip_smoke.launch_lag_ms: the least time from a runtime call to
    the start of the device event it launched, below 0 when the trace
    places a kernel before its launch; NaN with nothing launched."""
    from types import SimpleNamespace as NS

    import chip_smoke

    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, kind, start, id):
        return NS(name=name, device_type=kind, id=id,
                  time_range=NS(start=float(start), end=float(start) + 1))

    events = [ev("cudaLaunchKernel", cpu, 100, 1),
              ev("cuLaunchKernel", cpu, 200, 2),
              ev("aten::mm", cpu, 150, 2),
              ev("gemm", dev, 205, 2),
              ev("block_max_kernel", dev, 130, 1),
              ev("Memcpy HtoD", dev, 50, 9)]
    assert chip_smoke.launch_lag_ms(events) == pytest.approx(0.005)
    events.append(ev("topk_warp_kernel", dev, 1500, 3))
    events.append(ev("cudaLaunchKernel", cpu, 3500, 3))
    assert chip_smoke.launch_lag_ms(events) == pytest.approx(-2.0)
    assert np.isnan(chip_smoke.launch_lag_ms(events[:3]))


def test_stage_reading_retries_then_falls_back_to_spans():
    """Phase 20 takes profiled sessions until the profiler credits every
    stage with kernel time in STAGE_REPS of them, and reads a stage it
    never credits from its CUDA-event spans."""
    import chip_smoke

    reps = chip_smoke.STAGE_REPS
    good = ({"matmul": 10.0, "merge tier-1": 1.0},
            {"matmul": 10.5, "merge tier-1": 1.2})
    lost = ({"matmul": 0.0, "merge tier-1": 1.0},
            {"matmul": 10.5, "merge tier-1": 1.2})
    assert chip_smoke.stages_read([good] * reps)
    assert not chip_smoke.stages_read([good] * (reps - 1))
    assert not chip_smoke.stages_read([good] * (reps - 1) + [lost])
    assert chip_smoke.stages_read([lost] + [good] * reps)
    ms, source, spans = chip_smoke.pick_stage_ms(
        [lost, good, ({"matmul": 12.0, "merge tier-1": 3.0}, good[1])])
    assert ms == {"matmul": 11.0, "merge tier-1": 1.0}
    assert source == {"matmul": "kernels", "merge tier-1": "kernels"}
    ms, source, spans = chip_smoke.pick_stage_ms(
        [lost, lost, ({"merge tier-1": 2.0}, {"matmul": 9.0})])
    assert ms == {"matmul": 10.5, "merge tier-1": 1.0}
    assert source == {"matmul": "spans", "merge tier-1": "kernels"}
    assert spans == {"matmul": 10.5, "merge tier-1": 1.2}


@pytest.mark.parametrize("storage", ["int8", "hilo", "f32"])
def test_score_all_split_with_overflow(storage):
    """The calibration scorer: matmul + doc-major compare tail + the
    overflow table, every (query, doc) score and tf."""
    split = jsidx.build_split_index(jidx.build_index(CORPUS), 128,
                                    storage=storage, enable_overflow=True)
    assert split.over_term_ids is not None
    port = convert.split_index_from_numpy(
        convert.split_index_to_numpy(split), "cpu")
    enc = jsidx.encode_queries_split(QUERIES, split)
    js, jt = (np.asarray(a) for a in jsidx.score_all_split(split, *enc))
    ts, tt = tsidx.score_all_split(port, *enc)
    np.testing.assert_array_equal(tt.numpy(), jt)
    if storage == "int8":
        np.testing.assert_array_equal(ts.numpy(), js)
    else:
        assert (np.abs(ts.numpy() - js) <= np.spacing(np.abs(js))).all()
    assert (js > 0).sum() > 1000


def test_exact_topk_blockwise_matches():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 7, (24, 2048)).astype(np.float32)
    x[1] = -np.inf
    x[2, 300:] = -np.inf
    x[3] = 1.0
    for k, vu in ((10, 1900), (10, None), (5, 2048), (9, 2000)):
        jv, ji = jsidx.exact_topk_blockwise(jnp.asarray(x), k, block=256,
                                            valid_upto=vu)
        tv, ti = tsidx.exact_topk_blockwise(torch.from_numpy(x), k,
                                            block=256, valid_upto=vu)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # torch.topk alone would not give this order on ties
    tv, ti = tsidx.exact_topk_blockwise(torch.from_numpy(x), 10, block=256)
    assert (np.diff(ti.numpy()[3]) > 0).all()


def test_int8_epilogue_is_fused_multiply_add():
    """addcmul rounds once, like XLA's contracted a * b + c: pinned
    against an exact float64 evaluation (a separate multiply and add
    would differ in about a quarter of the entries)."""
    rng = np.random.default_rng(6)
    hi = torch.from_numpy(rng.integers(-40000, 40000, (64, 512))).float()
    lo = torch.from_numpy(rng.integers(-40000, 40000, (64, 512))).float()
    s0 = torch.from_numpy(rng.uniform(0, 0.1, 512).astype(np.float32))
    s1 = torch.from_numpy(rng.uniform(0, 1e-3, 512).astype(np.float32))
    c = lo * s1
    exact = (hi.double() * s0.double() + c.double()).float()
    assert torch.equal(c.clone().addcmul_(hi, s0), exact)
    assert not torch.equal(hi * s0 + c, exact)


def test_approx_raises():
    """approx=True raises nothing on the split path: it selects exactly,
    as lax.approx_max_k does on the CPU (tests/test_torch_fused.py holds
    it against the JAX package)."""
    j, t = _pair("int8")
    exact = t._retrieve_launch(QUERIES, 10, False, None)
    approx = t._retrieve_launch(QUERIES, 10, True, None)
    for a, b in zip(exact[1:], approx[1:]):
        assert torch.equal(a, b)
