"""The reduction of the program's own spans (``perfbench/program_spans.py``)
and the readers of the metrics it feeds, on hand-made records; and that
the traced run as the harness has it leaves the program's spans off."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import plugins, program_spans, run
from tiny import tiny

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def span(id, name, start, end, parent=None, request=None, **counts):
    return dict(id=id, name=name, start=start, end=end, parent=parent,
                request=id if request is None else request, counts=counts)


def event(name, start, end, device=CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


# Two requests of 8 and 4 queries; the second's launch has encode and
# h2d under it, and its pull overlaps nothing.
SPANS = [
    span(1, "request", 100, 200, queries=8),
    span(2, "launch", 110, 150, 1, 1),
    span(3, "encode", 115, 125, 2, 1),
    span(4, "h2d", 120, 124, 3, 1),
    span(5, "pull.behind", 160, 190, 1, 1, inflight=1),
    span(6, "request", 300, 400, queries=4),
    span(7, "launch", 300, 320, 6, 6),
    span(8, "encode", 300, 310, 7, 6),
    span(9, "index", 0, 50),
    span(10, "index.build", 0, 30, 9, 9),
]


def test_self_time_is_the_wall_less_the_children():
    own = program_spans.self_seconds(SPANS)
    assert own[1] == pytest.approx((100 - 40 - 30) / 1e9)
    assert own[3] == pytest.approx(6 / 1e9)
    assert own[4] == pytest.approx(4 / 1e9)
    assert own[9] == pytest.approx(20 / 1e9)


def test_requests_that_touch_the_slice_are_left_out():
    out = program_spans.outside_slice(SPANS, 0, None)
    assert out["requests"] == 2 and out["queries"] == 12
    assert out["self_s"]["encode"] == pytest.approx((6 + 10) / 1e9)
    out = program_spans.outside_slice(SPANS, 0, (190, 250))
    assert out["requests"] == 1 and out["queries"] == 4
    assert out["self_s"] == {"request": pytest.approx(80 / 1e9),
                             "launch": pytest.approx(10 / 1e9),
                             "encode": pytest.approx(10 / 1e9)}
    # Requests begun before the window (warm-up) are not the window's.
    assert program_spans.outside_slice(SPANS, 250, None)["requests"] == 1


SLICE_EVENTS = [
    event("perfbench: slice", 0, 100),
    event("bb25: launch", 0, 60),
    event("bb25: encode", 5, 20),
    event("bb25: matmul", 30, 40),
    event("host: launch", 0, 60),
    event("gemm", 25, 30, CUDA),
    event("stage: matmul", 30, 45, CUDA),
    event("merge", 45, 70, CUDA),
]


def test_idle_is_named_by_the_innermost_program_range():
    # Busy [25, 30] and [45, 70] ("stage: " ranges are not work): the
    # gaps' midpoints fall in encode, matmul and after the launch.
    idle = program_spans.idle_by_range(SLICE_EVENTS)
    assert idle == {"encode": pytest.approx(25e-6),
                    "matmul": pytest.approx(15e-6),
                    "harness": pytest.approx(30e-6)}
    evs = [e for e in SLICE_EVENTS if e.name != "merge"] + [
        event("k", 40, 70, CUDA)]
    assert program_spans.idle_by_range(evs)["matmul"] \
        == pytest.approx(10e-6)


def test_device_side_program_ranges_are_not_device_work():
    ranges = [event("bb25: launch", 0, 60, CUDA),
              event("bb25: matmul", 30, 40, CUDA)]
    assert program_spans.idle_by_range(SLICE_EVENTS + ranges) \
        == program_spans.idle_by_range(SLICE_EVENTS)
    assert program_spans.is_range("bb25: merge.tier-1")
    assert not program_spans.is_range("void topk_kernel<float>")


def program(**over):
    p = dict(self_s={"encode": 0.004, "split": 0.001, "h2d": 0.0005,
                     "matmul": 0.002, "leader_selection": 0.0005,
                     "merge.tier-1": 0.001, "merge.heavy": 0.0005,
                     "tf_transform": 0.0005, "launch": 0.0002,
                     "pull.own": 0.0, "pull.behind": 0.008},
             requests=2, queries=4000,
             idle_s={"encode": 0.003, "h2d": 0.001, "matmul": 0.002,
                     "merge.tier-1": 0.001, "harness": 0.05},
             index_s={"index": 10.0, "index.build": 4.0,
                      "index.split": 5.0, "index.calibrate": 1.0},
             counters={"h2d_bytes": 10})
    p.update(over)
    return p


@pytest.mark.parametrize("name, want", [
    ("encode_ms.bulk", 1.0),                 # 4 ms over 4 kqueries
    ("pull_wait_ms.bulk", 2.0),
    ("idle_prep_ms.bulk", 4.0 / 8.0),        # over the slice's 8 kqueries
    ("prep_ms.online", 5.5 / 2),
    ("dispatch_ms.online", 4.5 / 2),
    ("idle_dispatch_ms.online", 3.0 / 4),    # over the slice's 4 requests
    ("index_s.build", 4.0),
    ("index_s.split", 5.0),
    ("index_s.calibrate", 1.0),
])
def test_each_reader_on_a_hand_made_record(name, want):
    reader = plugins.load_module("metrics", name)
    trace = dict(queries=8000, requests=4, program=program())
    assert reader.read(dict(trace=trace)) == pytest.approx(want)
    # A traced run of a program without spans, and an untraced run.
    assert reader.read(dict(trace=dict(queries=8000, requests=4))) is None
    assert reader.read(dict(trace=dict(queries=8000, requests=4,
                                       program=None))) is None
    assert reader.read(dict(trace=None)) is None


def test_readers_report_nothing_where_nothing_was_recorded():
    empty = program(self_s={}, requests=0, queries=0, idle_s={}, index_s={})
    for name in ("encode_ms.bulk", "pull_wait_ms.bulk", "idle_prep_ms.bulk",
                 "prep_ms.online", "dispatch_ms.online",
                 "idle_dispatch_ms.online", "index_s.build"):
        reader = plugins.load_module("metrics", name)
        rec = dict(trace=dict(queries=0, requests=0, program=empty))
        assert reader.read(rec) is None, name


@pytest.fixture
def spans_off():
    from bayesian_bm25_tpu_torch.utils import spans

    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


def test_program_spans_over_the_port_on_the_cpu(spans_off):
    from bayesian_bm25_tpu_torch import BayesianBM25Scorer

    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.zipf(1.25, size=40) % 900]
              for _ in range(400)]
    queries = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 900]
               for _ in range(12)]
    program_spans.enable()
    sc = BayesianBM25Scorer(base_rate=0.01, device="cpu")
    sc.index(corpus)
    sc.retrieve(queries, k=5)                     # before the window
    rec = program_spans.ProgramSpans()
    sc.retrieve(queries[:4], k=5)
    rec.slice_start()
    sc.retrieve(queries[4:6], k=5)                # in the slice
    rec.slice_stop()
    list(sc.retrieve_stream([queries[6:9], queries[9:]], k=5))
    rec.finish()
    assert not spans_off.enabled()
    p = rec.reduce(None)
    assert p["requests"] == 3 and p["queries"] == 10
    assert p["self_s"]["encode"] > 0 and p["self_s"]["pull.behind"] >= 0
    assert set(p["index_s"]) == {"index", "index.build", "index.split",
                                 "index.calibrate"}
    assert p["counters"]["requests"] == 4
    assert p["counters"]["d2h_copies"] == 4
    assert p["idle_s"] == {}


def test_without_a_spans_module_nothing_is_read(monkeypatch):
    monkeypatch.setattr(program_spans, "_module", lambda: None)
    assert program_spans.enable() is None
    rec = program_spans.ProgramSpans()
    rec.slice_start()
    rec.slice_stop()
    rec.finish()
    assert rec.reduce([]) is None


def test_the_traced_run_leaves_the_program_spans_off(spans_off):
    cfg, tr = tiny("fiqa.online")
    res, _ = run.run_cell("fiqa.online", 2**31 + 5, 0.5, True, device="cpu",
                          config=cfg, traffic=tr)
    assert res["correct"]
    assert not spans_off.enabled()
    assert spans_off.drain()["spans"] == []
