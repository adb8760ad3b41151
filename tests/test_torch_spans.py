"""PyTorch port: the spans and counters of ``utils/spans.py`` on the
retrieval path and in ``index()``.

Results are bit-identical with spans on and off on every index path;
off, nothing is stored and no profiler range opens; on, every span sits
under a parent of its own request (or is a root), inside it in time,
and nests in a profiler session as it nests in the store; the byte
counters count what crosses between host and device. The last test is
marked ``cuda`` and skips without a card. The file imports neither jax
nor the JAX package.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import split_index as sidx
from bayesian_bm25_tpu_torch.utils import spans

from torch_helpers import ROOT, one_thread  # noqa: F401

PATHS = ("sparse", "tiers", "compare", "doc-major")
MERGES = ("merge.tier-1", "merge.heavy", "merge.tier-2",
          "merge.tier-2-heavy")


def _corpus_queries(vocab=900):
    """800 documents of 80 Zipf tokens over ``vocab`` terms, then 40
    queries of 6 and three edge cases."""
    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.zipf(1.25, size=80) % vocab]
              for _ in range(800)]
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 900] for _ in range(40)]
    return corpus, qs + [["zzz-oov"], [], ["t1", "t1"]]


QUERIES = _corpus_queries()[1]


@pytest.fixture(autouse=True)
def clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _scorer(path, monkeypatch):
    """A scorer on the CPU whose retrieval takes ``path``: the sparse
    merge, the sparse merge with every pass (tier-2 postings and both
    light/heavy splits), the dense compare tail, or the doc-major
    compare (256 terms or fewer)."""
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    if path == "tiers":
        monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 20000)
        for name in ("_LH_MIN_SAVE", "_LHB_MIN_SAVE"):
            monkeypatch.setattr(sidx, name, 0)
        for name in ("_LH_MIN_RATIO", "_LHB_MIN_RATIO"):
            monkeypatch.setattr(sidx, name, 1.0)
    if path == "compare":
        monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 0)
    vocab = 200 if path == "doc-major" else 900
    sc = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8",
                            device="cpu")
    sc.index(_corpus_queries(vocab)[0])
    split = sc._split
    assert (split is None) == (path == "doc-major")
    if split is not None:
        assert (split.post_doc_ids is None) == (path == "compare")
        assert (split.post2_doc_ids is not None) == (path == "tiers")
    return sc


def _retrieve_all(sc):
    """retrieve, retrieve_many and retrieve_stream, as numpy arrays."""
    out = [sc.retrieve(QUERIES, k=10)]
    batches = [QUERIES[:7], QUERIES[7:30], QUERIES[30:]]
    out += sc.retrieve_many(batches, k=10)
    out += list(sc.retrieve_stream(batches, k=10, lookahead=2))
    return out


def _by_id(stored):
    return {s["id"]: s for s in stored}


@pytest.mark.parametrize("path", PATHS)
def test_results_are_bit_identical_with_spans_on_and_off(path, monkeypatch):
    sc = _scorer(path, monkeypatch)
    off = _retrieve_all(sc)
    spans.enable()
    on = _retrieve_all(sc)
    assert spans.drain()["spans"]
    for (i0, p0), (i1, p1) in zip(off, on):
        assert i0.dtype == i1.dtype and p0.dtype == p1.dtype
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(p0, p1)


def test_off_stores_nothing_and_opens_no_profiler_range(monkeypatch):
    sc = _scorer("sparse", monkeypatch)
    assert spans.span("x") is spans.NULL
    assert spans.request(3) is spans.NULL
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _retrieve_all(sc)
    assert not [e.name for e in prof.events()
                if e.name.startswith(spans.PREFIX)]
    assert spans.drain()["spans"] == []


@pytest.mark.parametrize("path", PATHS)
def test_every_span_is_a_root_or_inside_a_parent_of_its_request(
        path, monkeypatch):
    spans.enable()
    sc = _scorer(path, monkeypatch)
    _retrieve_all(sc)
    stored = spans.drain()["spans"]
    ids = _by_id(stored)
    kids = {}
    for s in stored:
        assert s["start"] <= s["end"]
        if s["parent"] is None:
            assert s["request"] == s["id"]
            continue
        parent = ids[s["parent"]]
        assert parent["request"] == s["request"]
        assert parent["start"] <= s["start"] <= s["end"] <= parent["end"]
        kids.setdefault(parent["id"], []).append(s)
    for s in stored:
        # Siblings never overlap, so self time is the wall less theirs.
        own = s["end"] - s["start"] - sum(k["end"] - k["start"]
                                          for k in kids.get(s["id"], ()))
        assert own >= 0, s["name"]
    names = {s["name"] for s in stored}
    stage = {"sparse": {"matmul", "leader_selection", "merge.tier-1",
                        "tf_transform", "split"},
             "tiers": set(MERGES) | {"split"},
             "compare": {"score", "leader_selection", "tf_transform"},
             "doc-major": {"score"}}[path]
    assert stage | {"request", "launch", "encode", "h2d", "pull.own",
                    "pull.behind", "index", "index.build", "index.split",
                    "index.calibrate"} <= names
    # retrieve is one request; retrieve_many's and retrieve_stream's
    # batches are one each.
    roots = [s for s in stored if s["name"] == "request"]
    assert [s["counts"]["queries"] for s in roots] == [43, 7, 23, 13,
                                                       7, 23, 13]


def test_merge_spans_follow_the_passes_the_host_schedules(monkeypatch):
    sc = _scorer("tiers", monkeypatch)
    s = sc._split
    enc = sidx.encode_queries_split(QUERIES, s)
    (tr, ts, tc), grp_b = sidx.split_tail_groups(*enc[2:], s)
    want = ["merge.tier-1"]
    if sidx.split_light_heavy(tr, ts, tc, s, 10) is not None:
        want.append("merge.heavy")
    if grp_b is not None:
        want.append("merge.tier-2")
        if sidx.split_light_heavy_b(*grp_b, s, 10) is not None:
            want.append("merge.tier-2-heavy")
    spans.enable()
    sc.retrieve(QUERIES, k=10)
    got = sorted((x for x in spans.drain()["spans"]
                  if x["name"].startswith("merge.")),
                 key=lambda x: x["start"])
    assert [x["name"] for x in got] == want
    assert len(want) >= 3


def test_merge_counters_count_the_rows_and_candidates_of_each_pass(
        monkeypatch):
    spans.enable()
    sc = _scorer("tiers", monkeypatch)
    s = sc._split
    (split_span,) = [x for x in spans.drain()["spans"]
                     if x["name"] == "index.split"]
    assert split_span["counts"] == {
        "K": s.n_frequent, "R": s.post_doc_ids.shape[0] - 1,
        "entries": s.post_doc_ids.numel(),
        "R2": s.post2_doc_ids.shape[0] - 1,
        "entries2": s.post2_doc_ids.numel()}
    # The rows each pass is handed, as the host schedules them.
    enc = sidx.encode_queries_split(QUERIES, s)
    (tr, ts, tc), grp_b = sidx.split_tail_groups(*enc[2:], s)
    rows = dict.fromkeys(spans.MERGES, 0)
    lh = sidx.split_light_heavy(tr, ts, tc, s, 10)
    rows["tier-1"] = len(tr) if lh is None else len(lh[0][0])
    rows["heavy"] = 0 if lh is None else len(lh[1][0])
    if grp_b is not None:
        lhb = sidx.split_light_heavy_b(*grp_b, s, 10)
        rows["tier-2"] = len(grp_b[0]) if lhb is None else len(lhb[0][0])
        rows["tier-2-heavy"] = 0 if lhb is None else len(lhb[1][0])
    # Always on: spans off, the counters still count.
    spans.disable()
    spans.reset()
    sc.retrieve(QUERIES, k=10)
    off = dict(spans.counts)
    spans.reset()
    spans.enable()
    sc.retrieve(QUERIES, k=10)
    drained = spans.drain()
    got = drained["counters"]
    for p in spans.MERGES:
        n, c = got[f"merge_rows.{p}"], got[f"merge_candidates.{p}"]
        assert n == rows[p] == off[f"merge_rows.{p}"], p
        assert c == off[f"merge_candidates.{p}"], p
        # One chunk, so each pass runs once: rows times the one width it
        # keeps, the k leaders at least.
        assert c == 0 if n == 0 else (c % n == 0 and c // n >= 10), p
        on_span = [x["counts"] for x in drained["spans"]
                   if x["name"] == f"merge.{p}"]
        assert sum(x.get("rows", 0) for x in on_span) == n, p
        assert sum(x.get("candidates", 0) for x in on_span) == c, p
    assert sum(rows[p] > 0 for p in spans.MERGES) >= 3


def test_index_spans_hold_the_build_split_and_calibration(monkeypatch):
    spans.enable()
    _scorer("sparse", monkeypatch)
    stored = spans.drain()["spans"]
    ids = _by_id(stored)
    (root,) = [s for s in stored if s["name"] == "index"]
    parts = [s for s in stored if s["parent"] == root["id"]]
    assert [s["name"] for s in sorted(parts, key=lambda s: s["start"])] \
        == ["index.build", "index.split", "index.calibrate"]
    assert sum(s["end"] - s["start"] for s in parts) \
        <= root["end"] - root["start"]
    # Calibration's pseudo-query copies are its own h2d spans.
    h2d = [s for s in stored if s["name"] == "h2d"]
    assert any(ids[s["parent"]]["name"] == "index.calibrate" for s in h2d)


@pytest.mark.parametrize("path", PATHS)
def test_h2d_counters_are_the_bytes_handed_to_to_device(path, monkeypatch):
    sc = _scorer(path, monkeypatch)
    from bayesian_bm25_tpu_torch.engine import index as eidx

    seen = []
    original = eidx.to_device

    def counting(arr, device):
        seen.append(np.ascontiguousarray(arr).nbytes)
        return original(arr, device)

    for name, mod in list(sys.modules.items()):
        if name.startswith("bayesian_bm25_tpu_torch") \
                and getattr(mod, "to_device", None) is original:
            monkeypatch.setattr(mod, "to_device", counting)
    spans.reset()
    spans.enable()
    _retrieve_all(sc)
    drained = spans.drain()
    assert seen
    assert drained["counters"]["h2d_copies"] == len(seen)
    assert drained["counters"]["h2d_bytes"] == sum(seen)
    h2d = [s for s in drained["spans"] if s["name"] == "h2d"]
    assert len(h2d) == len(seen)
    assert sum(s["counts"]["bytes"] for s in h2d) == sum(seen)


def test_d2h_counters_are_the_packed_copies(monkeypatch):
    sc = _scorer("sparse", monkeypatch)
    spans.reset()
    sc.retrieve(QUERIES, k=10)
    # ids bitcast to float32 beside float32 probabilities: 8 bytes a slot.
    assert spans.counts["d2h_copies"] == 1
    assert spans.counts["d2h_bytes"] == 8 * len(QUERIES) * 10
    assert spans.counts["requests"] == 1
    assert spans.counts["queries"] == len(QUERIES)
    spans.reset()
    batches = [QUERIES[:5], QUERIES[5:]]
    sc.retrieve_many(batches, k=4)
    assert spans.counts["d2h_copies"] == 1
    assert spans.counts["d2h_bytes"] == 8 * len(QUERIES) * 4
    spans.reset()
    list(sc.retrieve_stream(batches, k=4))
    assert spans.counts["d2h_copies"] == 2
    assert spans.counts["d2h_bytes"] == 8 * len(QUERIES) * 4
    assert spans.counts["requests"] == 2


def test_a_stream_pull_counts_the_batches_still_in_flight(monkeypatch):
    sc = _scorer("sparse", monkeypatch)
    spans.enable()
    list(sc.retrieve_stream([QUERIES[i:i + 5] for i in range(0, 20, 5)],
                            k=10, lookahead=2))
    stored = spans.drain()["spans"]
    behind = sorted((s for s in stored if s["name"] == "pull.behind"),
                    key=lambda s: s["start"])
    assert [s["counts"]["inflight"] for s in behind] == [1, 1, 1, 0]
    ids = _by_id(stored)
    for s in behind:
        assert ids[s["parent"]]["name"] == "request"


def test_profiler_ranges_nest_as_the_stored_spans(monkeypatch):
    sc = _scorer("tiers", monkeypatch)
    spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sc.retrieve(QUERIES, k=10)
    stored = spans.drain()["spans"]
    ids = _by_id(stored)
    ranged = sorted((s for s in stored if s["name"] != "request"),
                    key=lambda s: s["start"])
    events = sorted((e for e in prof.events()
                     if e.name.startswith(spans.PREFIX)),
                    key=lambda e: e.time_range.start)
    assert [e.name[len(spans.PREFIX):] for e in events] \
        == [s["name"] for s in ranged]

    def range_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(spans.PREFIX):
            p = p.cpu_parent
        return None if p is None else p.name[len(spans.PREFIX):]

    for e, s in zip(events, ranged):
        parent = ids[s["parent"]]["name"] if s["parent"] else None
        assert range_parent(e) == (None if parent == "request" else parent)


def test_the_cap_counts_the_spans_it_drops(monkeypatch):
    sc = _scorer("sparse", monkeypatch)
    monkeypatch.setattr(spans, "CAP", 5)
    spans.enable()
    sc.retrieve(QUERIES, k=10)
    drained = spans.drain()
    assert len(drained["spans"]) == 5
    assert drained["counters"]["spans_dropped"] > 0
    spans.reset()
    assert spans.counters()["spans_dropped"] == 0


def test_counters_read_the_other_modules_where_they_live():
    from bayesian_bm25_tpu_torch.engine import cuda_topk, native

    got = spans.counters()
    assert got["cuda_topk.launches"] == cuda_topk.launches
    assert got["native.calls.encode_split"] \
        == native.calls["encode_split"]
    assert {"h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes",
            "requests", "queries", "spans_dropped"} <= set(got)


def test_the_spans_module_loads_no_jax():
    code = ("import sys\n"
            "import bayesian_bm25_tpu_torch.utils.spans\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bayesian_bm25_tpu')]\n"
            "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


@pytest.mark.cuda
def test_on_the_card_a_pull_waits_on_its_own_request_first():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    sc = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    sc.index(_corpus_queries()[0])
    batches = [QUERIES[i:i + 5] for i in range(0, 40, 5)]
    off = list(sc.retrieve_stream(batches, k=10, lookahead=3))
    spans.enable()
    on = list(sc.retrieve_stream(batches, k=10, lookahead=3))
    stored = spans.drain()["spans"]
    for (i0, p0), (i1, p1) in zip(off, on):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(p0, p1)
    own = [s for s in stored if s["name"] == "pull.own"]
    assert len(own) == len(batches)
    assert {s["name"] for s in stored} >= {"matmul", "merge.tier-1", "h2d"}
