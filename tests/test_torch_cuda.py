"""PyTorch port on the card: each CUDA kernel against its plain version,
and the scorer on the card against the same state on the CPU.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (the check runs inside the fixture, never at import). The file
imports neither jax nor the JAX package, so it also runs on a GPU
machine without jax, where tests/conftest.py (which imports jax) is
skipped:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from bayesian_bm25_tpu_torch import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                            cuda_matmul, cuda_reduce,
                                            cuda_topk)
from bayesian_bm25_tpu_torch.utils import convert

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def test_block_max_kernel(gen):
    x = torch.rand((64, 4096), generator=gen, device="cuda")
    x[3] = float("-inf")
    for vu in (None, 4000, 3999, 256):
        before = cuda_reduce.launches
        got = cuda_reduce.block_max(x, 256, vu)
        assert cuda_reduce.launches == before + 1
        assert torch.equal(got, cuda_reduce.block_max_plain(x, 256, vu))


def test_row_gather_kernel(gen):
    scores = torch.rand((32, 2048), generator=gen, device="cuda")
    scores[5] = float("-inf")
    sid = torch.randint(0, 2049, (40, 77), generator=gen, device="cuda",
                        dtype=torch.int32)
    trows = torch.randint(0, 32, (40,), generator=gen, device="cuda",
                          dtype=torch.int32)
    trows[:6] = 5
    got = cuda_gather.row_gather(scores, sid, trows)
    assert torch.equal(got, cuda_gather.row_gather_plain(scores, sid, trows))


def _gather_operands(gen, nq, d_pad, nt, cap):
    """K2 operands with every edge of its contract: a -inf row read by
    many sid rows, unsorted rows beside sorted ones, an all-sentinel row,
    ids d_pad - 1, d_pad and -1, rows outside [0, nq)."""
    scores = torch.rand((nq, d_pad), generator=gen, device="cuda") * 30.0
    scores[1] = float("-inf")
    sid = torch.randint(-1, d_pad + 1, (nt, cap), generator=gen,
                        device="cuda", dtype=torch.int32)
    sid[nt // 2:] = torch.sort(sid[nt // 2:], dim=1).values
    sid[2] = d_pad                                   # all sentinels
    sid[3, :3] = torch.tensor([d_pad - 1, -1, d_pad])[:cap].to(sid)
    trows = torch.randint(0, nq, (nt,), generator=gen, device="cuda",
                          dtype=torch.int32)
    trows[: nt // 4] = 1
    trows[5], trows[6] = nq, -1
    return scores, sid, trows


@pytest.mark.parametrize("cap", [1, 31, 33, 138, 266, 2058, 8202])
def test_row_gather_kernel_edges(gen, cap):
    """K2 bit-exact against its plain version on the contract's edge
    cases, at widths within one 256-candidate block, across several, and
    the 1M path's widths."""
    scores, sid, trows = _gather_operands(gen, 64, 4096, 300, cap)
    before = cuda_gather.launches
    got = cuda_gather.row_gather(scores, sid, trows)
    assert cuda_gather.launches == before + 1
    want = cuda_gather.row_gather_plain(scores, sid, trows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[2].any() and not got[5:7].any()
    assert bool(torch.isneginf(got[: 300 // 4]).any())


def test_row_gather_kernel_past_2_31_elements(gen):
    """A (2200, 1,001,472) f32 score matrix (8.8 GB): rows past 2^31 / d_pad
    need the kernel's 64-bit row offset."""
    nq, d_pad = 2200, 1_001_472
    scores = torch.empty((nq, d_pad), device="cuda")
    scores[:, :8] = torch.rand((nq, 8), generator=gen, device="cuda")
    scores[:, -8:] = torch.rand((nq, 8), generator=gen, device="cuda")
    sid = torch.tensor([[0, 7, d_pad - 8, d_pad - 1, d_pad, -1]] * 6,
                       dtype=torch.int32, device="cuda")
    trows = torch.tensor([0, 2144, 2145, 2198, 2199, 1], dtype=torch.int32,
                         device="cuda")
    assert 2199 * d_pad > 2**31
    got = cuda_gather.row_gather(scores, sid, trows)
    want = cuda_gather.row_gather_plain(scores, sid, trows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got[4, 3] == scores[2199, -1]
    del scores
    torch.cuda.empty_cache()


_K_LIMIT = cuda_topk.WARP_K_MAX


@pytest.mark.parametrize("c,k", [
    (200, 10), (2560, 10), (266, 10), (10, 10), (1000, 100),
    (7, 1), (7, 7), (33, 1), (33, 10), (33, _K_LIMIT), (33, _K_LIMIT + 1),
    (200, 1), (200, _K_LIMIT), (200, _K_LIMIT + 1), (200, 100),
    (2560, 1), (2560, _K_LIMIT), (2560, _K_LIMIT + 1), (2560, 100)])
def test_topk_kernel(gen, c, k):
    """Both K3 kernels (warp for k <= WARP_K_MAX, block rounds above)
    against the plain version: heavy ties, -inf rows, rows with fewer
    than k finite entries, -0 beside +0, C below 32 and not a multiple of
    32 or 4, and a single row."""
    y = torch.randint(0, 4, (64, c), generator=gen, device="cuda").float()
    y[0] = float("-inf")
    y[1, 3:] = float("-inf")
    y[2] = 1.0
    y[3, ::2] = -0.0
    y[3, 1::2] = 0.0
    for x in (y, y[5:6].contiguous()):
        before = cuda_topk.launches
        v, p = cuda_topk.topk(x, k)
        assert cuda_topk.launches == before + 1
        wv, wp = cuda_topk.topk_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(v, wv) and torch.equal(p, wp)
        assert torch.equal(torch.signbit(v), torch.signbit(wv))


@pytest.mark.parametrize("R,T,nq,Q", [(4096, 8, 300, 6), (2048, 128, 130, 8),
                                      (1000, 40, 17, 40), (300, 1500, 9, 3),
                                      (3000, 128, 1000, 8), (700, 32, 2049, 4),
                                      (512, cuda_bm25.HASH_MAX_T, 77, 16),
                                      (200, cuda_bm25.HASH_MAX_T + 1, 33, 8)])
def test_bm25_compare_kernel(gen, R, T, nq, Q):
    """K5 bit-exact against its plain version: counts 3/5/7, pads in
    mid-row, all-pad rows and queries, ids near INT32_MAX, ids that hit
    no row, one id in several slots, a -1 query slot (it matches the
    row's pads), a table id below -1 (QUERY_PAD slots then match it), nq
    not a multiple of a block's query run, Q above one 32-slot chunk, and
    rows too wide for the shared-memory hash (T > HASH_MAX_T: the
    global-memory scan kernel)."""
    top = 2**31 - 1 - 5 * T
    ids = torch.randint(0, 4 * T, (R, T), generator=gen, device="cuda",
                        dtype=torch.int32)
    # unique ids per row: sort, then pad out repeats and a random tail
    ids = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    lens = torch.randint(0, T + 1, (R, 1), generator=gen, device="cuda")
    pad = dup | (torch.arange(T, device="cuda")[None, :] >= lens)
    pad |= torch.rand((R, T), generator=gen, device="cuda") < 0.2  # mid-row
    pad[::7] = True
    ids[::3] += top                                  # near INT32_MAX
    ids = torch.where(pad, -1, ids).to(torch.int32)
    ids[5, 0] = -2
    w = torch.where(pad, 0.0, torch.rand((R, T), generator=gen,
                                         device="cuda") * 5)
    qids = torch.randint(0, 5 * T, (nq, Q), generator=gen, device="cuda",
                         dtype=torch.int32)
    qids[::4] += top
    qids[::5] = -2
    qids[1, 0] = -1
    qids[2, 0] = qids[2, -1] = ids[ids >= 0][0]     # one id, two slots
    qcnt = torch.tensor([1.0, 3.0, 5.0, 7.0], device="cuda")[
        torch.randint(0, 4, (nq, Q), generator=gen, device="cuda")]
    qcnt = torch.where(qids < -1, 0.0, qcnt)
    before = cuda_bm25.launches
    gs, gt = cuda_bm25.compare(ids, w, qids, qcnt)
    assert cuda_bm25.launches == before + 1
    ps, pt = cuda_bm25.compare_plain(ids, w, qids, qcnt)
    torch.cuda.synchronize()
    assert torch.equal(gs, ps) and torch.equal(gt, pt)
    assert bool((gt > 0).any()) and bool((gt[1] > 0).any())
    if Q > 1:
        assert bool((gt[2] > 1).any())
    assert not gt[torch.arange(nq, device="cuda") != 1][:, ::7].any()


def test_bm25_compare_direct_slots(gen):
    """Blocks whose ids all lie below the hash's slot count take the id
    as its slot (the doc-major tables); one id past it puts its block on
    multiplicative hashing. Query ids past the slot count, -2 and -1."""
    R, T = 1000, 100                                 # 256 slots a row
    ids = torch.argsort(torch.rand((R, 200), generator=gen, device="cuda"),
                        dim=1)[:, :T].to(torch.int32)
    pad = torch.rand((R, T), generator=gen, device="cuda") < 0.3
    ids = torch.where(pad, -1, ids)
    ids[40, 0] = 5000                                # block 1: hashed
    w = torch.where(pad, 0.0, torch.rand((R, T), generator=gen,
                                         device="cuda") * 5)
    qids = torch.randint(0, 300, (300, 8), generator=gen, device="cuda",
                         dtype=torch.int32)
    qids[::6, 4:] = -2
    qids[7, 3] = -1
    qids[9, 0] = 5000
    qcnt = torch.where(qids < -1, 0.0, 3.0)
    gs, gt = cuda_bm25.compare(ids, w, qids, qcnt)
    ps, pt = cuda_bm25.compare_plain(ids, w, qids, qcnt)
    torch.cuda.synchronize()
    assert torch.equal(gs, ps) and torch.equal(gt, pt)
    assert gt[9, 40] >= 1 and bool((gt[7] > 0).all())


def test_bm25_compare_misses_never_hit_empty_slots(gen):
    """-1 is the hash's empty-slot key: query ids that are in no row,
    near 0, near INT32_MAX or negative below -1, never match; every row
    empty matches nothing but a -1 slot."""
    R, T = 640, 64
    ids = torch.randperm(45000, generator=gen, device="cuda")[:R * T]
    ids = ids.view(R, T).to(torch.int32)
    w = torch.rand((R, T), generator=gen, device="cuda")
    misses = torch.tensor([[45000, 45001, 2**31 - 1, -3, -2**31, 99999,
                            2**31 - 2, 123456]], device="cuda",
                          dtype=torch.int32)
    qcnt = torch.ones((1, 8), device="cuda")
    s, t = cuda_bm25.compare(ids, w, misses, qcnt)
    assert not s.any() and not t.any()
    empty = torch.full((R, T), -1, dtype=torch.int32, device="cuda")
    zero = torch.zeros((R, T), device="cuda")
    s, t = cuda_bm25.compare(empty, zero, torch.cat([misses, ids[:1, :8]]),
                             torch.ones((2, 8), device="cuda"))
    assert not s.any() and not t.any()
    pads = torch.tensor([[-1, 5]], dtype=torch.int32, device="cuda")
    s, t = cuda_bm25.compare(empty, zero, pads, torch.ones((1, 2),
                                                           device="cuda"))
    assert bool((t == T).all()) and not s.any()


def _doc_major_vs_cpu(gpu, qs):
    """Doc-major scorer on the card against the same state on the CPU:
    the compare is bit-exact on both, so ids, scores and tf are equal."""
    t = gpu.transform
    cpu = convert.scorer_from_numpy(
        convert.index_to_numpy(gpu._index), t.alpha, t.beta, t.base_rate,
        device="cpu")
    _, gi, gp, gs, gt = gpu._retrieve_launch(qs, 10, False, None)
    _, ci, cp, cs, ct = cpu._retrieve_launch(qs, 10, False, None)
    assert torch.equal(gi.cpu(), ci) and torch.equal(gs.cpu(), cs)
    assert torch.equal(gt.cpu(), ct)
    assert float((gp.cpu() - cp).abs().max()) <= 1e-5
    return cpu


def test_doc_major_scorer_on_card(gen):
    rng = np.random.default_rng(0)
    corpus = [[f"w{t}" for t in rng.zipf(1.3, size=60) % 200]
              for _ in range(600)]
    qs = [[f"w{t}" for t in rng.zipf(1.3, size=8) % 200] for _ in range(50)]
    qs += [["w1"] * 3 + ["w2"] * 5 + ["w70"] * 7, [], ["zzz-oov"]]
    gpu = BayesianBM25Scorer(base_rate=0.01)
    before = cuda_bm25.launches
    gpu.index(corpus, show_progress=False)
    assert gpu._split is None and cuda_bm25.launches > before
    cpu = _doc_major_vs_cpu(gpu, qs)
    np.testing.assert_array_equal(gpu.get_scores_batch(qs),
                                  cpu.get_scores_batch(qs))
    dense = cpu.get_probabilities_batch(qs)
    np.testing.assert_allclose(gpu.get_probabilities_batch(qs), dense,
                               rtol=0, atol=1e-5)
    # The transform's float32 exp and log may differ in the last ulp
    # between the devices: ids may swap only between docs whose
    # probabilities lie within 1e-5, and a passing count may move only
    # by the docs within 1e-5 of the threshold.
    for thr in (0.0, 0.3, 0.6):
        gi, gp, gn = gpu.retrieve_thresholded(qs, thr, k=10)
        ci, cp, cn = cpu.retrieve_thresholded(qs, thr, k=10)
        r, c = np.nonzero(gi != ci)
        assert (gi[r, c] >= 0).all() and (ci[r, c] >= 0).all()
        assert (np.abs(dense[r, gi[r, c]] - dense[r, ci[r, c]])
                <= 1e-5).all()
        near = (np.abs(dense - thr) <= 1e-5).sum(axis=1)
        assert (np.abs(gn - cn) <= near).all()
        assert float(np.abs(gp - cp).max()) <= 1e-5


def test_over_budget_split_on_card(gen, monkeypatch):
    """Postings over budget: retrieve through the dense compare tail."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 0)
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    gpu.index(corpus, show_progress=False)
    assert gpu._split.post_doc_ids is None
    before = cuda_bm25.launches
    _, gs, cs = _card_vs_cpu(gpu, qs)
    assert cuda_bm25.launches > before
    assert torch.equal(gs, cs)


def _corpus_queries():
    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.zipf(1.25, size=80) % 900]
              for _ in range(800)]
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 900] for _ in range(40)]
    return corpus, qs + [[], ["zzz-oov"]]


def _card_vs_cpu(gpu, qs, doc_mask=None, cpu=None):
    """The card against the same index state on the CPU (``cpu``, by
    default the card's split index and transform copied there): ids
    equal except between scores equal to float32 rounding (float matmuls
    sum in another order on each device), probabilities within 1e-5."""
    t = gpu.transform
    if cpu is None:
        cpu = convert.scorer_from_numpy(
            convert.split_index_to_numpy(gpu._split), t.alpha, t.beta,
            t.base_rate, device="cpu")
    _, gi, gp, gs, gt = gpu._retrieve_launch(qs, 10, False, doc_mask)
    _, ci, cp, cs, ct = cpu._retrieve_launch(qs, 10, False, doc_mask)
    gi, gp, gs, gt = (a.cpu() for a in (gi, gp, gs, gt))
    differ = gi != ci
    assert torch.allclose(gs, cs, rtol=1e-6, atol=0)
    assert not bool((differ & ((gs - cs).abs() > 1e-6 * cs.abs())).any())
    assert torch.equal(gt[~differ], ct[~differ])
    assert float((gp - cp).abs().max()) <= 1e-5
    return gi, gs, cs


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16", "f32"])
def test_scorer_card_matches_cpu(gen, storage):
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    gpu.index(corpus, show_progress=False)
    _, gs, cs = _card_vs_cpu(gpu, qs)
    if storage == "int8":  # exact int32 products, same FMA epilogue
        assert torch.equal(gs, cs)
    mask = np.ones(800, bool)
    mask[::3] = False
    ids, _, _ = _card_vs_cpu(gpu, qs, doc_mask=mask)
    assert mask[ids[ids >= 0].numpy()].all()


def test_tier2_and_light_heavy_on_card(gen, monkeypatch):
    """Tier-2 postings with every merge pass enabled, on the card."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    monkeypatch.setattr(sidx, "_POSTINGS_MAX_ENTRIES", 20000)
    for name in ("_LH_MIN_SAVE", "_LHB_MIN_SAVE"):
        monkeypatch.setattr(sidx, name, 0)
    for name in ("_LH_MIN_RATIO", "_LHB_MIN_RATIO"):
        monkeypatch.setattr(sidx, name, 1.0)
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    gpu.index(corpus, show_progress=False)
    s = gpu._split
    assert s.post2_doc_ids is not None
    # One K2 launch per merge pass the host schedules (the corpus comes
    # from numpy's zipf, whose draws differ between numpy versions).
    enc = sidx.encode_queries_split(qs, s)
    (tr, ts, tc), grp_b = sidx.split_tail_groups(*enc[2:], s)
    assert grp_b is not None
    passes = (2 + (sidx.split_light_heavy(tr, ts, tc, s, 10) is not None)
              + (sidx.split_light_heavy_b(*grp_b, s, 10) is not None))
    before = cuda_gather.launches
    _card_vs_cpu(gpu, qs)
    assert cuda_gather.launches == before + passes


def _k4_operands(gen, storage, nq, D, K, signed=False, q_zeros=0.9):
    """K4 operands on the card: count rows with a share ``q_zeros`` of
    zeros (every 7th row all zero), a sparse impact matrix in the storage
    mode's form; ``signed`` makes every impact value signed, so totals
    can be negative."""
    q = torch.randint(1, 4, (nq, K), generator=gen, device="cuda").float()
    q[torch.rand((nq, K), generator=gen, device="cuda") < q_zeros] = 0.0
    q[::7] = 0.0                                     # all-zero query rows
    w = torch.rand((D, K), generator=gen, device="cuda") * 8.0
    if signed:
        w = w - 4.0
    w[torch.rand((D, K), generator=gen, device="cuda") < 0.8] = 0.0
    if storage == "int8":
        hi = torch.randint(-127, 128, (D, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        lo = torch.randint(-127, 128, (D, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        if not signed:
            hi, lo = hi.abs(), lo
        scale = torch.rand((2, D), generator=gen, device="cuda") * 0.05
        return q, hi, lo, scale
    hi = w.to(torch.bfloat16)
    if storage == "hilo":
        return q, hi, (w - hi.float()).to(torch.bfloat16), None
    return q, hi, None, None


def _columns(hi, lo):
    """The column-major copy K4 reads, as the split index keeps it."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    return sidx._column_major(hi, lo)


def _k4_check(q, hi, lo, scale, n_docs):
    """K4 against its plain version: int8 bit-exact, the bf16 modes
    within the rounding of their few nonzero terms (nnz ulps of the
    sum of the terms' magnitudes), maxima equal to the masked maxima of
    the kernel's own scores."""
    before = cuda_matmul.launches
    cols = _columns(hi, lo)
    gs, gb = cuda_matmul.impact_matmul_bmax(q, *cols, scale, n_docs)
    assert cuda_matmul.launches == before + 1
    ps, pb = cuda_matmul.impact_matmul_bmax_plain(q, *cols, scale, n_docs)
    torch.cuda.synchronize()
    assert torch.equal(gb, cuda_reduce.block_max_plain(gs, 256, n_docs))
    if scale is not None:
        assert torch.equal(gs, ps) and torch.equal(gb, pb)
        return
    inf = float("inf")
    absw = hi.float().abs() + (0.0 if lo is None else lo.float().abs())
    mag = q.abs() @ absw.t()
    nnz = (q != 0).sum(dim=1, keepdim=True).clamp(min=1).double()
    gap = (gs.double() - ps.double()).abs()
    ulp_mag = (torch.nextafter(mag, torch.full_like(mag, inf)) - mag).double()
    assert bool((gap <= nnz * ulp_mag).all())


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16"])
@pytest.mark.parametrize("nq,D,K,n_docs,signed,q_zeros", [
    (256, 2048, 128, 1348, False, 0.9),   # JAX test's shape, masked tail
    (77, 1024, 104, 1000, True, 0.9),     # ragged nq, K % 32 != 0, signed
    (33, 2560, 2048, 2049, True, 0.99),   # one column into the last block
    (300, 512, 64, 0, False, 0.9),        # every block masked
    (40, 768, 512, 700, True, 0.0),       # dense rows: 4 column slices
    (20, 256, 96, 256, False, 1.0),       # all queries empty
    (130, 1024, 384, 1000, False, 0.5),   # 3 tiles, each union 3 slices
])
def test_impact_matmul_bmax_kernel(gen, storage, nq, D, K, n_docs, signed,
                                   q_zeros):
    q, hi, lo, scale = _k4_operands(gen, storage, nq, D, K, signed, q_zeros)
    _k4_check(q, hi, lo, scale, n_docs)
    if n_docs == 0:
        _, gb = cuda_matmul.impact_matmul_bmax(q, *_columns(hi, lo), scale,
                                               n_docs)
        assert bool((gb == float("-inf")).all())
    with pytest.raises(ValueError, match="column-major"):
        cuda_matmul.impact_matmul_bmax(q, hi, lo, scale, n_docs)


@pytest.mark.parametrize("storage", ["hilo", "bf16"])
def test_k4_bf16_modes_within_one_ulp_at_the_paths_sparsity(gen, storage):
    """The bf16 modes within 1 ulp of the plain version on counts with
    the frequent-term path's sparsity (8 Zipf(1.3) tokens a query, ~5.7
    distinct columns of 2,048) and random non-negative impact values;
    a tensor-core product that adds the terms in its own order measured
    2 ulps on such hilo operands."""
    nq, D, K = 2048, 16384, 2048
    rng = np.random.default_rng(0)
    tok = rng.zipf(1.3, size=(nq, 8)) - 1
    q = np.zeros((nq, K), np.float32)
    for j in range(8):
        ok = tok[:, j] < K
        np.add.at(q, (np.nonzero(ok)[0], tok[ok, j]), 1.0)
    q = torch.from_numpy(q).cuda()
    w = torch.rand((D, K), generator=gen, device="cuda") * 4.0
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16) if storage == "hilo" else None
    cols = _columns(hi, lo)
    gs, gb = cuda_matmul.impact_matmul_bmax(q, *cols, None, D - 100)
    ps, _ = cuda_matmul.impact_matmul_bmax_plain(q, *cols, None, D - 100)
    torch.cuda.synchronize()
    assert torch.equal(gb, cuda_reduce.block_max_plain(gs, 256, D - 100))
    ulp = (torch.nextafter(ps.abs(), torch.full_like(ps, float("inf")))
           - ps.abs()).double()
    assert float(((gs.double() - ps.double()).abs() / ulp).max()) <= 1.0


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_fused_scorer_on_card(gen, storage, monkeypatch):
    """FUSED_MM on: retrieve launches K4 (and not K1 for leader
    selection), and agrees with the same state on the CPU."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    monkeypatch.setattr(sidx, "FUSED_MM", True)
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    gpu.index(corpus, show_progress=False)
    before = cuda_matmul.launches
    _, gs, cs = _card_vs_cpu(gpu, qs)
    assert cuda_matmul.launches == before + 1
    if storage == "int8":
        assert torch.equal(gs, cs)
    gpu.delete_documents([0, 1, 2])
    alive = np.ones(gpu.num_docs, bool)
    alive[:3] = False
    _card_vs_cpu(gpu, qs, doc_mask=alive)   # masked: the unfused route
    assert cuda_matmul.launches == before + 1


def _route_corpus():
    """6,000 documents: 24 blocks of 256 on one card and 12 a shard on
    two, more than k = 10, so the library route's leader selection
    launches K1; a split of 128 or 256 frequent terms under an 8 MB
    budget."""
    rng = np.random.default_rng(0)
    corpus = [[f"t{t}" for t in rng.zipf(1.25, size=80) % 900]
              for _ in range(6000)]
    qs = [[f"t{t}" for t in rng.zipf(1.3, size=6) % 900] for _ in range(40)]
    return corpus, qs + [[], ["zzz-oov"]]


def _refused(scorer, qs, storage, n_docs, coarse=True):
    """Retrieves the gate keeps off K4 (a doc_mask, approx=True, and
    under int8 a count above 127 and, where the scorer has it,
    coarse=True): each launches no K4 and leaves leader selection to
    K1."""
    alive = np.ones(n_docs, bool)
    alive[::3] = False
    cases = [(qs, dict(doc_mask=alive)), (qs, dict(approx=True))]
    if storage == "int8":
        cases.append((qs + [["t1"] * 130], {}))
        if coarse:
            cases.append((qs, dict(coarse=True)))
    for queries, kw in cases:
        k4, k1 = cuda_matmul.launches, cuda_reduce.launches
        ids, _ = scorer.retrieve(queries, k=10, **kw)
        assert cuda_matmul.launches == k4 and cuda_reduce.launches > k1, kw
        if "doc_mask" in kw:
            assert alive[ids[ids >= 0]].all()


@pytest.mark.parametrize("storage", ["int8", "hilo", "bf16"])
def test_default_route_on_card(gen, storage, monkeypatch):
    """Under the default (FUSED_MM None) retrieve on the card launches
    K4 once and K1 not at all, with the CPU's answers (int8 bit-equal);
    the gate's refusals launch no K4."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    assert sidx.FUSED_MM is None
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 8_000_000)
    corpus, qs = _route_corpus()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    gpu.index(corpus, show_progress=False)
    assert gpu._split.dense_impact.shape[0] // 256 > 10
    k4, k1 = cuda_matmul.launches, cuda_reduce.launches
    _, gs, cs = _card_vs_cpu(gpu, qs)
    assert (cuda_matmul.launches - k4, cuda_reduce.launches - k1) == (1, 0)
    if storage == "int8":
        assert torch.equal(gs, cs)
    _refused(gpu, qs, storage, len(corpus))


@pytest.mark.parametrize("storage", ["int8", "hilo"])
def test_default_route_sharded_on_card(gen, storage, monkeypatch):
    """ShardedBayesianBM25Scorer, two shards on the card, under the
    default: K4 once per shard and K1 not at all, with the answers of the
    same sharded state on the CPU; the gate's refusals launch no K4."""
    from bayesian_bm25_tpu_torch import ShardedBayesianBM25Scorer
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    assert sidx.FUSED_MM is None
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 8_000_000)
    corpus, qs = _route_corpus()
    kw = dict(n_devices=2, base_rate=0.01, impact_storage=storage)
    gpu = ShardedBayesianBM25Scorer(**kw, device="cuda")
    gpu.index(corpus, show_progress=False)
    cpu = ShardedBayesianBM25Scorer(**kw, device="cpu")
    cpu.index(corpus, show_progress=False)
    cpu._transform = convert.transform_from_numpy(
        convert.transform_to_numpy(gpu.transform), "cpu")
    assert gpu._sh["dense_impact"][0].shape[0] // 256 > 10
    k4, k1 = cuda_matmul.launches, cuda_reduce.launches
    _card_vs_cpu(gpu, qs, cpu=cpu)
    assert (cuda_matmul.launches - k4, cuda_reduce.launches - k1) == (2, 0)
    _refused(gpu, qs, storage, len(corpus), coarse=False)


def _texts(seed, n, length=50, vocab=1500):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" + ("", "ing", "ies", "ational", "ness", "s")[i % 6]
             for i in range(vocab)] + ["the", "of", "and", "a", "to"]
    return [" ".join(words[i] for i in rng.zipf(1.3, size=length)
                     % len(words)).capitalize() + "." for _ in range(n)]


@pytest.mark.parametrize("stem,storage", [(True, "hilo"),
                                          ("snowball", "int8")])
def test_text_path_on_card(gen, monkeypatch, tmp_path, stem, storage):
    """index_jsonl and retrieve_texts on the card against the same state
    on the CPU, through the native loader, corpus build and encoder."""
    import json

    from bayesian_bm25_tpu_torch.engine import native
    from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts

    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    texts = _texts(0, 600)
    path = tmp_path / "corpus.jsonl"
    path.write_text("\n".join(json.dumps({"_id": f"d{i}", "text": s})
                              for i, s in enumerate(texts)))
    native.reset_counts()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage=storage)
    assert gpu.index_jsonl(str(path), stem=stem)[-1] == "d599"
    queries = [" ".join(t.split()[:4]) for t in _texts(1, 40)] + ["", "zzz"]
    ids, probs = gpu.retrieve_texts(queries, k=10)
    assert ids.shape == (42, 10) and (probs[-2:] == 0).all()
    assert {"jsonl", "corpus", "tokenize", "encode_split"} <= {
        k for k, v in native.calls.items() if v}
    assert not any(native.fallbacks.values())
    qs = tokenize_texts(queries, stem=stem)
    gi, _, _ = _card_vs_cpu(gpu, qs)
    np.testing.assert_array_equal(gi.numpy(), ids)


def test_prior_free_fit_on_card(gen, monkeypatch):
    """transform.fit(mode="prior_free"), then retrieval on the card
    against the CPU holding the whole fitted state."""
    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    gpu.index(corpus, show_progress=False)
    scores = gpu.get_scores_batch(qs)
    s = scores[scores > 0]
    rng = np.random.default_rng(1)
    labels = (rng.uniform(size=s.size)
              < 1 / (1 + np.exp(-(s - np.median(s))))).astype(float)
    gpu.transform.fit(s, labels, mode="prior_free", max_iterations=200)
    cpu = convert.scorer_from_numpy(
        convert.split_index_to_numpy(gpu._split), 1.0, 0.0, device="cpu")
    cpu._transform = convert.transform_from_numpy(
        convert.transform_to_numpy(gpu.transform), "cpu")
    gi, gp = gpu.retrieve(qs, k=10)
    ci, cp = cpu.retrieve(qs, k=10)
    np.testing.assert_array_equal(gi, ci)
    assert float(np.abs(gp - cp).max()) <= 1e-5


@pytest.mark.parametrize("config", ["unpacked_build", "tf_co_sorted"])
def test_merge_variants_on_card(gen, monkeypatch, config):
    """The unpacked candidate build (PACKED_BUILD off) and the tf
    co-sorted by the merge (tf_from_sign off), each on the card against
    the same state on the CPU."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    monkeypatch.setattr(BayesianBM25Scorer, "_SPLIT_BUDGET_BYTES", 2_000_000)
    corpus, qs = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    gpu.index(corpus, show_progress=False)
    if config == "unpacked_build":
        monkeypatch.setattr(sidx, "PACKED_BUILD", False)
    else:
        gpu._split.post_w_positive = False
    before = cuda_gather.launches
    _, gs, cs = _card_vs_cpu(gpu, qs)
    assert cuda_gather.launches > before
    assert torch.equal(gs, cs)


def test_overflow_calibration_on_card(gen):
    """Calibration scoring through an overflow table on the card against
    the CPU: the pseudo-query scores, alpha and beta."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    corpus, _ = _corpus_queries()
    gpu = BayesianBM25Scorer(base_rate=0.01, impact_storage="int8")
    gpu.index(corpus, show_progress=False)
    split = sidx.build_split_index(gpu._index, n_frequent=128,
                                   storage="int8", enable_overflow=True)
    assert split.over_term_ids is not None
    state = convert.split_index_to_numpy(split)
    models = [convert.scorer_from_numpy(state, 1.0, 0.0, device=d)
              for d in ("cuda", "cpu")]
    before = cuda_bm25.launches
    out = []
    for m in models:
        m._corpus_tokens = corpus
        out.append(m._sample_pseudo_query_scores(corpus))
        m._calibrate()
    assert cuda_bm25.launches > before
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    g, c = (m.transform for m in models)
    assert (g.alpha, g.beta) == (c.alpha, c.beta)
