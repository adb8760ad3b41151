"""PyTorch port: the plain versions of kernels K1-K3 against the JAX
package's Pallas kernels (interpret mode on the CPU, as their own tests
run them), bit for bit, ties, -inf entries and mid-block ``valid_upto``
included. The CUDA wrappers import and run here without nvcc: on a CPU
tensor they take the plain version, on any other non-CUDA device they
raise. The CUDA kernels themselves are compared with these plain
versions on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bayesian_bm25_tpu.engine import pallas_gather, pallas_reduce, pallas_topk
from bayesian_bm25_tpu_torch.engine import (_cuda_build, cuda_gather,
                                            cuda_matmul, cuda_reduce,
                                            cuda_topk)


def _scores(seed, nq, d, ties=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 6, (nq, d)) if ties
         else rng.gamma(2.0, 2.0, (nq, d))).astype(np.float32)
    x[1] = -np.inf                      # a doc_mask row
    x[2, : d // 3] = -np.inf
    return x


@pytest.mark.parametrize("valid_upto", [None, 1000, 1024, 777, 256])
def test_block_max_plain_vs_pallas(valid_upto):
    x = _scores(0, 16, 1024)
    want = np.asarray(pallas_reduce.block_max(jnp.asarray(x), 256,
                                              valid_upto=valid_upto))
    got = cuda_reduce.block_max(torch.from_numpy(x), 256, valid_upto)
    assert got.dtype == torch.float32 and got.shape == (16, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cuda_reduce.block_max_plain(torch.from_numpy(x), 256,
                                    valid_upto).numpy(), want)


def test_row_gather_plain_vs_pallas_finite():
    rng = np.random.default_rng(1)
    d_pad, nq, nt, cap = 512, 12, 8, 40
    scores = rng.gamma(2.0, 2.0, (nq, d_pad)).astype(np.float32)
    sid = np.sort(rng.integers(0, d_pad + 1, (nt, cap)), axis=1)
    sid[:, -5:] = d_pad                                # sentinel slots
    sid = sid.astype(np.int32)
    trows = rng.integers(0, nq, nt).astype(np.int32)
    trows[:3] = 4                                      # repeated rows
    want = np.asarray(pallas_gather.row_gather(
        jnp.asarray(scores), jnp.asarray(sid), jnp.asarray(trows)))
    got = cuda_gather.row_gather(torch.from_numpy(scores),
                                 torch.from_numpy(sid),
                                 torch.from_numpy(trows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_gather_plain_vs_xla_gather_with_inf():
    """-inf rows (doc_mask batches) are out of the Pallas kernel's
    domain; there the JAX merge uses the clamped XLA gather, which agrees
    with K2 on every valid id (sentinel slots are masked downstream)."""
    rng = np.random.default_rng(2)
    d_pad, nq, nt, cap = 256, 6, 10, 30
    scores = _scores(2, nq, d_pad)
    sid = rng.integers(0, d_pad + 1, (nt, cap)).astype(np.int32)
    trows = rng.integers(0, nq, nt).astype(np.int32)
    trows[:4] = 1                                      # the -inf row
    xla = np.asarray(jnp.asarray(scores)[jnp.asarray(trows)[:, None],
                                         jnp.minimum(sid, d_pad - 1)])
    got = cuda_gather.row_gather(torch.from_numpy(scores),
                                 torch.from_numpy(sid),
                                 torch.from_numpy(trows)).numpy()
    valid = sid < d_pad
    np.testing.assert_array_equal(got[valid], xla[valid])
    assert (got[~valid] == 0.0).all()
    assert np.isneginf(got[:4][valid[:4]]).all()


def _gather_edges(seed, nq, d_pad, nt, cap):
    """K2 operands with the edge cases of its contract: unsorted rows
    beside sorted ones, an all-sentinel row, ids d_pad - 1, d_pad and -1,
    and one score row read by many sid rows."""
    rng = np.random.default_rng(seed)
    sid = rng.integers(-1, d_pad + 1, (nt, cap)).astype(np.int32)
    sid[nt // 2:] = np.sort(sid[nt // 2:], axis=1)
    sid[1] = d_pad                                     # all sentinels
    sid[2, :3] = np.array([d_pad - 1, -1, d_pad])[:cap]
    trows = rng.integers(0, nq, nt).astype(np.int32)
    trows[: nt // 3] = 1                               # repeated rows
    return sid, trows


@pytest.mark.parametrize("cap", [1, 31, 33, 138])
def test_row_gather_plain_vs_pallas_edges(cap):
    """The Pallas kernel (interpret mode) on finite scores: ids outside
    [0, d_pad), d_pad - 1, unsorted rows, sentinel rows, repeated rows."""
    d_pad, nq, nt = 384, 6, 12
    scores = np.random.default_rng(3).gamma(2.0, 2.0, (nq, d_pad)).astype(
        np.float32)
    sid, trows = _gather_edges(cap, nq, d_pad, nt, cap)
    want = np.asarray(pallas_gather.row_gather(
        jnp.asarray(scores), jnp.asarray(sid), jnp.asarray(trows)))
    got = cuda_gather.row_gather(torch.from_numpy(scores),
                                 torch.from_numpy(sid),
                                 torch.from_numpy(trows)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0.0).all() and got[2, 0] == scores[trows[2], -1]


@pytest.mark.parametrize("cap", [1, 31, 33, 138])
def test_row_gather_plain_vs_xla_gather_edges_with_inf(cap):
    """-inf rows (doc_mask batches) against the clamped XLA gather the
    JAX merge uses there: equal on every id in [0, d_pad), 0.0 outside."""
    d_pad, nq, nt = 256, 6, 12
    scores = _scores(4, nq, d_pad)
    sid, trows = _gather_edges(cap + 1, nq, d_pad, nt, cap)
    xla = np.asarray(jnp.asarray(scores)[
        jnp.asarray(trows)[:, None], jnp.clip(jnp.asarray(sid), 0, d_pad - 1)])
    got = cuda_gather.row_gather(torch.from_numpy(scores),
                                 torch.from_numpy(sid),
                                 torch.from_numpy(trows)).numpy()
    valid = (sid >= 0) & (sid < d_pad)
    np.testing.assert_array_equal(got[valid], xla[valid])
    assert (got[~valid] == 0.0).all()
    assert np.isneginf(got[: nt // 3][valid[: nt // 3]]).all()


def test_row_gather_plain_rows_out_of_range():
    """Rows outside [0, nq) read 0.0, as the kernel's contract says."""
    scores = torch.rand(4, 64)
    sid = torch.tensor([[0, 5, 63], [1, 2, 3], [7, 8, 64]], dtype=torch.int32)
    trows = torch.tensor([4, -1, 2], dtype=torch.int32)
    got = cuda_gather.row_gather(scores, sid, trows)
    assert not got[:2].any()
    assert torch.equal(got[2], torch.stack([scores[2, 7], scores[2, 8],
                                            torch.tensor(0.0)]))


@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_plain_vs_pallas(k, ties):
    x = _scores(3, 16, 256, ties=ties)
    x[3, 5:] = -np.inf                                 # < k finite entries
    x[4] = 2.0                                         # one big tie
    wv, wp = pallas_topk.topk(jnp.asarray(x), k)
    v, p = cuda_topk.topk(torch.from_numpy(x), k)
    assert v.dtype == torch.float32 and p.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(p.numpy(), np.asarray(wp))


@pytest.mark.parametrize("c,k", [(200, 10), (266, 10), (10, 10), (3, 1)])
def test_topk_plain_vs_lax_top_k_any_width(c, k):
    """No C % 128 or k <= 64 limit: the (nq, 200) block selection and
    (nt, cand_cap) merge widths of the main path."""
    x = _scores(4, 8, c, ties=True)
    wv, wp = lax.top_k(jnp.asarray(x), k)
    v, p = cuda_topk.topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(p.numpy(), np.asarray(wp))


@pytest.mark.parametrize("k", [cuda_topk.WARP_K_MAX, cuda_topk.WARP_K_MAX + 1])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_plain_at_the_warp_kernel_limit(k, ties):
    """The last k of the warp kernel and the first of the block-round
    kernel: the plain version equals lax.top_k and the Pallas kernel.
    -0 and +0 tie, as in the Pallas kernel (a float compare); lax.top_k
    on the CPU sorts +0 above -0, so it sees that row with +0 only."""
    x = _scores(5, 16, 256, ties=ties)
    x[3, 20:] = -np.inf                                # < k finite entries
    x[4] = 2.0                                         # one big tie
    x[5, ::2] = -0.0
    x[5, 1::2] = 0.0
    v, p = cuda_topk.topk(torch.from_numpy(x), k)
    assert p[5].tolist() == list(range(k))
    for wv, wp in (lax.top_k(jnp.asarray(x + np.float32(0.0)), k),
                   pallas_topk.topk(jnp.asarray(x), k)):
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(p.numpy(), np.asarray(wp))


def test_kernel_limits_match_the_sources():
    """The wrappers' limits are the constants the CUDA sources use."""
    import re

    def const(name, src):
        text = (_cuda_build.CSRC / src).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    from bayesian_bm25_tpu_torch.engine import cuda_bm25

    assert const("kWarpKMax", "topk.cu") == cuda_topk.WARP_K_MAX
    assert const("kHashMaxT", "bm25_compare.cu") == cuda_bm25.HASH_MAX_T
    assert const("kMaxWords", "impact_matmul.cu") * 32 == cuda_matmul._K_MAX


def test_k4_columns_are_checked():
    """K4 takes the impact matrices column-major, (K, D) and contiguous,
    as the split index keeps them (nothing else); on the CPU its plain
    version equals the unfused route on the row-major matrices."""
    from bayesian_bm25_tpu_torch.engine import split_index as sidx

    q = torch.zeros(4, 128)
    q[0, 3] = 2.0
    q[1, 5] = 257.0
    hi = torch.rand(512, 128).to(torch.bfloat16)
    lo = torch.rand(512, 128).to(torch.bfloat16)
    cols = sidx._column_major(hi, lo)
    assert cols[0].shape == (128, 512) and cols[0].is_contiguous()
    got = cuda_matmul.impact_matmul_bmax(q, *cols, None, 512)
    want = sidx._impact_matmul(q, hi, lo)
    assert torch.equal(got[0], want)
    assert torch.equal(got[1], cuda_reduce.block_max_plain(want, 256, 512))
    for bad in ((hi, lo), (cols[0], lo), (cols[0], lo.t()),
                (cols[0].t().contiguous()[:128], cols[1])):
        with pytest.raises(ValueError, match="column-major"):
            cuda_matmul.impact_matmul_bmax(q, *bad, None, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_matmul.impact_matmul_bmax(q, cols[0], cols[1].float(), None,
                                       512)
    assert sidx._column_major(hi, None)[1] is None
    assert sidx._column_major(hi, lo[:, :0])[1] is None


def test_wrappers_validate_and_never_fall_back():
    x = torch.zeros(4, 512)
    with pytest.raises(ValueError):
        cuda_reduce.block_max(x.double(), 256)
    with pytest.raises(ValueError):
        cuda_reduce.block_max(x, 100)
    with pytest.raises(ValueError):
        cuda_topk.topk(x, 513)
    with pytest.raises(ValueError):
        cuda_gather.row_gather(x, torch.zeros(2, 3, dtype=torch.int64),
                               torch.zeros(2, dtype=torch.int32))
    # Neither CPU nor CUDA: the wrappers raise instead of computing.
    meta = torch.empty(4, 512, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_reduce.block_max(meta, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_topk.topk(meta, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gather.row_gather(
            meta, torch.empty(2, 3, dtype=torch.int32, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_matmul.impact_matmul_bmax(
            torch.empty(4, 128, device="meta"),
            torch.empty(128, 512, dtype=torch.bfloat16, device="meta"),
            None, None, 512)


def test_plain_path_does_not_count_launches():
    before = (cuda_reduce.launches, cuda_gather.launches, cuda_topk.launches,
              cuda_matmul.launches)
    x = torch.rand(4, 512)
    cuda_reduce.block_max(x, 256)
    cuda_topk.topk(x, 3)
    cuda_gather.row_gather(x, torch.zeros(2, 3, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32))
    cuda_matmul.impact_matmul_bmax(x[:, :128].contiguous(),
                                   torch.rand(128, 512).to(torch.bfloat16),
                                   None, None, 512)
    assert (cuda_reduce.launches, cuda_gather.launches, cuda_topk.launches,
            cuda_matmul.launches) == before


def test_build_is_lazy_and_keyed_by_sources(monkeypatch, tmp_path):
    path = _cuda_build.library_path()
    assert path.parent == _cuda_build.BUILD_DIR
    assert path == _cuda_build.library_path()
    assert {p.name for p in _cuda_build._sources()} == {
        "block_max.cu", "bm25_compare.cu", "impact_matmul.cu",
        "row_gather.cu", "topk.cu"}
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _cuda_build._sources():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_cuda_build, "CSRC", src)
    assert _cuda_build.library_path() == path
    (src / "topk.cu").write_text("// edited\n")
    assert _cuda_build.library_path() != path
    # Without nvcc the build raises and leaves nothing behind.
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build()
    assert not (tmp_path / "build").exists()


def test_launcher_signatures_match_the_sources():
    """Every ``extern "C"`` launcher in csrc/ has a ctypes signature of
    its arity (pointers and the stream as void*, ints as int)."""
    import re

    for ret, table in (("int", _cuda_build._SIGNATURES),
                       ("long long", _cuda_build._SIZES)):
        found = {}
        for src in _cuda_build._sources():
            for name, args in re.findall(
                    rf'extern "C" {ret} (\w+)\(([^)]*)\)', src.read_text()):
                found[name] = ["*" in a for a in args.split(",")]
        assert found.keys() == table.keys()
        for name, is_ptr in found.items():
            assert [t is _cuda_build._VP for t in table[name]] == is_ptr, name
