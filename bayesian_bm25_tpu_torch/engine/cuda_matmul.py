"""K4 ``impact_matmul_bmax``: the scoring matmul with the leader-selection
block maxima computed in the same pass.

Replaces ``bayesian_bm25_tpu/engine/pallas_matmul.py`` (``_kernel_pair``,
``_kernel_int8`` and ``_kernel_single`` through ``_call`` /
``impact_matmul_bmax``). ``split_index.retrieve_topk_split_sparse`` takes
it where :func:`fused_route` says so (by default wherever the index is on
a CUDA card; ``split_index.FUSED_MM``) and hands its maxima to the
blockwise leader selection, so K1's re-read of the score matrix
disappears. On an H100 the product stage of an 8,192-query request fell
from 9.66 to 0.37 ms per thousand queries in hilo storage (57,638
documents) and from 20.8 to 2.47 in int8 (1M documents) against the
library route (PERF.md section 6).

Storage modes, as ``split_index._impact_matmul``:
  * int8 (``impact_scale`` given): int8 pair, integer dots, scores
    ``fma(hidot, s0, lodot * s1)`` -- bit-equal to the unfused route;
  * hilo (``impact_lo_t`` a non-empty bf16 matrix): the two dots summed on
    their own and added once;
  * single bf16: one dot.
A single float32 matrix raises ``ValueError``, as in the JAX package.

The impact matrices come column-major, (K, D): the copy the split
index keeps beside its row-major matrices
(``SplitBM25Index.impact_columns``), the one layout this module takes.
On the card the wrapper launches ``csrc/impact_matmul.cu``: per tile of
64 query rows, the union of their nonzero columns and their compacted
counts, then a product over that union only, which reads the kept copy
(no call transposes it). int8 runs on the tensor cores, bit-equal to
the unfused route. The bf16 modes run on the CUDA cores, adding each
dot's terms in ascending column order with one rounding each, as a
float32 product that accumulates one k after another does; the tensor
cores' bf16 product, which adds them in its own order, measured 2 ulps
from the plain version on hilo operands with the path's sparsity and
random impact values. Bound: bytes (the score matrix written once
dominates: 1.68 GB at (8192, 51200)). The counts enter the product in
int8 under int8 storage and in bf16 under the bf16 modes, as the JAX
package casts them. On the CPU the wrapper runs
:func:`impact_matmul_bmax_plain`, and only there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build, cuda_reduce
from bayesian_bm25_tpu_torch.engine import split_index as sidx

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

BLOCK = 256                 # columns per maximum, the selection block
_MODES = {"int8": 0, "pair": 1, "single": 2}
# The kernel's union bitmap holds K <= 32768 columns (kMaxWords * 32).
_K_MAX = 32768


def eligible(nq: int, K: int, D: int, block: int) -> bool:
    """Shapes the CUDA kernel takes: any nq, 256-column maxima over a doc
    axis that is a multiple of 256, and 0 < K <= 32768. Wider than the
    JAX package's rule, which also needs nq % 256 == 0, D % 2048 == 0,
    K % 128 == 0 and a VMEM budget (TPU tiling only)."""
    del nq
    return block == BLOCK and D > 0 and D % BLOCK == 0 and 0 < K <= _K_MAX


def fused_route(impact: torch.Tensor, impact_lo, impact_scale, nq: int, *,
                doc_mask=None, approx: bool = False, coarse: bool = False,
                q_int8_ok: bool = True) -> bool:
    """True where the sparse-candidate path takes K4 for ``nq`` queries
    over the row-major ``impact`` (one shard's, on the sharded scorer):
    ``split_index.FUSED_MM`` allows it (None: where ``impact`` is on a
    CUDA card), there is no ``doc_mask``, neither ``approx`` nor
    ``coarse``, the counts are exact in int8 (``q_int8_ok``), the shape
    is :func:`eligible` and the storage is int8, hilo or bf16. The one
    rule of the single-device and the sharded scorer."""
    if not (sidx.FUSED_MM or (sidx.FUSED_MM is None
                              and impact.device.type == "cuda")):
        return False
    D, K = impact.shape
    return (doc_mask is None and not approx and not coarse and q_int8_ok
            and eligible(nq, K, D, BLOCK)
            and (impact_scale is not None or impact_lo is not None
                 or impact.dtype == torch.bfloat16))


def _mode(impact, impact_lo, impact_scale) -> str:
    if impact_scale is not None:
        if impact.dtype != torch.int8 or impact_lo is None or (
                impact_lo.dtype != torch.int8):
            raise ValueError(
                "int8 storage needs an int8 impact pair beside its scale")
        return "int8"
    if impact_lo is not None and impact_lo.numel():
        if impact.dtype != torch.bfloat16 or (
                impact_lo.dtype != torch.bfloat16):
            raise ValueError("the hilo pair must be two bfloat16 matrices")
        return "pair"
    if impact.dtype != torch.bfloat16:
        raise ValueError(
            "fused matmul+bmax supports hilo/int8/bf16 storage only "
            f"(got single {impact.dtype}); use the unfused path")
    return "single"


def impact_matmul_bmax_plain(qvec, impact_t, impact_lo_t, impact_scale,
                             n_docs: int):
    """Plain PyTorch version: the unfused route, ``_impact_matmul`` on
    the row-major views ``impact_t.t()``, and the masked
    ``block_max_plain``. On the card the int8 pair is first copied
    row-major: cuBLASLt's int8 product refuses the transposed view for
    some K (K = 104 on an H100)."""
    mode = _mode(impact_t, impact_lo_t, impact_scale)
    hi = impact_t.t()
    lo = impact_lo_t.t() if mode != "single" else None
    if mode == "int8" and qvec.device.type == "cuda":
        hi, lo = hi.contiguous(), lo.contiguous()
    scores = sidx._impact_matmul(qvec, hi, lo, scale=impact_scale)
    return scores, cuda_reduce.block_max_plain(scores, BLOCK,
                                               valid_upto=n_docs)


def impact_matmul_bmax(qvec: torch.Tensor, impact_t: torch.Tensor,
                       impact_lo_t: torch.Tensor | None,
                       impact_scale: torch.Tensor | None, n_docs: int):
    """``qvec`` (nq, K) float32 counts (within int8 range under int8
    storage), rows contiguous (a column slice of a wider matrix is
    taken as it is); ``impact_t``/``impact_lo_t`` the impact matrices
    column-major, (K, D) and contiguous, as
    ``SplitBM25Index.impact_columns`` keeps them: an int8 pair with
    ``impact_scale`` (2, D) float32, a bf16 pair, or one bf16 matrix
    (``impact_lo_t`` None or empty). Returns (scores (nq, D) float32,
    bmax (nq, D // 256) float32): raw scores, pad columns included;
    columns >= ``n_docs`` count as -inf in the maxima only."""
    global launches
    mode = _mode(impact_t, impact_lo_t, impact_scale)
    nq, K = qvec.shape
    D = impact_t.shape[1]
    if qvec.dtype != torch.float32 or impact_t.shape != (K, D):
        raise ValueError(
            f"impact_matmul_bmax: qvec {tuple(qvec.shape)} {qvec.dtype} "
            "does not match the column-major impact matrix "
            f"{tuple(impact_t.shape)}")
    mats = [impact_t] + ([impact_lo_t] if mode != "single" else [])
    if any(m.shape != (K, D) or not m.is_contiguous() for m in mats):
        raise ValueError("impact_matmul_bmax: the impact matrices must be "
                         f"column-major, contiguous ({K}, {D}) each")
    if mode == "int8" and (impact_scale.shape != (2, D)
                           or impact_scale.dtype != torch.float32):
        raise ValueError("impact_matmul_bmax: scale must be (2, D) float32")
    if D % BLOCK:
        raise ValueError(f"impact_matmul_bmax: D={D} is not a multiple "
                         f"of {BLOCK}")
    ops = [qvec] + mats + ([impact_scale] if mode == "int8" else [])
    if any(t.device != qvec.device for t in ops):
        raise ValueError("impact_matmul_bmax: operands on different devices")
    if qvec.device.type == "cpu":
        return impact_matmul_bmax_plain(qvec, impact_t, impact_lo_t,
                                        impact_scale, n_docs)
    if qvec.device.type != "cuda":
        raise ValueError(
            f"impact_matmul_bmax: unsupported device {qvec.device}")
    if not eligible(nq, K, D, BLOCK):
        raise ValueError(
            f"impact_matmul_bmax: K={K} outside the kernel's (0, {_K_MAX}]")
    if qvec.stride(1) != 1 or (impact_scale is not None
                               and not impact_scale.is_contiguous()):
        raise ValueError("impact_matmul_bmax takes contiguous operands "
                         "(qvec: contiguous rows)")
    scores = torch.empty((nq, D), dtype=torch.float32, device=qvec.device)
    bmax = torch.empty((nq, D // BLOCK), dtype=torch.float32,
                       device=qvec.device)
    lib = _cuda_build.lib()
    # The compaction's scratch (column ids and compacted counts, a few
    # bytes per query row and column, laid out by the kernel's source);
    # freed to the caching allocator on return, it is reused only by
    # work queued after the kernel on the same stream.
    scratch = torch.empty(
        lib.bb25_impact_matmul_scratch_bytes(_MODES[mode], nq, K),
        dtype=torch.uint8, device=qvec.device)
    nd = max(0, min(int(n_docs), D))
    with torch.cuda.device(qvec.device):
        err = lib.bb25_impact_matmul_bmax(
            qvec.data_ptr(), impact_t.data_ptr(),
            impact_lo_t.data_ptr() if mode != "single" else None,
            impact_scale.data_ptr() if mode == "int8" else None,
            scores.data_ptr(), bmax.data_ptr(), scratch.data_ptr(),
            _MODES[mode], nq, K, qvec.stride(0), D, nd,
            _cuda_build.stream_ptr(qvec))
    launches += 1
    _cuda_build.check(err, "bb25_impact_matmul_bmax")
    return scores, bmax
