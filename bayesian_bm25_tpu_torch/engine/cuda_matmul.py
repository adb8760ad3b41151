"""K4 ``impact_matmul_bmax``: the scoring matmul with the leader-selection
block maxima computed in the same pass.

Replaces ``bayesian_bm25_tpu/engine/pallas_matmul.py`` (``_kernel_pair``,
``_kernel_int8`` and ``_kernel_single`` through ``_call`` /
``impact_matmul_bmax``). ``split_index.retrieve_topk_split_sparse`` takes
it when ``split_index.FUSED_MM`` is set (see the gate in
``models/scorer.py``) and hands its maxima to the blockwise leader
selection, so K1's re-read of the score matrix disappears.

Storage modes, as ``split_index._impact_matmul``:
  * int8 (``impact_scale`` given): int8 pair, integer dots, scores
    ``fma(hidot, s0, lodot * s1)`` -- bit-equal to the unfused route;
  * hilo (``impact_lo`` a non-empty bf16 matrix): the two dots summed on
    their own and added once;
  * single bf16: one dot.
A single float32 matrix raises ``ValueError``, as in the JAX package.

On the card the wrapper launches ``csrc/impact_matmul.cu``: a transpose
of the impact matrices into column-major scratch, then the product,
which streams, for each query row, only the impact columns of its
nonzero counts. Bound: bytes (the score matrix written once dominates:
1.68 GB at (8192, 51200)); the query rows are >= 99% zeros at bench.py's
regime, and no zero term is read or added. The bf16
modes sum each dot's nonzero terms in ascending column order, so they
may differ from the library product of the plain version by 1 ulp. On
the CPU the wrapper runs :func:`impact_matmul_bmax_plain`, and only
there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build, cuda_reduce
from bayesian_bm25_tpu_torch.engine import split_index as sidx

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

BLOCK = 256                 # columns per maximum, the selection block
_MODES = {"int8": 0, "pair": 1, "single": 2}
# K is bounded only by the launcher's int arithmetic; this keeps the
# transposed scratch (D * K elements) within reason.
_K_MAX = 32768


def eligible(nq: int, K: int, D: int, block: int) -> bool:
    """Shapes the CUDA kernel takes: any nq, 256-column maxima over a doc
    axis that is a multiple of 256, and 0 < K <= 32768. Wider than the
    JAX package's rule, which also needs nq % 256 == 0, D % 2048 == 0,
    K % 128 == 0 and a VMEM budget (TPU tiling only)."""
    del nq
    return block == BLOCK and D > 0 and D % BLOCK == 0 and 0 < K <= _K_MAX


def _mode(impact, impact_lo, impact_scale) -> str:
    if impact_scale is not None:
        if impact.dtype != torch.int8 or impact_lo is None or (
                impact_lo.dtype != torch.int8):
            raise ValueError(
                "int8 storage needs an int8 impact pair beside its scale")
        return "int8"
    if impact_lo is not None and impact_lo.shape[1]:
        if impact.dtype != torch.bfloat16 or (
                impact_lo.dtype != torch.bfloat16):
            raise ValueError("the hilo pair must be two bfloat16 matrices")
        return "pair"
    if impact.dtype != torch.bfloat16:
        raise ValueError(
            "fused matmul+bmax supports hilo/int8/bf16 storage only "
            f"(got single {impact.dtype}); use the unfused path")
    return "single"


def impact_matmul_bmax_plain(qvec, impact, impact_lo, impact_scale,
                             n_docs: int):
    """Plain PyTorch version: the unfused route, ``_impact_matmul`` and
    the masked ``block_max_plain``."""
    _mode(impact, impact_lo, impact_scale)
    scores = sidx._impact_matmul(qvec, impact, impact_lo, scale=impact_scale)
    return scores, cuda_reduce.block_max_plain(scores, BLOCK,
                                               valid_upto=n_docs)


def impact_matmul_bmax(qvec: torch.Tensor, impact: torch.Tensor,
                       impact_lo: torch.Tensor | None,
                       impact_scale: torch.Tensor | None, n_docs: int):
    """``qvec`` (nq, K) float32 counts (within int8 range under int8
    storage), rows contiguous (a column slice of a wider matrix is
    taken as it is); ``impact``/``impact_lo`` (D, K) int8 pair with
    ``impact_scale`` (2, D) float32, bf16 pair, or one bf16 matrix
    (``impact_lo`` None or zero-width). Returns (scores (nq, D) float32,
    bmax (nq, D // 256) float32): raw scores, pad columns included;
    columns >= ``n_docs`` count as -inf in the maxima only."""
    global launches
    mode = _mode(impact, impact_lo, impact_scale)
    nq, K = qvec.shape
    D = impact.shape[0]
    if qvec.dtype != torch.float32 or impact.shape != (D, K):
        raise ValueError(
            f"impact_matmul_bmax: qvec {tuple(qvec.shape)} {qvec.dtype} "
            f"does not match impact {tuple(impact.shape)}")
    if mode != "single" and impact_lo.shape != impact.shape:
        raise ValueError("impact_matmul_bmax: impact_lo shape differs")
    if mode == "int8" and (impact_scale.shape != (2, D)
                           or impact_scale.dtype != torch.float32):
        raise ValueError("impact_matmul_bmax: scale must be (2, D) float32")
    if D % BLOCK:
        raise ValueError(f"impact_matmul_bmax: D={D} is not a multiple "
                         f"of {BLOCK}")
    ops = [qvec, impact] + ([impact_lo] if mode != "single" else []) + (
        [impact_scale] if mode == "int8" else [])
    if any(t.device != qvec.device for t in ops):
        raise ValueError("impact_matmul_bmax: operands on different devices")
    if qvec.device.type == "cpu":
        return impact_matmul_bmax_plain(qvec, impact, impact_lo,
                                        impact_scale, n_docs)
    if qvec.device.type != "cuda":
        raise ValueError(
            f"impact_matmul_bmax: unsupported device {qvec.device}")
    if not eligible(nq, K, D, BLOCK):
        raise ValueError(
            f"impact_matmul_bmax: K={K} outside the kernel's (0, {_K_MAX}]")
    if not all(t.is_contiguous() for t in ops[1:]) or qvec.stride(1) != 1:
        raise ValueError("impact_matmul_bmax takes contiguous operands "
                         "(qvec: contiguous rows)")
    scores = torch.empty((nq, D), dtype=torch.float32, device=qvec.device)
    bmax = torch.empty((nq, D // BLOCK), dtype=torch.float32,
                       device=qvec.device)
    # Scratch for the kernel's column-major copies of the impact matrices;
    # freed to the caching allocator on return, it is reused only by work
    # queued after the kernel on the same stream.
    scratch = torch.empty((1 if mode == "single" else 2) * D * K,
                          dtype=impact.dtype, device=qvec.device)
    nd = max(0, min(int(n_docs), D))
    with torch.cuda.device(qvec.device):
        err = _cuda_build.lib().bb25_impact_matmul_bmax(
            qvec.data_ptr(), impact.data_ptr(),
            impact_lo.data_ptr() if mode != "single" else None,
            impact_scale.data_ptr() if mode == "int8" else None,
            scores.data_ptr(), bmax.data_ptr(), scratch.data_ptr(),
            _MODES[mode], nq, K, qvec.stride(0), D, nd,
            _cuda_build.stream_ptr(qvec))
    launches += 1
    _cuda_build.check(err, "bb25_impact_matmul_bmax")
    return scores, bmax
