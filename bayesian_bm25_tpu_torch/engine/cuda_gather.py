"""K2 ``row_gather``: ``out[i, c] = scores[trows[i], sid[i, c]]``.

Replaces ``bayesian_bm25_tpu/engine/pallas_gather.py``
(``_row_gather_kernel`` through ``_row_gather_call`` / ``row_gather``).
It fetches the matmul-side base score of every merge candidate in
``split_index._sparse_merge``, on every merge pass: the light and heavy
tier-1 passes and the tier-2 (group-B) passes with their heavy half.

On the card the wrapper launches ``csrc/row_gather.cu``: one thread per
output element and a direct indexed load. Bound: bytes at scattered
addresses (one 32-byte sector per distinct (row, id >> 3)) and, at the
merge's shapes, the latency of a launch and two dependent reads of
device memory. The TPU kernel's one-hot MXU
products over a 3-way bf16 split, and the eligibility gates that came
with them (finite scores, D_pad <= 2^18, nt >= 64), are not carried
over: the kernel serves every merge, -inf (``doc_mask``) batches and
1M-document score matrices included. On the CPU the wrapper runs
:func:`row_gather_plain`, and only there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def row_gather_plain(scores: torch.Tensor, sid: torch.Tensor,
                     trows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: clamped advanced indexing plus a ``where``
    that returns 0.0 for ids outside [0, D_pad) and rows outside
    [0, nq)."""
    nq, d_pad = scores.shape
    rows = trows.long()
    ok = (sid >= 0) & (sid < d_pad) & ((rows >= 0) & (rows < nq))[:, None]
    vals = scores[rows.clamp(0, nq - 1)[:, None],
                  sid.long().clamp(0, d_pad - 1)]
    return torch.where(ok, vals, 0.0)


def row_gather(scores: torch.Tensor, sid: torch.Tensor,
               trows: torch.Tensor) -> torch.Tensor:
    """``scores`` (nq, D_pad) f32, ``sid`` (nt, cap) int32 in any order
    (ids outside [0, D_pad), the merge's D_pad sentinel among them, give
    0.0), ``trows`` (nt,) int32 (rows outside [0, nq) give 0.0) ->
    (nt, cap) f32, bit-exact."""
    global launches
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(
            f"row_gather: scores must be 2-D float32, got "
            f"{tuple(scores.shape)} {scores.dtype}")
    if sid.dim() != 2 or sid.dtype != torch.int32:
        raise ValueError(
            f"row_gather: sid must be 2-D int32, got "
            f"{tuple(sid.shape)} {sid.dtype}")
    if trows.shape != (sid.shape[0],) or trows.dtype != torch.int32:
        raise ValueError(
            f"row_gather: trows must be ({sid.shape[0]},) int32, got "
            f"{tuple(trows.shape)} {trows.dtype}")
    if not (scores.device == sid.device == trows.device):
        raise ValueError("row_gather: operands on different devices")
    if scores.device.type == "cpu":
        return row_gather_plain(scores, sid, trows)
    if scores.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {scores.device}")
    if not (scores.is_contiguous() and sid.is_contiguous()
            and trows.is_contiguous()):
        raise ValueError("row_gather takes contiguous tensors")
    nq, d_pad = scores.shape
    nt, cap = sid.shape
    out = torch.empty((nt, cap), dtype=torch.float32, device=scores.device)
    with torch.cuda.device(scores.device):
        err = _cuda_build.lib().bb25_row_gather(
            scores.data_ptr(), sid.data_ptr(), trows.data_ptr(),
            out.data_ptr(), nt, cap, d_pad, nq,
            _cuda_build.stream_ptr(scores))
    launches += 1
    _cuda_build.check(err, "bb25_row_gather")
    return out
