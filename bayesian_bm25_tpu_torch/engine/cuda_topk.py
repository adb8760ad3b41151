"""K3 ``topk``: exact row-wise top-k in ``lax.top_k``'s order.

Replaces ``bayesian_bm25_tpu/engine/pallas_topk.py`` (``_topk_kernel``
through ``_topk_call`` / ``topk``). The JAX package never wired that
kernel in, but the port needs it: ``torch.topk`` does not return equal
values lowest index first, and the blockwise leader selection's
exactness argument and the merge's tie parity both depend on that order.
It serves the block selection over (nq, G), the final leader top-k over
(nq, k * 256) and the merge's candidate top-k over (nt, cand_cap).

On the card the wrapper launches ``csrc/topk.cu``. For k <= WARP_K_MAX
(32, every k of the main path): one warp per row, one coalesced read of
the row, each lane's best k in registers, then k rounds of a warp
arg-best over the lanes' heads; no shared memory, no block barrier.
Above it: one thread block per row, k rounds of a block-wide arg-max over
(value desc, index asc). Bound: bytes (each row read once). On the CPU
the wrapper runs :func:`topk_plain`, and only there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

# Largest k of the warp kernel (kWarpKMax in csrc/topk.cu); a larger k
# takes the block-round kernel.
WARP_K_MAX = 32


def topk_plain(x: torch.Tensor, k: int):
    """Plain PyTorch version: a stable descending sort, then the first
    k columns."""
    v, p = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k].contiguous(), p[:, :k].to(torch.int32)


def topk(x: torch.Tensor, k: int):
    """(nq, C) f32 without NaN -> (values (nq, k) f32, positions (nq, k)
    int32), equal to ``lax.top_k(x, k)``: ties lowest index first, -inf
    entries in index order. Any C >= k."""
    global launches
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(
            f"topk takes a 2-D float32 tensor, got {tuple(x.shape)} "
            f"{x.dtype}")
    nq, c = x.shape
    if not 0 < k <= c:
        raise ValueError(f"topk needs 0 < k <= C={c}, got k={k}")
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("topk takes a contiguous tensor")
    vals = torch.empty((nq, k), dtype=torch.float32, device=x.device)
    pos = torch.empty((nq, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _cuda_build.lib().bb25_topk(
            x.data_ptr(), vals.data_ptr(), pos.data_ptr(), nq, c, k,
            _cuda_build.stream_ptr(x))
    launches += 1
    _cuda_build.check(err, "bb25_topk")
    return vals, pos
