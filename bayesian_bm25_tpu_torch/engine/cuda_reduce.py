"""K1 ``block_max``: per-row maxima over contiguous column blocks.

Replaces ``bayesian_bm25_tpu/engine/pallas_reduce.py`` (``_bmax_kernel``
and ``_bmax2d_kernel`` through ``_block_max_call`` / ``block_max``). It
feeds leader selection in ``split_index.exact_topk_blockwise``.

On the card the wrapper launches ``csrc/block_max.cu``. Bound: bytes read
(the (8192, 51200) f32 score matrix, 1.68 GB, read once); the kernel folds
each 256-column block in one warp's registers and applies the
``valid_upto`` mask there, so no masked copy of the matrix is made. On
the CPU the wrapper runs :func:`block_max_plain`, and only there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0


def block_max_plain(scores: torch.Tensor, block: int,
                    valid_upto: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``amax`` over the reshaped view after a
    ``where`` mask of columns >= ``valid_upto``."""
    nq, d = scores.shape
    if valid_upto is not None and valid_upto < d:
        col = torch.arange(d, device=scores.device)
        scores = torch.where(col < valid_upto, scores, float("-inf"))
    return scores.reshape(nq, d // block, block).amax(dim=2)


def block_max(scores: torch.Tensor, block: int,
              valid_upto: int | None = None) -> torch.Tensor:
    """(nq, D) f32 -> (nq, D // block) f32 block maxima, columns at or
    past ``valid_upto`` counting as -inf. Bit-identical to
    :func:`block_max_plain` for inputs without NaN."""
    global launches
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(
            f"block_max takes a 2-D float32 tensor, got "
            f"{tuple(scores.shape)} {scores.dtype}")
    nq, d = scores.shape
    if block <= 0 or block % 32 or d % block:
        raise ValueError(
            f"block must be a positive multiple of 32 dividing D={d}, "
            f"got {block}")
    if valid_upto is not None and valid_upto < 0:
        raise ValueError(f"valid_upto must be >= 0, got {valid_upto}")
    if scores.device.type == "cpu":
        return block_max_plain(scores, block, valid_upto)
    if scores.device.type != "cuda":
        raise ValueError(f"block_max: unsupported device {scores.device}")
    if not scores.is_contiguous():
        raise ValueError("block_max takes a contiguous tensor")
    out = torch.empty((nq, d // block), dtype=torch.float32,
                      device=scores.device)
    vu = d if valid_upto is None else min(int(valid_upto), d)
    with torch.cuda.device(scores.device):
        err = _cuda_build.lib().bb25_block_max(
            scores.data_ptr(), out.data_ptr(), nq, d, block, vu,
            _cuda_build.stream_ptr(scores))
    launches += 1
    _cuda_build.check(err, "bb25_block_max")
    return out
