"""K5 ``compare``: BM25 scores and tf counts against a doc-major table.

Replaces ``bayesian_bm25_tpu/engine/pallas_bm25.py`` (``_bm25_kernel``
through ``_score_chunk_pallas`` / ``score_all_pallas``). One function
serves every compare on the port's paths: the doc-major table of
``engine/scoring.score_all`` and the tail and overflow tables of
``split_index._compare_table``:

    scores[q, r] = sum_j c[q, j] * sum_t w[r, t] * [ids[r, t] == qids[q, j]]
    tfs[q, r]    = sum_j sum_t [ids[r, t] == qids[q, j]]

The summation order is ``score_all_xla``'s, the path the JAX package
runs: query slots in ascending order, each added as one fused
multiply-add (XLA contracts ``acc + c_j * s_j``). Table rows hold unique
ids, so each ``s_j`` is exact and the result is bit-equal to the JAX
package. A separate multiply and add rounds twice and differs in the
last ulp wherever ``c_j`` is not a power of two.

On the card the wrapper launches ``csrc/bm25_compare.cu``. Bound: bytes
(the table, the queries and both outputs once; one lookup per query slot
and row). For rows of T <= HASH_MAX_T ids a block owns 32 table rows,
one per lane, and builds each row's open-addressed hash (id -> weight)
in shared memory once: at least 256 and 2T slots, -1 as the empty key,
interleaved so that every lane reads its own banks. When all the
block's ids fit, as in every doc-major table, the slot is the id itself.
Each warp then takes one query at a time and each lane probes its row
once per query slot; a block keeps its hash for a long run of queries.
A query slot of -1 matches the row's pads: its tile takes a path that
scans the row. Wider rows take a global-memory scan kernel. On the CPU
the wrapper runs :func:`compare_plain`, and only there.
"""

from __future__ import annotations

import torch

from bayesian_bm25_tpu_torch.engine import _cuda_build

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

# Widest row the shared-memory hash takes (kHashMaxT in
# csrc/bm25_compare.cu); wider tables take the global-memory scan kernel.
HASH_MAX_T = 256

# Elements of one (queries, rows, T) compare block in the plain version.
_PLAIN_BLOCK = 1 << 24


def compare_plain(table_ids: torch.Tensor, table_w: torch.Tensor,
                  qids: torch.Tensor, qcnt: torch.Tensor):
    """Plain PyTorch version: query slots in ascending order, the matched
    weight summed over the row and added with ``addcmul`` (one fused
    multiply-add), in blocks of queries."""
    nq, Q = qids.shape
    R, T = table_ids.shape
    chunk = max(1, _PLAIN_BLOCK // max(R * T, 1))
    outs_s, outs_t = [], []
    for q0 in range(0, nq, chunk):
        qrow = qids[q0:q0 + chunk]
        crow = qcnt[q0:q0 + chunk]
        acc = torch.zeros((qrow.shape[0], R), dtype=torch.float32,
                          device=table_w.device)
        tf = torch.zeros_like(acc)
        for j in range(Q):
            m = table_ids[None] == qrow[:, j, None, None]
            s_j = torch.where(m, table_w[None], 0.0).sum(dim=2)
            acc = torch.addcmul(acc, crow[:, j, None], s_j)
            tf = tf + m.sum(dim=2, dtype=torch.float32)
        outs_s.append(acc)
        outs_t.append(tf)
    if not outs_s:
        empty = torch.zeros((0, R), dtype=torch.float32,
                            device=table_w.device)
        return empty, empty.clone()
    return torch.cat(outs_s), torch.cat(outs_t)


def compare(table_ids: torch.Tensor, table_w: torch.Tensor,
            qids: torch.Tensor, qcnt: torch.Tensor):
    """``table_ids`` (R, T) int32, ``table_w`` (R, T) float32, ``qids``
    (nq, Q) int32, ``qcnt`` (nq, Q) float32 -> (scores, tfs), each
    (nq, R) float32, for any R, T, nq and Q. A table row holds each id
    at most once (pads aside), as every index table does; then the
    kernel and the plain version agree bit for bit."""
    global launches
    if table_ids.dim() != 2 or table_ids.dtype != torch.int32:
        raise ValueError(
            f"compare: table_ids must be 2-D int32, got "
            f"{tuple(table_ids.shape)} {table_ids.dtype}")
    if table_w.shape != table_ids.shape or table_w.dtype != torch.float32:
        raise ValueError(
            f"compare: table_w must be {tuple(table_ids.shape)} float32, "
            f"got {tuple(table_w.shape)} {table_w.dtype}")
    if qids.dim() != 2 or qids.dtype != torch.int32:
        raise ValueError(
            f"compare: qids must be 2-D int32, got {tuple(qids.shape)} "
            f"{qids.dtype}")
    if qcnt.shape != qids.shape or qcnt.dtype != torch.float32:
        raise ValueError(
            f"compare: qcnt must be {tuple(qids.shape)} float32, got "
            f"{tuple(qcnt.shape)} {qcnt.dtype}")
    if not (table_ids.device == table_w.device == qids.device
            == qcnt.device):
        raise ValueError("compare: operands on different devices")
    if table_ids.device.type == "cpu":
        return compare_plain(table_ids, table_w, qids, qcnt)
    if table_ids.device.type != "cuda":
        raise ValueError(f"compare: unsupported device {table_ids.device}")
    if not all(t.is_contiguous() for t in (table_ids, table_w, qids, qcnt)):
        raise ValueError("compare takes contiguous tensors")
    R, T = table_ids.shape
    nq, Q = qids.shape
    scores = torch.empty((nq, R), dtype=torch.float32,
                         device=table_ids.device)
    tfs = torch.empty_like(scores)
    if nq == 0 or R == 0:
        return scores, tfs
    with torch.cuda.device(table_ids.device):
        err = _cuda_build.lib().bb25_bm25_compare(
            table_ids.data_ptr(), table_w.data_ptr(), qids.data_ptr(),
            qcnt.data_ptr(), scores.data_ptr(), tfs.data_ptr(), R, T, nq, Q,
            _cuda_build.stream_ptr(table_ids))
    launches += 1
    _cuda_build.check(err, "bb25_bm25_compare")
    return scores, tfs
