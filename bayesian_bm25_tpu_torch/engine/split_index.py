"""Frequency-split BM25 index: a dense impact matmul for frequent terms
plus term-major postings for the rare tail.

Counterpart of ``bayesian_bm25_tpu/engine/split_index.py``. The host-side
builders and encoders are the JAX package's numpy code, kept bit-equal
(tests/test_torch_index.py); the query encoder first tries the same one
C++ pass as the JAX package (``engine/native.py``), whose output equals
the numpy twin's (tests/test_torch_native.py). The device side is plain
PyTorch around five
hand-written CUDA kernels:

  * K1 ``cuda_reduce.block_max``: per-256-column maxima for the blockwise
    leader selection (:func:`exact_topk_blockwise`);
  * K2 ``cuda_gather.row_gather``: the merge's base-score gather
    (:func:`_sparse_merge`);
  * K3 ``cuda_topk.topk``: every top-k on the path, in ``lax.top_k``'s
    tie order (lowest index first), which ``torch.topk`` does not give;
  * K4 ``cuda_matmul.impact_matmul_bmax``: the frequent-term product
    with the leader-selection block maxima in its epilogue, the
    sparse-candidate path's route on the card (:data:`FUSED_MM`);
  * K5 ``cuda_bm25.compare``: the doc-major compare tail and overflow
    table (:func:`_compare_table`) of the dense paths (calibration
    scoring, ``probabilities_all_split`` and ``retrieve_topk_split``).

Unfused (on the CPU, and on the card where K4's gate refuses: a
``doc_mask``, ``approx``, ``coarse``, a count above 127 under int8,
float32 storage), the frequent-term product is a library matmul, as the
JAX package leaves it to XLA: int8 pairs through ``torch._int_mm``
(exact int32 accumulation), the other storage modes in float32 with
TF32 off.

``approx=True`` selects exactly: torch has no ``lax.approx_max_k``, and
on the CPU ``approx_max_k`` is itself exact, in ``lax.top_k``'s tie
order, so the port's approximate tier returns the JAX package's CPU
results bit for bit and stays within its documented recall on a chip.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                            cuda_reduce, cuda_topk)
from bayesian_bm25_tpu_torch.engine import index as eidx
from bayesian_bm25_tpu_torch.engine import native
from bayesian_bm25_tpu_torch.engine.index import BM25Index, to_device
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.utils import spans


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Rank-packed candidate build for the sparse merge (see
# compact_tail_postings); engages only when it narrows the layout.
PACKED_BUILD = True

# The frequent-term product's route on the sparse-candidate path
# (cuda_matmul.fused_route, asked by both scorers): K4 (engine/
# cuda_matmul.py), the product and the leader-selection block maxima in
# one launch over the columns the queries touch, or the library product,
# its float32 epilogue and K1. None, the default, takes K4 where the
# index lives on a CUDA card: on an H100 (700 W) it served the benchmark's
# 8,192-query requests at 3.4x the library route's queries per second in
# hilo storage (57,638 documents) and 2.9x in int8 (1M documents), with
# the one-query latency level and 43% / 20% less peak memory (PERF.md
# section 6). The CPU keeps the library product: there K4's plain version
# is that product over a transposed second copy of the matrices, the same
# numbers for twice the memory.
# True and False force either route wherever the rest of the gate holds.
# The JAX package's own flag stays False (its Pallas kernel measured as
# a wash on a TPU v5e).
FUSED_MM = None

# Light/heavy cap split of the tier-1 tail group (split_light_heavy):
# engages only when the gathered-element savings clear these floors.
LIGHT_HEAVY = True
_LH_MIN_SAVE = 1_000_000   # min gathered-element savings to engage
_LH_MIN_RATIO = 2.0        # min (no-split / split) element ratio
# Tier-2 (group B) cap split: B groups are small but run at the widest
# caps, so the savings floor is lower.
_LHB_MIN_SAVE = 250_000
_LHB_MIN_RATIO = 1.3

# Rare postings stop paying off past this table size (entries, 8 B per
# entry -> 1 GB cap).
_POSTINGS_MAX_ENTRIES = 128_000_000


@dataclass
class SplitBM25Index:
    """Frequency-split index built from a BM25Index; tensors on one
    device, host mirrors in numpy. Fields as in the JAX package."""

    base: BM25Index
    n_frequent: int
    freq_slot_of_term: np.ndarray = field(repr=False)
    # (D_pad, K) impact + presence matrices for frequent terms: int8 hi
    # (with dense_impact_lo and impact_scale) under "int8", bf16 hi
    # (with a bf16 residual) under "hilo", bf16 under "bf16", f32 under
    # "f32"; presence is bf16 0/1.
    dense_impact: torch.Tensor = field(repr=False)
    dense_presence: torch.Tensor = field(repr=False)
    # narrow doc-major table for rare terms (first T_A per doc)
    tail_term_ids: torch.Tensor = field(repr=False)
    tail_weights: torch.Tensor = field(repr=False)
    dense_impact_lo: torch.Tensor | None = field(repr=False, default=None)
    # overflow rows for the few docs with more rare terms
    over_term_ids: torch.Tensor | None = field(repr=False, default=None)
    over_weights: torch.Tensor | None = field(repr=False, default=None)
    over_doc_ids: torch.Tensor | None = field(repr=False, default=None)
    # term-major rare postings (R+1, P); row R is the empty sentinel row
    rare_slot_of_term: np.ndarray = field(repr=False, default=None)
    post_doc_ids: torch.Tensor | None = field(repr=False, default=None)
    post_weights: torch.Tensor | None = field(repr=False, default=None)
    rare_df: np.ndarray = field(repr=False, default=None)
    post_w_positive: bool = False
    # tier-2 postings for width-capped indexes (None when all fit tier 1)
    rare2_slot_of_term: np.ndarray | None = field(repr=False, default=None)
    post2_doc_ids: torch.Tensor | None = field(repr=False, default=None)
    post2_weights: torch.Tensor | None = field(repr=False, default=None)
    rare2_df: np.ndarray | None = field(repr=False, default=None)
    # (2, D_pad) per-doc dequantization scales under "int8" storage
    impact_scale: torch.Tensor | None = field(repr=False, default=None)
    # K4's operands, the impact matrices column-major: built by
    # impact_columns on first use and kept; a rebuilt index starts
    # without them.
    _impact_cols: tuple | None = field(repr=False, default=None,
                                       compare=False)

    def impact_columns(self) -> tuple:
        """(hi, lo) of the impact matrices column-major, (K, D_pad) each
        and contiguous (lo None for a single matrix): the one layout K4
        (``cuda_matmul.impact_matmul_bmax``) takes, built once on the
        index's device and kept beside the row-major matrices, which the
        unfused route goes on reading. The copy (as large as the
        matrices: 2.05 GB at 1M documents in int8) lies outside the
        scorer's ``_SPLIT_BUDGET_BYTES``, and the first fused call
        builds it."""
        if self._impact_cols is None:
            self._impact_cols = _column_major(self.dense_impact,
                                              self.dense_impact_lo)
        return self._impact_cols

    @property
    def n_docs(self) -> int:
        return self.base.n_docs

    @property
    def vocab(self) -> dict:
        return self.base.vocab

    @property
    def device(self) -> torch.device:
        return self.dense_impact.device


def _column_major(impact: torch.Tensor, impact_lo: torch.Tensor | None):
    """(impact.t(), impact_lo.t()) as contiguous copies; the second is
    None where there is no residual matrix."""
    lo = (impact_lo.t().contiguous()
          if impact_lo is not None and impact_lo.shape[1] else None)
    return impact.t().contiguous(), lo


def build_split_index(
    base: BM25Index,
    n_frequent: int = 1024,
    *,
    storage: str = "f32",
    tail_pad_multiple: int = 8,
    enable_overflow: bool | str = "auto",
    device=None,
) -> SplitBM25Index:
    """Split the doc-major table by document-frequency rank.

    ``storage`` is "f32", "hilo" (bf16 hi + bf16 residual), "bf16" or
    "int8" (int8 hi/lo pair with per-doc scales); see the JAX
    package's ``build_split_index`` for each mode's error class. The
    tensors go to ``device`` (default: the base index's device).
    """
    if storage not in ("f32", "hilo", "bf16", "int8"):
        raise ValueError(
            f"storage must be f32/hilo/bf16/int8, got {storage!r}")
    device = base.doc_lengths.device if device is None else device
    tids = base.term_ids_host
    w = base.weights_host
    D_pad = tids.shape[0]
    V = base.n_terms

    K = min(_round_up(n_frequent, 128), _round_up(max(V, 1), 128))
    order = np.argsort(-base.doc_frequencies, kind="stable")
    freq_slot = np.full(V, K, dtype=np.int32)
    top = order[: min(n_frequent, V)]
    freq_slot[top] = np.arange(len(top), dtype=np.int32)

    valid = tids >= 0
    slots = np.where(valid, freq_slot[np.maximum(tids, 0)], K)
    is_freq = slots < K

    # Dense tables, built in 128k-doc blocks in the final storage dtype
    # (the per-doc quantization is row-local, so blocks are
    # bit-identical to a whole-matrix build). Presence counts term
    # membership, not weight > 0.
    fsel = valid & is_freq
    presence_u8 = np.zeros((D_pad, K), dtype=np.uint8)
    hi_out = lo_out = s_arr = s2_arr = imp_f32 = None
    if storage == "int8":
        hi_out = np.empty((D_pad, K), dtype=np.int8)
        lo_out = np.empty((D_pad, K), dtype=np.int8)
        s_arr = np.empty(D_pad, dtype=np.float32)
        s2_arr = np.empty(D_pad, dtype=np.float32)
    elif storage in ("hilo", "bf16"):
        # bf16 results are built as torch CPU tensors: numpy has no
        # bfloat16, and tensor.to(torch.bfloat16) rounds to nearest even
        # as ml_dtypes does.
        hi_out = torch.empty((D_pad, K), dtype=torch.bfloat16)
        if storage == "hilo":
            lo_out = torch.empty((D_pad, K), dtype=torch.bfloat16)
    else:
        imp_f32 = np.zeros((D_pad, K), dtype=np.float32)

    _B = 1 << 17
    blk = (np.zeros((min(_B, D_pad), K), dtype=np.float32)
           if storage != "f32" else None)
    for d0 in range(0, D_pad, _B):
        d1 = min(d0 + _B, D_pad)
        bsel = fsel[d0:d1]
        br, _ = np.nonzero(bsel)
        bslot = slots[d0:d1][bsel]
        bw = w[d0:d1][bsel].astype(np.float32, copy=False)
        presence_u8[d0:d1][br, bslot] = 1
        if storage == "f32":
            imp_f32[d0:d1][br, bslot] = bw
            continue
        bv = blk[: d1 - d0]
        bv[:] = 0.0
        bv[br, bslot] = bw
        if storage == "int8":
            # Per-doc scales factor out of the K-sum, so both dot passes
            # stay int8 x int8 -> int32; the residual gets its own scale.
            amax = np.abs(bv).max(axis=1)
            s = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
            q = bv / s[:, None]
            hi = np.clip(np.rint(q), -127, 127)
            resid = (q - hi) * s[:, None]
            rmax = np.abs(resid).max(axis=1)
            s2 = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
            hi_out[d0:d1] = hi
            lo_out[d0:d1] = np.clip(np.rint(resid / s2[:, None]),
                                    -127, 127)
            s_arr[d0:d1] = s
            s2_arr[d0:d1] = s2
        elif storage == "hilo":
            bt = torch.from_numpy(bv)
            hi = bt.to(torch.bfloat16)
            hi_out[d0:d1] = hi
            lo_out[d0:d1] = (bt - hi.to(torch.float32)).to(torch.bfloat16)
        else:  # bf16
            hi_out[d0:d1] = torch.from_numpy(bv).to(torch.bfloat16)

    # Two-level tail: the primary table is sized by the 90th-percentile
    # rare-term count of real docs; outliers spill into an overflow table.
    tail_counts = (valid & ~is_freq).sum(axis=1)
    real_counts = tail_counts[: base.n_docs]
    max_tail = max(int(tail_counts.max()), 1)
    T_A = max(
        _round_up(max(int(np.percentile(real_counts, 90)), 1),
                  tail_pad_multiple),
        tail_pad_multiple,
    )
    if enable_overflow == "auto":
        n_outliers = int((real_counts > T_A).sum())
        enable_overflow = (
            2 * T_A <= max_tail and n_outliers <= max(D_pad // 256, 1)
        )
    if not enable_overflow or T_A >= max_tail:
        T_A = _round_up(max_tail, tail_pad_multiple)

    sel = valid & ~is_freq
    row_idx, _ = np.nonzero(sel)
    col_idx = (np.cumsum(sel, axis=1, dtype=np.int32) - 1)[sel]
    flat_tids = tids[sel]
    flat_w = w[sel]

    in_primary = col_idx < T_A
    tail_ids = np.full((D_pad, T_A), eidx.DOC_PAD, dtype=np.int32)
    tail_w = np.zeros((D_pad, T_A), dtype=np.float32)
    tail_ids[row_idx[in_primary], col_idx[in_primary]] = flat_tids[in_primary]
    tail_w[row_idx[in_primary], col_idx[in_primary]] = flat_w[in_primary]

    over_ids = over_w = over_docs = None
    if not in_primary.all():
        o_rows = row_idx[~in_primary]
        o_cols = col_idx[~in_primary] - T_A
        over_docs_u = np.unique(o_rows)
        n_over = _pow2_bucket(len(over_docs_u), 8)
        T_B = _round_up(max_tail - T_A, tail_pad_multiple)
        over_ids = np.full((n_over, T_B), eidx.DOC_PAD, dtype=np.int32)
        over_w = np.zeros((n_over, T_B), dtype=np.float32)
        over_docs = np.zeros(n_over, dtype=np.int32)
        over_docs[: len(over_docs_u)] = over_docs_u
        row_map = np.searchsorted(over_docs_u, o_rows)
        over_ids[row_map, o_cols] = flat_tids[~in_primary]
        over_w[row_map, o_cols] = flat_w[~in_primary]

    (rare_slot, post_ids, post_w, rare_df,
     tier2) = _build_rare_postings(
        freq_slot, K, V, D_pad, row_idx, flat_tids, flat_w
    )
    rare2_slot, post2_ids, post2_w, rare2_df = (
        tier2 if tier2 is not None else (None, None, None, None))

    def dev(a):
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return to_device(a, device)

    impact_scale = None
    if storage == "int8":
        impact_scale = dev(np.stack([s_arr, s2_arr]))
    impact_primary = dev(hi_out if imp_f32 is None else imp_f32)

    return SplitBM25Index(
        base=base,
        n_frequent=K,
        freq_slot_of_term=freq_slot,
        dense_impact=impact_primary,
        dense_impact_lo=dev(lo_out),
        # 0/1 entries are exact in bf16; shipped as uint8, widened there.
        dense_presence=dev(presence_u8).to(torch.bfloat16),
        tail_term_ids=dev(tail_ids),
        tail_weights=dev(tail_w),
        over_term_ids=dev(over_ids),
        over_weights=dev(over_w),
        over_doc_ids=dev(over_docs),
        rare_slot_of_term=rare_slot,
        post_doc_ids=dev(post_ids),
        post_weights=dev(post_w),
        rare_df=rare_df,
        post_w_positive=bool((flat_w > 0).all()) if len(flat_w) else True,
        impact_scale=impact_scale,
        rare2_slot_of_term=rare2_slot,
        post2_doc_ids=dev(post2_ids),
        post2_weights=dev(post2_w),
        rare2_df=rare2_df,
    )


def _build_rare_postings(freq_slot, K, V, D_pad, row_idx, flat_tids, flat_w):
    """Term-major postings over the rare vocabulary: a padded (R+1, P)
    table keyed by rare slot, docs ascending within a row. When the
    rectangle exceeds ``_POSTINGS_MAX_ENTRIES``, P is capped and the
    over-cap terms move to a tier-2 rectangle (R2+1, P2).

    Returns (rare_slot, post_ids, post_w, rare_df, tier2) with ``tier2``
    None or (rare2_slot, post2_ids, post2_w, rare2_df)."""
    rare_terms = np.where(freq_slot[:V] >= K)[0] if V else np.empty(0, int)
    R = len(rare_terms)
    rare_slot = np.full(max(V, 1), R, dtype=np.int32)
    rare_slot[rare_terms] = np.arange(R, dtype=np.int32)

    if R == 0 or len(flat_tids) == 0:
        post_ids = np.full((R + 1, 8), D_pad, dtype=np.int32)
        post_w = np.zeros((R + 1, 8), dtype=np.float32)
        return (rare_slot, post_ids, post_w,
                np.zeros(R + 1, dtype=np.int64), None)

    def rect(slots, rows, w, n_rows, width):
        """Left-compacted (n_rows+1, width) term-major rectangle."""
        c = (np.bincount(slots, minlength=n_rows) if len(slots)
             else np.zeros(n_rows, dtype=np.int64))
        df = np.append(c, 0).astype(np.int64)  # sentinel row: df 0
        order = np.lexsort((rows, slots))
        st = slots[order]
        starts = np.zeros(n_rows + 1, dtype=np.int64)
        np.cumsum(c, out=starts[1:])
        col = np.arange(len(st)) - starts[st]
        ids = np.full((n_rows + 1, width), D_pad, dtype=np.int32)
        ws = np.zeros((n_rows + 1, width), dtype=np.float32)
        ids[st, col] = rows[order]
        ws[st, col] = w[order]
        return ids, ws, df

    tslot = rare_slot[flat_tids]
    cnt = np.bincount(tslot, minlength=R)
    P = _round_up(max(int(cnt.max()), 1), 8)
    tier2 = None
    keep_slot, keep_rows, keep_w = tslot, row_idx, flat_w
    if (R + 1) * P > _POSTINGS_MAX_ENTRIES:
        width_cap = (_POSTINGS_MAX_ENTRIES // (R + 1)) // 8 * 8
        if width_cap < 16:
            return rare_slot, None, None, None, None
        t2_terms = rare_terms[np.where(cnt > width_cap)[0]]
        R2 = len(t2_terms)
        rare2_slot = np.full(max(V, 1), R2, dtype=np.int32)
        rare2_slot[t2_terms] = np.arange(R2, dtype=np.int32)
        rare_slot[t2_terms] = R           # tier-1 sentinel
        tslot = rare_slot[flat_tids]
        is2 = tslot == R
        t2slot = rare2_slot[flat_tids[is2]]
        P2 = _round_up(max(int(np.bincount(
            t2slot, minlength=max(R2, 1)).max()), 1), 8)
        if (R2 + 1) * P2 > _POSTINGS_MAX_ENTRIES:
            return rare_slot, None, None, None, None
        post2 = rect(t2slot, row_idx[is2], flat_w[is2], R2, P2)
        tier2 = (rare2_slot, *post2)
        keep = ~is2
        keep_slot, keep_rows, keep_w = (
            tslot[keep], row_idx[keep], flat_w[keep])
        cnt = np.bincount(keep_slot, minlength=R) if keep.any() else (
            np.zeros(R, dtype=np.int64))
        P = _round_up(max(int(cnt.max()), 1), 8)

    post_ids, post_w, rare_df = rect(keep_slot, keep_rows, keep_w, R, P)
    return rare_slot, post_ids, post_w, rare_df, tier2


def map_tail_slots(tail_qids: np.ndarray, split: SplitBM25Index) -> np.ndarray:
    """Tail query term ids -> rare postings rows; QUERY_PAD (and any
    non-rare id) maps to the empty sentinel row R."""
    rare_slot = split.rare_slot_of_term
    R = split.post_doc_ids.shape[0] - 1
    tq = np.asarray(tail_qids)
    safe = np.clip(tq, 0, len(rare_slot) - 1)
    return np.where(tq >= 0, np.minimum(rare_slot[safe], R), R).astype(np.int32)


def split_tail_groups(tail_rows, tail_qids, tail_qcnt,
                      split: SplitBM25Index):
    """Partition the (nt, Qt) tail group by postings tier (host-side).

    Group A rows have all rare terms in tier 1; group B rows carry at
    least one tier-2 term and get a (ntB, Q2) tier-2 slot/count grid.
    Returns (A, B): A = (rows, slots1, qcnt); B = None or
    (rows, slots1, qcnt, slots2, qcnt2)."""
    tq = np.asarray(tail_qids)
    tc = np.asarray(tail_qcnt)
    tr = np.asarray(tail_rows)
    s1 = map_tail_slots(tail_qids, split)
    if split.post2_doc_ids is None:
        return (tr, s1, tc), None
    rs2 = split.rare2_slot_of_term
    R = split.post_doc_ids.shape[0] - 1
    R2 = split.post2_doc_ids.shape[0] - 1
    safe = np.clip(tq, 0, len(rs2) - 1)
    s2 = np.where(tq >= 0, np.minimum(rs2[safe], R2), R2).astype(np.int32)
    has2 = (s2 < R2).any(axis=1)
    if not has2.any():
        return (tr, s1, tc), None
    ai = np.nonzero(~has2)[0]
    bi = np.nonzero(has2)[0]

    def take(idx, n_pad, grid, fill):
        out = np.full((n_pad, grid.shape[1]), fill, grid.dtype)
        out[: len(idx)] = grid[idx]
        return out

    ntA = _pow2_bucket(max(len(ai), 1), 16)
    rowsA = np.zeros(ntA, dtype=np.int32)
    rowsA[: len(ai)] = tr[ai]
    A = (rowsA, take(ai, ntA, s1, R),
         take(ai, ntA, tc, 0.0))
    ntB = _pow2_bucket(len(bi), 8)
    rowsB = np.zeros(ntB, dtype=np.int32)
    rowsB[: len(bi)] = tr[bi]
    # Compact group B's tier-2 grid to its real width.
    isb2 = s2[bi] < R2
    Q2 = _pow2_bucket(int(isb2.sum(axis=1).max()), 1)
    s2B = np.full((ntB, Q2), R2, dtype=np.int32)
    c2B = np.zeros((ntB, Q2), dtype=np.float32)
    rr, jj = np.nonzero(isb2)              # row-major: j ascending per row
    first = np.zeros(len(bi) + 1, dtype=np.int64)
    np.cumsum(isb2.sum(axis=1), out=first[1:])
    rank = np.arange(len(rr)) - first[rr]
    s2B[rr, rank] = s2[bi][rr, jj]
    c2B[rr, rank] = tc[bi][rr, jj]
    B = (rowsB, take(bi, ntB, s1, R), take(bi, ntB, tc, 0.0), s2B, c2B)
    return A, B


def _best_cap_split(tot, k: int, row_min: int, min_save: int,
                    min_ratio: float):
    """Light-row mask of the power-of-2 light cap minimizing gathered
    elements ``ntL*(k+c) + ntH*cap_full`` (group sizes pow2-bucketed
    from ``row_min``), or None when the savings miss either floor."""
    nt = len(tot)
    cap_full = k + _pow2_bucket(max(int(tot.max()), 1), 16)
    base_cost = nt * cap_full
    best = None
    c = 16
    while k + 2 * c < cap_full:
        light = tot <= c
        n_light = int(light.sum())
        n_heavy = nt - n_light
        if n_heavy == 0:
            break
        if n_light:
            cost = (_pow2_bucket(n_light, row_min) * (k + c)
                    + _pow2_bucket(n_heavy, row_min) * cap_full)
            if best is None or cost < best[0]:
                best = (cost, light)
        c *= 2
    if (best is None or base_cost - best[0] < min_save
            or base_cost < min_ratio * best[0]):
        return None
    return best[1]


def split_light_heavy(tail_rows, tail_slots, tail_qcnt,
                      split: SplitBM25Index, k: int):
    """Partition a tier-1 tail group by per-row postings total so the
    merge runs a narrow-cap light pass and a wide-cap heavy pass.

    Returns None (keep the single pass) or (light, heavy), each
    (rows, slots, qcnt) padded to a pow2 row count (min 16) with
    all-sentinel pad rows."""
    ts = np.asarray(tail_slots)
    tc = np.asarray(tail_qcnt)
    tr = np.asarray(tail_rows)
    R = split.post_doc_ids.shape[0] - 1
    light = _best_cap_split(split.rare_df[ts].sum(axis=1), k, 16,
                            _LH_MIN_SAVE, _LH_MIN_RATIO)
    if light is None:
        return None
    li = np.nonzero(light)[0]
    hi = np.nonzero(~light)[0]

    def group(idx, minimum):
        n_pad = _pow2_bucket(max(len(idx), 1), minimum)
        rows = np.zeros(n_pad, dtype=np.int32)
        rows[: len(idx)] = tr[idx]
        slots = np.full((n_pad, ts.shape[1]), R, ts.dtype)
        slots[: len(idx)] = ts[idx]
        qcnt = np.zeros((n_pad, tc.shape[1]), tc.dtype)
        qcnt[: len(idx)] = tc[idx]
        return rows, slots, qcnt

    return group(li, 16), group(hi, 16)


def split_light_heavy_b(tailB_rows, tailB_slots, tailB_qcnt,
                        tailB_slots2, tailB_qcnt2,
                        split: SplitBM25Index, k: int):
    """Light/heavy cap split of the tier-2 group (group B), by combined
    tier-1 + tier-2 postings totals. Returns None, or (light, heavy),
    each (rows, slots1, qcnt1, slots2, qcnt2) padded to a pow2 row
    count (min 8)."""
    s1 = np.asarray(tailB_slots)
    s2 = np.asarray(tailB_slots2)
    c1 = np.asarray(tailB_qcnt)
    c2 = np.asarray(tailB_qcnt2)
    tr = np.asarray(tailB_rows)
    tot = (split.rare_df[s1].sum(axis=1)
           + split.rare2_df[s2].sum(axis=1))
    light = _best_cap_split(tot, k, 8, _LHB_MIN_SAVE, _LHB_MIN_RATIO)
    if light is None:
        return None
    li = np.nonzero(light)[0]
    hi = np.nonzero(~light)[0]
    R1 = split.post_doc_ids.shape[0] - 1
    R2 = split.post2_doc_ids.shape[0] - 1

    def group(idx):
        n_pad = _pow2_bucket(max(len(idx), 1), 8)

        def take(grid, fill):
            out = np.full((n_pad, grid.shape[1]), fill, grid.dtype)
            out[: len(idx)] = grid[idx]
            return out

        rows = np.zeros(n_pad, dtype=np.int32)
        rows[: len(idx)] = tr[idx]
        return (rows, take(s1, R1), take(c1, 0.0),
                take(s2, R2), take(c2, 0.0))

    return group(li), group(hi)


def candidate_cap(split: SplitBM25Index, tail_slots: np.ndarray, k: int) -> int:
    """Candidate-set width: k leaders + the batch's max per-row postings
    total, power-of-2 bucketed (sentinel slots carry df 0)."""
    per_row = split.rare_df[np.asarray(tail_slots)].sum(axis=1)
    cap = k + _pow2_bucket(max(int(per_row.max()), 1), 16)
    Qt, P = tail_slots.shape[1], split.post_doc_ids.shape[1]
    return min(cap, k + Qt * P)


def candidate_cap2(split: SplitBM25Index, tail_slots1: np.ndarray,
                   tail_slots2: np.ndarray, k: int) -> int:
    """Candidate-set width for the tier-2 merge pass: k leaders + the
    batch's max per-row postings total across both tiers."""
    d1 = split.rare_df[np.asarray(tail_slots1)].sum(axis=1)
    d2 = split.rare2_df[np.asarray(tail_slots2)].sum(axis=1)
    cap = k + _pow2_bucket(max(int((d1 + d2).max()), 1), 16)
    Qt, P = tail_slots1.shape[1], split.post_doc_ids.shape[1]
    Q2, P2 = tail_slots2.shape[1], split.post2_doc_ids.shape[1]
    return min(cap, k + Qt * P + Q2 * P2)


def build_sharded_postings(split: SplitBM25Index, n_shards: int):
    """Doc-shard the rare postings for the sharded sparse-candidate path:
    entries of the (R+1, P) term-major table fall into doc ranges, so
    shard s keeps its range's entries left-compacted with shard-local
    doc ids (sentinel D_local).

    Returns (post_ids (n_shards, R+1, P_max) int32, post_w (n_shards,
    R+1, P_max) f32, rare_df (n_shards, R+1) int64, the per-shard df
    that sizes the candidate caps), as numpy arrays. Each row keeps its
    ascending id order, so a shard's merge sums in the single-device
    merge's order restricted to its range."""
    return _shard_postings_rect(
        split.post_doc_ids.cpu().numpy(), split.post_weights.cpu().numpy(),
        split.base.term_ids_host.shape[0], n_shards)


def build_sharded_postings2(split: SplitBM25Index, n_shards: int):
    """The tier-2 rectangle of a width-capped index, doc-sharded as
    :func:`build_sharded_postings` does; None when no cap engaged."""
    if split.post2_doc_ids is None:
        return None
    return _shard_postings_rect(
        split.post2_doc_ids.cpu().numpy(), split.post2_weights.cpu().numpy(),
        split.base.term_ids_host.shape[0], n_shards)


def _shard_postings_rect(pid: np.ndarray, pw: np.ndarray, D_pad: int,
                         n_shards: int):
    if D_pad % n_shards:
        raise ValueError(
            f"D_pad {D_pad} must divide the {n_shards}-shard mesh")
    D_local = D_pad // n_shards
    R1 = pid.shape[0]
    # One pass over the table: a row's real ids ascend (the sentinel
    # D_pad fills its tail), so its entries of shard s are one run, and
    # an entry's column in its shard is its column less the count of the
    # row's entries in earlier shards.
    r_idx, c_idx = np.nonzero(pid < D_pad)
    ids = pid[r_idx, c_idx]
    if np.any((np.diff(ids) < 0) & (np.diff(r_idx) == 0)):
        raise ValueError("postings rows must hold ascending doc ids")
    s_idx = ids // D_local
    dfs = np.bincount(s_idx * R1 + r_idx, minlength=n_shards * R1).reshape(
        n_shards, R1).astype(np.int64)
    before = np.cumsum(dfs, axis=0) - dfs      # entries in earlier shards
    P_max = _round_up(max(int(dfs.max(initial=0)), 1), 8)
    out_ids = np.full((n_shards, R1, P_max), D_local, dtype=np.int32)
    out_w = np.zeros((n_shards, R1, P_max), dtype=np.float32)
    col = c_idx - before[s_idx, r_idx]
    out_ids[s_idx, r_idx, col] = ids - s_idx * D_local
    out_w[s_idx, r_idx, col] = pw[r_idx, c_idx]
    return out_ids, out_w, dfs


def sharded_candidate_cap(rare_df_sh: np.ndarray, tail_slots: np.ndarray,
                          k: int, P_shard: int) -> int:
    """Candidate cap of the sharded merge: the worst per-shard, per-row
    postings total (sentinel slots carry df 0), power-of-2 bucketed as
    :func:`candidate_cap` does."""
    ts = np.asarray(tail_slots)
    per_row = rare_df_sh[:, ts].sum(axis=2)  # (n_shards, nt, Qt) -> sum Qt
    cap = k + _pow2_bucket(max(int(per_row.max()), 1), 16)
    return min(cap, k + ts.shape[1] * P_shard)


def sharded_candidate_cap2(rare_df_sh: np.ndarray, rare2_df_sh: np.ndarray,
                           tail_slots1: np.ndarray, tail_slots2: np.ndarray,
                           k: int, P_shard: int, P2_shard: int) -> int:
    """:func:`candidate_cap2` of the sharded merge: k leaders + the worst
    per-shard postings total across both tiers."""
    d1 = rare_df_sh[:, np.asarray(tail_slots1)].sum(axis=2)
    d2 = rare2_df_sh[:, np.asarray(tail_slots2)].sum(axis=2)
    cap = k + _pow2_bucket(max(int((d1 + d2).max()), 1), 16)
    Qt, Q2 = tail_slots1.shape[1], tail_slots2.shape[1]
    return min(cap, k + Qt * P_shard + Q2 * P2_shard)


def _pow2_bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def compact_tail_postings(tail_slots: np.ndarray, tail_qcnt: np.ndarray,
                          R: int):
    """Host-side rank-packing of the (nt, Qt) tail-slot grid: only the
    real postings rows are gathered and scattered into an (nt, r_max, P)
    layout, so the merge runs at k + r_max*P width.

    Returns (packed (3, nr) int32, r_max): rows are flat_slots,
    flat_dest (into the flattened (nt*r_max,) row space) and flat_qcnt
    as integer counts. Pads: slot R, dest nt*r_max (the trash row),
    qcnt 0."""
    ts = np.asarray(tail_slots)
    qc = np.asarray(tail_qcnt)
    nt, Qt = ts.shape
    real = ts < R
    rows, js = np.nonzero(real)            # row-major: j ascending per row
    counts = real.sum(axis=1)
    r_max = _pow2_bucket(max(int(counts.max()) if nt else 1, 1), 1)
    r_max = min(r_max, Qt)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(rows)) - first[rows]
    nr = _pow2_bucket(max(len(rows), 1), 64)
    packed = np.empty((3, nr), np.int32)
    packed[0] = R
    packed[1] = nt * r_max
    packed[2] = 0
    packed[0, :len(rows)] = ts[rows, js]
    packed[1, :len(rows)] = (rows * r_max + rank).astype(np.int32)
    packed[2, :len(rows)] = qc[rows, js].astype(np.int32)
    return packed, int(r_max)


def encode_queries_split(
    query_tokens: list, split: SplitBM25Index,
    tail_pad_multiple: int = 4,
    freq_pad_multiple: int = 8,
):
    """Queries -> (freq slot ids (nq, Qf), freq counts (nq, Qf),
    tail row indices (nt,), tail qids (nt, Qt), tail qcnt (nt, Qt)).

    The frequent side is a compact slot/count list per query (padded
    with the overflow slot K); the tail side covers only queries with
    rare terms, pow2-bucketed, pads pointing at query 0 with QUERY_PAD
    ids.

    One C++ pass makes the padded arrays (lookup, dedup, frequency
    partition, group-by: ``native.VocabEncoder.encode_tokens_split``),
    as in the JAX package. The numpy group-by below is its contract and
    its fallback (no library, or a token the blob cannot carry; counted
    in ``native.fallbacks["encode_split"]``); a batch with no
    in-vocabulary token takes the empty block either way."""
    K = split.n_frequent
    slot_of = split.freq_slot_of_term
    nq = len(query_tokens)

    nenc = eidx.get_native_encoder(split.base)
    if nenc is not None:
        slot_i32 = getattr(split, "_slot_of_i32", None)
        if slot_i32 is None:
            slot_i32 = np.ascontiguousarray(slot_of, dtype=np.int32)
            split._slot_of_i32 = slot_i32
        out = nenc.encode_tokens_split(
            query_tokens, slot_i32, K, eidx.QUERY_PAD, freq_pad_multiple,
            tail_pad_multiple, 16)
        if out is not None:
            return out

    pairs = eidx.query_term_pairs(query_tokens, split.vocab, nenc)
    if pairs is None:
        Qf = _round_up(1, freq_pad_multiple)
        Qt = _round_up(1, tail_pad_multiple)
        nt = _pow2_bucket(1, 16)
        return (np.full((nq, Qf), K, np.int32), np.zeros((nq, Qf), np.float32),
                np.zeros(nt, np.int32),
                np.full((nt, Qt), eidx.QUERY_PAD, np.int32),
                np.zeros((nt, Qt), np.float32))

    native.fallbacks["encode_split"] += 1
    pq, pt, counts = pairs
    slots = slot_of[pt]
    is_freq = slots < K

    fq = pq[is_freq]
    fs = slots[is_freq]
    fc = counts[is_freq]
    if len(fq):
        uniq_q, start = np.unique(fq, return_index=True)
        per = np.diff(np.append(start, len(fq)))
        Qf = _round_up(int(per.max()), freq_pad_multiple)
        col = np.arange(len(fq)) - start[np.searchsorted(uniq_q, fq)]
        fslots = np.full((nq, Qf), K, dtype=np.int32)
        fcnt = np.zeros((nq, Qf), dtype=np.float32)
        fslots[fq, col] = fs
        fcnt[fq, col] = fc
    else:
        Qf = _round_up(1, freq_pad_multiple)
        fslots = np.full((nq, Qf), K, dtype=np.int32)
        fcnt = np.zeros((nq, Qf), dtype=np.float32)

    tq = pq[~is_freq]
    tt = pt[~is_freq]
    tc = counts[~is_freq]
    if len(tq):
        uniq_q, start = np.unique(tq, return_index=True)
        per = np.diff(np.append(start, len(tq)))
        Qt = _round_up(int(per.max()), tail_pad_multiple)
        nt = _pow2_bucket(len(uniq_q), 16)
        row_of = np.searchsorted(uniq_q, tq)
        col = np.arange(len(tq)) - start[row_of]
        trows = np.zeros(nt, dtype=np.int32)
        trows[: len(uniq_q)] = uniq_q
        qids = np.full((nt, Qt), eidx.QUERY_PAD, dtype=np.int32)
        qcnt = np.zeros((nt, Qt), dtype=np.float32)
        qids[row_of, col] = tt
        qcnt[row_of, col] = tc
    else:
        Qt = _round_up(1, tail_pad_multiple)
        nt = _pow2_bucket(1, 16)
        trows = np.zeros(nt, dtype=np.int32)
        qids = np.full((nt, Qt), eidx.QUERY_PAD, dtype=np.int32)
        qcnt = np.zeros((nt, Qt), dtype=np.float32)
    return fslots, fcnt, trows, qids, qcnt


def _q_int8_ok(split: SplitBM25Index, fcnt) -> bool:
    """True when the batch's query counts are exact in int8 (the
    near-universal case); only consulted under int8 storage."""
    if split.impact_scale is None:
        return True
    return float(np.asarray(fcnt).max(initial=0.0)) <= 127.0


# --------------------------------------------------------------------------
# Device side
# --------------------------------------------------------------------------


def _densify_queries(fslots: torch.Tensor, fcnt: torch.Tensor, K: int):
    """Scatter compact (slot, count) lists into dense (nq, K) f32 count
    and presence matrices; pads land in the dropped column K."""
    nq = fslots.shape[0]
    idx = fslots.long()
    qvec = torch.zeros((nq, K + 1), dtype=torch.float32, device=fcnt.device)
    qvec.scatter_(1, idx, fcnt)
    qpres = torch.zeros_like(qvec)
    qpres.scatter_(1, idx, (fcnt > 0).to(torch.float32))
    return qvec[:, :K], qpres[:, :K]


# torch._int_mm on CUDA takes at least 17 rows; short batches are padded.
_INT_MM_MIN_ROWS = 32


def _int8_dot(qi: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(nq, K) int8 x (D, K) int8 -> (nq, D) int32, exact."""
    nq = qi.shape[0]
    if nq < _INT_MM_MIN_ROWS:
        qi = torch.cat([qi, qi.new_zeros((_INT_MM_MIN_ROWS - nq,
                                          qi.shape[1]))])
    return torch._int_mm(qi, mat.t())[:nq]


def _impact_matmul(qvec: torch.Tensor, impact: torch.Tensor,
                   impact_lo: torch.Tensor | None, scale=None,
                   q_int8_ok: bool = True, coarse: bool = False):
    """The frequent-term scoring matmul under any storage mode.

    int8 (``scale`` given): two int8 x int8 -> int32 products (exact),
    combined per doc column as ``fma(hi, scale[0], lo * scale[1])``;
    ``coarse`` drops the lo pass. ``q_int8_ok=False`` (a query count
    above 127) dequantizes the pair and runs one f32 product. hilo, bf16
    and f32: the operands are upcast to f32 (exact) and multiplied in
    f32, as JAX's ``preferred_element_type=f32`` does; TF32 is off.
    Under bf16 storage (hilo and bf16) the counts are first rounded to
    bf16, as the JAX package casts them, so a count above 256 counts as
    its bf16 neighbour (257 -> 256).

    The fused multiply-add is XLA's: it contracts ``a * b + c`` into
    one FMA, so the JAX scores round once where a separate multiply and
    add round twice (1 ulp apart in a quarter of the entries).
    ``addcmul`` computes the FMA on the CPU and on the card alike
    (tests/test_torch_split_retrieve.py and chip_smoke.py pin it
    against an exact float64 evaluation).
    """
    if impact.dtype == torch.int8 and scale is None:
        raise ValueError(
            "int8 impact matrices require their per-doc impact_scale")
    if scale is not None:
        if q_int8_ok:
            qi = qvec.to(torch.int8)
            hi = _int8_dot(qi, impact).to(torch.float32)
            if coarse:
                return hi.mul_(scale[0])
            lo = _int8_dot(qi, impact_lo).to(torch.float32)
            return lo.mul_(scale[1]).addcmul_(hi, scale[0])
        w = torch.addcmul(impact_lo.to(torch.float32) * scale[1][:, None],
                          impact.to(torch.float32), scale[0][:, None])
        return qvec @ w.t()
    if impact.dtype == torch.bfloat16:
        qvec = qvec.to(torch.bfloat16).to(torch.float32)
    scores = qvec @ impact.to(torch.float32).t()
    if impact_lo is not None and impact_lo.shape[1] > 0:
        scores = scores + qvec @ impact_lo.to(torch.float32).t()
    return scores


def _compare_table(table_ids: torch.Tensor, table_w: torch.Tensor,
                   tail_qids: torch.Tensor, tail_qcnt: torch.Tensor):
    """Compare a (rows, T) table against the tail query group ->
    (nt, rows) partial scores + tf counts: K5 (``cuda_bm25.compare``),
    query slots accumulated in ascending order as fused multiply-adds,
    as XLA evaluates the JAX package's loop."""
    return cuda_bm25.compare(table_ids, table_w,
                             tail_qids.to(torch.int32).contiguous(),
                             tail_qcnt.to(torch.float32).contiguous())


def _overflow_of(split: SplitBM25Index):
    """(ids, weights, doc_ids) of the overflow table, or None."""
    if split.over_term_ids is None:
        return None
    return (split.over_term_ids, split.over_weights, split.over_doc_ids)


def _split_scores(dense_impact, dense_presence, tail_ids, tail_w, fslots,
                  fcnt, tail_rows, tail_qids, tail_qcnt, overflow=None,
                  impact_lo=None, impact_scale=None, q_int8_ok=True):
    """(nq, D_pad) scores and tf counts: the frequent matmul plus the
    compare tail for the queries with rare terms, scattered back by row,
    and the overflow table's compare scattered to its docs."""
    qvec, qpres = _densify_queries(fslots, fcnt, dense_impact.shape[1])
    scores = _impact_matmul(qvec, dense_impact, impact_lo,
                            scale=impact_scale, q_int8_ok=q_int8_ok)
    # Presence entries are 0/1: the f32 product is exact in any order.
    tfs = qpres @ dense_presence.to(torch.float32).t()

    rows = tail_rows.long()
    t_scores, t_tfs = _compare_table(tail_ids, tail_w, tail_qids, tail_qcnt)
    # Pad rows target query 0 with zero contributions.
    scores.index_add_(0, rows, t_scores)
    tfs.index_add_(0, rows, t_tfs)

    if overflow is not None:
        o_ids, o_w, o_docs = overflow
        o_scores, o_tfs = _compare_table(o_ids, o_w, tail_qids, tail_qcnt)
        idx = (rows[:, None], o_docs.long()[None, :])
        scores.index_put_(idx, o_scores, accumulate=True)
        tfs.index_put_(idx, o_tfs, accumulate=True)
    return scores, tfs


def score_all_split(split: SplitBM25Index, fslots, fcnt, tail_rows,
                    tail_qids, tail_qcnt):
    """(nq, D_pad) scores and unique-overlap tf counts: the frequent
    matmul plus the doc-major compare tail (and the overflow table) for
    the queries with rare terms. Takes the host arrays of
    :func:`encode_queries_split`."""
    dev = split.device
    q_int8_ok = _q_int8_ok(split, fcnt)
    enc = [to_device(a, dev) for a in (fslots, fcnt, tail_rows, tail_qids,
                                       tail_qcnt)]
    return _split_scores(
        split.dense_impact, split.dense_presence, split.tail_term_ids,
        split.tail_weights, *enc, overflow=_overflow_of(split),
        impact_lo=split.dense_impact_lo, impact_scale=split.impact_scale,
        q_int8_ok=q_int8_ok)


def probabilities_all_split(
    dense_impact, dense_presence, tail_ids, tail_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_qids, tail_qcnt,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    overflow=None, impact_lo=None, impact_scale=None,
    q_int8_ok: bool = True, prob_dtype: torch.dtype = torch.float32,
):
    """Dense calibrated probabilities (nq, n_docs) via the split path,
    float32 (the transform runs in ``prob_dtype``); 0 where score <= 0."""
    scores, tfs = _split_scores(
        dense_impact, dense_presence, tail_ids, tail_w, fslots, fcnt,
        tail_rows, tail_qids, tail_qcnt, overflow=overflow,
        impact_lo=impact_lo, impact_scale=impact_scale, q_int8_ok=q_int8_ok)
    scores = scores[:, :n_docs]
    tfs = tfs[:, :n_docs]
    dlr = T.true_div(doc_lengths[:n_docs], float(avgdl))[None, :]
    probs = T.score_to_probability(scores, tfs, dlr, alpha, beta, base_rate,
                                   prior_free=prior_free, dtype=prob_dtype)
    return torch.where(scores > 0, probs.to(torch.float32), 0.0)


def retrieve_topk_split(
    dense_impact, dense_presence, tail_ids, tail_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_qids, tail_qcnt, k: int,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    approx: bool = False, overflow=None, doc_mask=None, impact_lo=None,
    impact_scale=None, q_int8_ok: bool = True,
    prob_dtype: torch.dtype = torch.float32,
):
    """Split scoring with the dense compare tail -> exact top-k ->
    Bayesian transform: the path of an index whose rare postings exceed
    their budget.

    Without an overflow table (the lean path), tf is rebuilt only at the
    k winners: presence at the query's frequent slots plus an equality
    count of the winner's tail row against the query's tail ids (exact
    integers, bit-equal to the dense tf). With one, the dense tf matrix
    is computed and gathered. ``approx`` selects exactly (module
    docstring). Returns (ids int32, probs, scores, tfs), each (nq, k);
    unfilled slots are id -1 / probability 0.
    """
    del approx
    K = dense_impact.shape[1]
    lean = overflow is None
    with spans.span("score"):
        if lean:
            qvec, _ = _densify_queries(fslots, fcnt, K)
            scores = _impact_matmul(qvec, dense_impact, impact_lo,
                                    scale=impact_scale, q_int8_ok=q_int8_ok)
            del qvec
            t_scores, _ = _compare_table(tail_ids, tail_w, tail_qids,
                                         tail_qcnt)
            scores.index_add_(0, tail_rows.long(), t_scores)
        else:
            scores, tfs = _split_scores(
                dense_impact, dense_presence, tail_ids, tail_w, fslots,
                fcnt, tail_rows, tail_qids, tail_qcnt, overflow=overflow,
                impact_lo=impact_lo, impact_scale=impact_scale,
                q_int8_ok=q_int8_ok)
        D_pad = scores.shape[1]
        if doc_mask is not None:
            mask_pad = torch.cat([
                doc_mask[:n_docs],
                torch.ones(D_pad - n_docs, dtype=torch.bool,
                           device=doc_mask.device)])
            scores = torch.where(mask_pad[None, :], scores, float("-inf"))
    with spans.span("leader_selection"):
        top_scores, top_ids = exact_topk_blockwise(scores, k, block=256,
                                                   valid_upto=n_docs)
    del scores
    with spans.span("tf_transform"):
        dead = ~torch.isfinite(top_scores)
        top_scores = torch.where(dead, 0.0, top_scores)
        top_ids = torch.where(dead, -1, top_ids)
        safe_ids = top_ids.clamp(min=0)
        if lean:
            top_tfs = (_winner_tf_freq(dense_presence, fslots, fcnt,
                                       safe_ids)
                       + _winner_tf_tail(tail_ids, tail_rows, tail_qids,
                                         safe_ids))
        else:
            top_tfs = torch.gather(tfs, 1, safe_ids)
        top_dlr = T.true_div(doc_lengths[safe_ids], float(avgdl))
        probs = T.score_to_probability(
            top_scores, top_tfs, top_dlr, alpha, beta, base_rate,
            prior_free=prior_free, dtype=prob_dtype)
        probs = torch.where(top_scores > 0, probs.to(torch.float32), 0.0)
        return top_ids.to(torch.int32), probs, top_scores, top_tfs


def _winner_tf_freq(dense_presence, fslots, fcnt, safe_ids):
    """Frequent-side tf at the (nq, k) winners: presence at each query's
    frequent slots, summed (exact integers in f32, any order): the JAX
    package's presence-row dot restricted to the query's nonzeros."""
    K = dense_presence.shape[1]
    fs = fslots.long()
    live = (fcnt > 0) & (fs < K)
    pres = dense_presence[safe_ids[:, :, None],
                          fs.clamp(max=K - 1)[:, None, :]]  # (nq, k, Qf)
    return torch.where(live[:, None, :], pres.to(torch.float32),
                       0.0).sum(dim=2)


def _winner_tf_tail(tail_ids, tail_rows, tail_qids, safe_ids):
    """Tail-side tf at the (nq, k) winners: |winner's rare ids ∩ query's
    rare ids|. Pad tail rows (QUERY_PAD in column 0) go to a trash row
    so they cannot clobber query 0's ids."""
    nq = safe_ids.shape[0]
    Qt = tail_qids.shape[1]
    safe_rows = torch.where(tail_qids[:, 0] < 0, nq, tail_rows.long())
    qt_full = torch.full((nq + 1, Qt), eidx.QUERY_PAD,
                         dtype=tail_qids.dtype, device=tail_qids.device)
    qt_full[safe_rows] = tail_qids
    w_tail = tail_ids[safe_ids]                          # (nq, k, T_A)
    return (w_tail[:, :, :, None] == qt_full[:nq, None, None, :]
            ).sum(dim=(2, 3), dtype=torch.float32)


def exact_topk_blockwise(scores: torch.Tensor, k: int, block: int = 128,
                         valid_upto: int | None = None):
    """Exact top-k over the document axis in ``lax.top_k``'s order
    (ties lowest id first): K1 block maxima, the top-k blocks by K3,
    and a final K3 top-k over those blocks' k*block values.

    Exactness: every top-k doc lies in a top-k block (equal maxima rank
    lower block ids first, whose docs have lower ids); the selected
    blocks are re-sorted ascending, so candidates are id-ascending and
    K3's lowest-index tie order is the dense scan's. ``valid_upto``
    masks columns >= valid_upto; it needs D % block == 0.
    """
    nq, D = scores.shape
    G = -(-D // block)
    if k >= G:  # few blocks: the prefilter would keep everything
        if valid_upto is not None and valid_upto < D:
            v, p = cuda_topk.topk(scores[:, :valid_upto].contiguous(), k)
        else:
            v, p = cuda_topk.topk(scores, k)
        return v, p.long()
    if valid_upto is not None:
        if D % block:
            raise ValueError("valid_upto requires D % block == 0")
        tiles = scores.reshape(nq, G, block)
        bmax = cuda_reduce.block_max(scores, block, valid_upto=valid_upto)
    else:
        pad = G * block - D
        padded = (torch.nn.functional.pad(scores, (0, pad),
                                          value=float("-inf"))
                  if pad else scores)
        tiles = padded.reshape(nq, G, block)
        bmax = cuda_reduce.block_max(padded, block)
    return _topk_from_bmax(tiles, bmax, k, block, valid_upto)


def _topk_from_bmax(tiles: torch.Tensor, bmax: torch.Tensor, k: int,
                    block: int, valid_upto):
    """Pick the top-k blocks by their maxima, gather those blocks'
    values, re-mask pad columns and run the final exact top-k."""
    nq = tiles.shape[0]
    _, bids = cuda_topk.topk(bmax, k)             # ties -> lower block id
    bids = torch.sort(bids.long(), dim=1).values  # id-ascending candidates
    rows = torch.arange(nq, device=tiles.device)[:, None]
    cand = tiles[rows, bids].reshape(nq, k * block)
    cand_ids = (bids[:, :, None] * block
                + torch.arange(block, device=tiles.device)[None, None, :]
                ).reshape(nq, k * block)
    if valid_upto is not None:
        cand = torch.where(cand_ids < valid_upto, cand, float("-inf"))
    v, p = cuda_topk.topk(cand, k)
    return v, torch.gather(cand_ids, 1, p.long())


def _sparse_merge(scores, topm_scores, topm_ids, post_ids, post_w,
                  tail_rows, tail_slots, tail_qcnt, k: int, cand_cap: int,
                  n_docs: int, tf_from_sign: bool = False, compact=None,
                  postings2=None, pad_row_mask=None, base_tail_tf=None):
    """Rare-postings candidate merge: fold each tail query's rare-term
    postings into its k matmul leaders and return the merged
    (ids, scores, tail_tf) per query row.

    ``compact`` = (packed, r_max) from :func:`compact_tail_postings`
    switches to the rank-packed build; ``postings2`` =
    (post2_ids, post2_w, tail_slots2, tail_qcnt2) appends tier-2
    postings; ``pad_row_mask`` overrides the all-sentinel pad-row test;
    ``base_tail_tf`` carries a previous pass's tail tf. Ids are int64.
    """
    nq = topm_ids.shape[0]
    nt = tail_slots.shape[0]
    D_pad = scores.shape[1]
    R = post_ids.shape[0] - 1
    dev = scores.device

    if compact is not None:
        packed, r_max = compact
        flat_slots = packed[0].long()
        flat_dest = packed[1].long()
        flat_qcnt = packed[2].to(torch.float32)
        P = post_ids.shape[1]
        g_ids = post_ids[flat_slots]                      # (nr, P)
        g_v = flat_qcnt[:, None] * post_w[flat_slots]
        # Pads target the trash row nt * r_max, dropped below.
        pid = torch.full((nt * r_max + 1, P), D_pad, dtype=post_ids.dtype,
                         device=dev)
        pid[flat_dest] = g_ids
        pid = pid[:nt * r_max].reshape(nt, r_max, P)
        v = torch.zeros((nt * r_max + 1, P), dtype=torch.float32,
                        device=dev)
        v[flat_dest] = g_v
        v = v[:nt * r_max].reshape(nt, r_max, P)
    else:
        slots = tail_slots.long()
        pid = post_ids[slots]
        # qcnt * w: the compare kernel's product, so sums can be bit-equal
        v = tail_qcnt[:, :, None] * post_w[slots]
    pvalid = pid < n_docs  # sentinel rows/slots carry id D_pad, weight 0
    width = pid.shape[1]   # Qt (dense) or r_max (packed)

    pid2 = None
    if postings2 is not None:
        post2_ids, post2_w, tail_slots2, tail_qcnt2 = postings2
        s2 = tail_slots2.long()
        pid2 = post2_ids[s2]                               # (nt, Q2, P2)
        v2 = tail_qcnt2[:, :, None] * post2_w[s2]
        width = width + pid2.shape[1]

    C = k + pid.shape[1] * pid.shape[2] + (
        0 if pid2 is None else pid2.shape[1] * pid2.shape[2])
    cand_cap = min(max(cand_cap, k), C)
    trows = tail_rows.long()
    parts_i = [topm_ids[trows], pid.reshape(nt, -1).long()]
    parts_v = [torch.zeros((nt, k), dtype=torch.float32, device=dev),
               v.reshape(nt, -1)]
    if pid2 is not None:
        parts_i.append(pid2.reshape(nt, -1).long())
        parts_v.append(v2.reshape(nt, -1))
    cand_ids = torch.cat(parts_i, dim=1)
    cand_v = torch.cat(parts_v, dim=1)

    # Group duplicate docs: sort by the unique int64 key id * W + column,
    # which reproduces a stable id sort (leaders before postings of the
    # same doc, postings in query-slot order), so the segment sums below
    # add in the compare kernel's order.
    Ctot = cand_ids.shape[1]
    Wkey = 1 << max(Ctot - 1, 1).bit_length()
    shift = Wkey.bit_length() - 1
    col = torch.arange(Ctot, dtype=torch.int64, device=dev)[None, :]
    skey, perm = torch.sort(cand_ids * Wkey + col, dim=1)
    sid = (skey[:, :cand_cap] >> shift)
    perm = perm[:, :cand_cap]
    sv = torch.gather(cand_v, 1, perm)
    if tf_from_sign:
        # every real posting weight is > 0: tf is the sign of v
        stf = (sv > 0).to(torch.float32)
    else:
        parts_tf = [torch.zeros((nt, k), dtype=torch.float32, device=dev),
                    pvalid.to(torch.float32).reshape(nt, -1)]
        if pid2 is not None:
            parts_tf.append((pid2 < n_docs).to(torch.float32).reshape(nt, -1))
        stf = torch.gather(torch.cat(parts_tf, dim=1), 1, perm)

    sbase = cuda_gather.row_gather(scores, sid.to(torch.int32).contiguous(),
                                   tail_rows.to(torch.int32).contiguous())

    # Segment totals via shifted adds: a doc appears at most once per
    # rare query term plus once as a leader. The d-descending loop adds
    # positions in ascending order (the compare kernel's order); masked
    # adds contribute literal 0.0.
    neg = torch.full((nt, 1), -1, dtype=sid.dtype, device=dev)
    tail_tot = torch.zeros_like(sv)
    tf_tot = torch.zeros_like(stf)
    for d in range(min(width, cand_cap - 1), -1, -1):
        if d == 0:
            tail_tot = tail_tot + sv
            tf_tot = tf_tot + stf
            continue
        shift_id = torch.cat([neg.expand(nt, d), sid[:, :-d]], dim=1)
        same = shift_id == sid
        zpad = torch.zeros((nt, d), dtype=torch.float32, device=dev)
        sv_d = torch.cat([zpad, sv[:, :-d]], dim=1)
        stf_d = torch.cat([zpad, stf[:, :-d]], dim=1)
        tail_tot = tail_tot + torch.where(same, sv_d, 0.0)
        tf_tot = tf_tot + torch.where(same, stf_d, 0.0)

    # Each doc's full score lives at its LAST occurrence; everything
    # else (earlier duplicates, invalid slots) drops to -inf.
    nxt = torch.cat([sid[:, 1:], neg], dim=1)
    is_last = (sid != nxt) & (sid < n_docs)
    cand_score = torch.where(is_last, sbase + tail_tot, float("-inf"))

    m_scores, m_pos = cuda_topk.topk(cand_score.contiguous(), k)
    m_pos = m_pos.long()
    m_ids = torch.gather(sid, 1, m_pos)
    m_tf_tail = torch.gather(tf_tot, 1, m_pos)

    # Scatter merged rows back; pad tail rows target a trash row so they
    # cannot clobber query 0 (the only index that may repeat).
    if pad_row_mask is None:
        pad_row_mask = (tail_slots >= R).all(dim=1)
    trow_safe = torch.where(pad_row_mask, nq, trows)
    out_ids = torch.cat([topm_ids, topm_ids.new_zeros((1, k))])
    out_ids[trow_safe] = m_ids
    out_scores = torch.cat([topm_scores, topm_scores.new_zeros((1, k))])
    out_scores[trow_safe] = m_scores
    if base_tail_tf is None:
        base_tail_tf = torch.zeros((nq, k), dtype=torch.float32, device=dev)
    out_tail_tf = torch.cat([base_tail_tf, base_tail_tf.new_zeros((1, k))])
    out_tail_tf[trow_safe] = m_tf_tail
    return out_ids[:nq], out_scores[:nq], out_tail_tf[:nq]


def _count_merge(sp, name: str, rows: int, cand_cap: int, k: int,
                 postings: int) -> None:
    """Count a merge pass in ``spans.counts`` and on its span: its query
    rows as launched and rows times the candidates it keeps, the cap
    clipped as :func:`_sparse_merge` clips it (to k + the pass's
    postings width)."""
    kept = rows * min(max(cand_cap, k), k + postings)
    spans.counts["merge_rows." + name] += rows
    spans.counts["merge_candidates." + name] += kept
    sp.add("rows", rows)
    sp.add("candidates", kept)


def retrieve_topk_split_sparse(
    dense_impact, dense_presence, post_ids, post_w, doc_lengths, avgdl,
    fslots, fcnt, tail_rows, tail_slots, tail_qcnt, k: int, cand_cap: int,
    alpha, beta, base_rate=None, *, n_docs: int, prior_free: bool = False,
    approx: bool = False, doc_mask=None, impact_lo=None,
    tf_from_sign: bool = False, compact=None, compact_rmax: int = 0,
    impact_scale=None, q_int8_ok: bool = True, fused_mm: bool = False,
    post2_ids=None, post2_w=None, tailB_rows=None, tailB_slots=None,
    tailB_qcnt=None, tailB_slots2=None, tailB_qcnt2=None,
    cand_cap2: int = 0, tailH_rows=None, tailH_slots=None, tailH_qcnt=None,
    cand_capH: int = 0, compactH=None, compactH_rmax: int = 0,
    coarse: bool = False, impact_cols=None,
    tailB2_rows=None, tailB2_slots=None, tailB2_qcnt=None,
    tailB2_slots2=None, tailB2_qcnt2=None, cand_cap2H: int = 0,
    prob_dtype: torch.dtype = torch.float32,
):
    """Sparse-candidate exact top-k: one frequent-term matmul, blockwise
    leader selection, then the rare-postings merge (light, heavy,
    tier-2 and heavy tier-2 passes as given), tf at the k winners and
    the Bayesian transform.

    Candidate set per query: the k matmul leaders plus every doc in its
    rare terms' postings; with non-negative contributions the true
    top-k always lies inside it. Arguments mirror the JAX function, as
    tensors on the index's device; the transform runs in
    ``prob_dtype`` and probabilities come back as float32. ``fused_mm``
    takes K4 (scores and block maxima in one pass) where the JAX package
    does: no ``doc_mask``, no ``approx``, counts exact in int8 and not
    ``coarse``; K4 reads ``impact_cols``, the index's column-major copy
    (``SplitBM25Index.impact_columns``). ``approx`` selects exactly
    (module docstring). Returns (ids int32, probs, scores, tfs), each
    (nq, k); unfilled slots are id -1 / probability 0.
    """
    K = dense_impact.shape[1]
    D_pad = dense_impact.shape[0]
    with spans.span("matmul"):
        qvec, _ = _densify_queries(fslots, fcnt, K)
        fused_bmax = None
        if fused_mm and doc_mask is None and not approx and q_int8_ok \
                and not coarse:
            # Imported here: cuda_matmul's plain version imports this
            # module.
            from bayesian_bm25_tpu_torch.engine import cuda_matmul

            if impact_cols is None:
                raise ValueError("fused_mm needs impact_cols, the index's "
                                 "column-major copy (impact_columns())")
            scores, fused_bmax = cuda_matmul.impact_matmul_bmax(
                qvec, *impact_cols, impact_scale, n_docs)
        else:
            scores = _impact_matmul(qvec, dense_impact, impact_lo,
                                    scale=impact_scale, q_int8_ok=q_int8_ok,
                                    coarse=coarse)           # (nq, D_pad)
        del qvec
        if doc_mask is not None:
            # Masked docs drop to -inf before leader selection and the
            # base gather, so they can neither lead nor win through
            # postings.
            mask_pad = torch.cat([
                doc_mask[:n_docs],
                torch.ones(D_pad - n_docs, dtype=torch.bool,
                           device=doc_mask.device)])
            scores = torch.where(mask_pad[None, :], scores, float("-inf"))
    with spans.span("leader_selection"):
        if fused_bmax is not None and k < fused_bmax.shape[1]:
            tiles = scores.reshape(scores.shape[0], -1, 256)
            topm_scores, topm_ids = _topk_from_bmax(
                tiles, fused_bmax, k, 256, n_docs)
        else:
            topm_scores, topm_ids = exact_topk_blockwise(
                scores, k, block=256, valid_upto=n_docs)

    P = post_ids.shape[1]
    with spans.span("merge.tier-1") as sp:
        _count_merge(sp, "tier-1", tail_rows.shape[0], cand_cap, k,
                     (compact_rmax if compact is not None
                      else tail_slots.shape[1]) * P)
        out_ids, out_scores, out_tail_tf = _sparse_merge(
            scores, topm_scores, topm_ids, post_ids, post_w,
            tail_rows, tail_slots, tail_qcnt, k, cand_cap, n_docs,
            tf_from_sign=tf_from_sign,
            compact=None if compact is None else (compact, compact_rmax))

    if tailH_rows is not None:
        # Heavy pass: rows disjoint from the light group, at their cap.
        with spans.span("merge.heavy") as sp:
            _count_merge(sp, "heavy", tailH_rows.shape[0], cand_capH, k,
                         (compactH_rmax if compactH is not None
                          else tailH_slots.shape[1]) * P)
            out_ids, out_scores, out_tail_tf = _sparse_merge(
                scores, out_scores, out_ids, post_ids, post_w,
                tailH_rows, tailH_slots, tailH_qcnt, k, cand_capH, n_docs,
                tf_from_sign=tf_from_sign,
                compact=(None if compactH is None
                         else (compactH, compactH_rmax)),
                base_tail_tf=out_tail_tf)

    for name, rows, s1, c1, s2, c2, cap2 in (
            ("merge.tier-2", tailB_rows, tailB_slots, tailB_qcnt,
             tailB_slots2, tailB_qcnt2, cand_cap2),
            ("merge.tier-2-heavy", tailB2_rows, tailB2_slots, tailB2_qcnt,
             tailB2_slots2, tailB2_qcnt2, cand_cap2H)):
        if rows is None:
            continue
        # Tier-2 pass (then its heavy half): leaders ++ tier-1 ++ tier-2
        # postings in one candidate set; pads have all tier-2 slots at
        # the sentinel R2.
        R2 = post2_ids.shape[0] - 1
        with spans.span(name) as sp:
            _count_merge(sp, name[len("merge."):], rows.shape[0], cap2, k,
                         s1.shape[1] * P + s2.shape[1] * post2_ids.shape[1])
            out_ids, out_scores, out_tail_tf = _sparse_merge(
                scores, out_scores, out_ids, post_ids, post_w,
                rows, s1, c1, k, cap2, n_docs, tf_from_sign=tf_from_sign,
                postings2=(post2_ids, post2_w, s2, c2),
                pad_row_mask=(s2 >= R2).all(dim=1),
                base_tail_tf=out_tail_tf)
    del scores

    with spans.span("tf_transform"):
        dead = ~torch.isfinite(out_scores)
        out_scores = torch.where(dead, 0.0, out_scores)
        out_ids = torch.where(dead, -1, out_ids)
        safe_ids = out_ids.clamp(min=0)

        top_tfs = (_winner_tf_freq(dense_presence, fslots, fcnt, safe_ids)
                   + out_tail_tf)

        top_dlr = T.true_div(doc_lengths[safe_ids], float(avgdl))
        probs = T.score_to_probability(
            out_scores, top_tfs, top_dlr, alpha, beta, base_rate,
            prior_free=prior_free, dtype=prob_dtype)
        probs = torch.where(out_scores > 0, probs.to(torch.float32), 0.0)
        return out_ids.to(torch.int32), probs, out_scores, top_tfs
