"""Analytic per-stage cost model for sharded sparse retrieval, on H100
rates.

Counterpart of ``bayesian_bm25_tpu/parallel/cost_model.py``: the same
public names, the same formulas and the same stages; only the constants
belong to this card. It derives the per-stage costs of
``parallel/sharded.py:sharded_retrieve_topk_split`` from first
principles (operations, device-memory bytes, inter-card bytes) and
stage-rate constants calibrated ONCE against the port's own stage
ablation on one NVIDIA H100 80GB HBM3 at 700.00 W (``chip_smoke.py``
phase 20; ``PERF.md`` records the run), at two reference points on the
unfused int8 path:

  (a) 50k: one batch of 8,192 queries, D_pad 51,200, K 2,048;
  (b) 1M: one chunk of 1,024 queries, D_pad 1,001,472, K 1,024, with
      its light/heavy and tier-2 merge passes.

The matmul, selection, merge and tf + transform rates are calibrated at
(a), the wide-pass gather rate at (b); ``tests/test_torch_cost_model.py``
pins each stage at its calibration point and the model's ratio at the
other. Each work term is linear with one rate a stage, and the card's
stage times are not proportional to those terms across the two points,
so at (b) the model reads, against the measured ``STAGE_MS["1m"]``
(model/measured): matmul 0.62 (the unfused product is bound by its
elementwise epilogue, whose bytes grow with nq x D, not by its
operations, which grow with nq x K x D, and K halves at 1M), selection
1.72 (K1 streams the larger matrix faster than at (a)), the light
tier-1 merge 0.10 and tf + transform 0.16 (launch-bound at small
widths), the wide passes 1.00, the chunk 0.70.

The model answers: given a corpus sharded D/S ways over a mesh of
cards, what does one retrieval batch cost per stage, and where does the
all_gather merge stop paying? Its sharded predictions are a MODEL, not a
measurement: no machine here has timed a mesh of several cards, and
real multi-card numbers must replace them when one does.

Hardware constants (NVIDIA H100 SXM, published data-sheet peaks, the
ones ``chip_smoke.py`` bounds its kernels with):
  bf16 tensor cores   989 TFLOP/s dense (int8: 1,979 TOP/s)
  float32 CUDA cores   67 TFLOP/s (the constructor's default hilo path
                       computes its products as float32 SGEMMs: pass
                       ``peak_flops=PEAK_F32_FLOPS`` for it)
  HBM3 bandwidth       3.35 TB/s
  NVLink 4             900 GB/s bidirectional per card (a spec value,
                       not a measurement; the one card measured has no
                       peer)
"""

from __future__ import annotations

from dataclasses import dataclass

# --- hardware constants (H100 SXM data sheet) --------------------------------
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
HBM_BW = 3.35e12
ICI_BW = 900e9  # NVLink 4, bidirectional per card, bytes/s (spec value)

# Stage times the rates below are calibrated on, in device ms, unfused
# int8: chip_smoke.py phase 20 on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md records the run). "50k": one 8,192-query batch at (a), its
# leader selection with K1's share; "1m": one 1,024-query chunk at (b),
# its merge by pass.
STAGE_MS = {
    "50k": {"matmul": 10.8314, "selection": 0.9954, "k1": 0.5312,
            "merge": 0.9440, "tf_transform": 0.0852},
    "1m": {"matmul": 21.2836, "selection": 1.4164, "merge_tier1": 1.1873,
           "merge_heavy": 0.4775, "merge_tier2": 2.4479,
           "tf_transform": 0.0675},
}
# The shapes of those merges, (tail rows, candidate cap) a pass: at (a)
# the one tier-1 pass; at (b) the light tier-1 pass, then the wide ones:
# the heavy pass, the tier-2 pass and its heavy half.
REF_50K_MERGE = (4096, 266)
REF_1M_TIER1 = (1024, 138)
REF_1M_EXTRA = ((256, 2058), (256, 2058), (128, 8202))

# --- calibrated stage rates (the card's own ablation) ------------------------
# The unfused int8 matmul: two int8 products of (8192, 2048) x (2048,
# 51200) and their elementwise epilogue (two int32 -> float32 casts, the
# scale multiply and addcmul). At int8 peak the products alone take
# 2 * 8192 * 2048 * 51200 * 2 / 1979e12 = 1.74 ms against the measured
# ~10.8 ms: MATMUL_EFF absorbs the epilogue, whose bytes, not operations,
# bound the stage. K4 under split_index.FUSED_MM (products and block
# maxima in one pass, no epilogue matrix) would need its own value.
MATMUL_EFF = (2.0 * 8192 * 2048 * 51200 * 2 / PEAK_INT8_OPS
              / (STAGE_MS["50k"]["matmul"] * 1e-3))
# K1 streams the (nq, D) float32 scores at its rate in the selection at
# (a).
BMAX_BW = 4.0 * 8192 * 51200 / (STAGE_MS["50k"]["k1"] * 1e-3)
# The rest of leader selection (K3 on the leading blocks' tiles, the tile
# gather), as one more pass over the score matrix at an effective rate.
EXTRACT_BW = 4.0 * 8192 * 51200 / ((STAGE_MS["50k"]["selection"]
                                    - STAGE_MS["50k"]["k1"]) * 1e-3)
# The rare-postings merge at (a): tail rows x candidate cap cells.
MERGE_REF_S = STAGE_MS["50k"]["merge"] * 1e-3
MERGE_REF_CELLS = REF_50K_MERGE[0] * REF_50K_MERGE[1]
# Winner tf + transform at nq=8192, k=10 (gathers and elementwise passes).
TF_REF_S = STAGE_MS["50k"]["tf_transform"] * 1e-3
TF_REF_CELLS = 8192 * 10

# Per-candidate merge payload between cards: score f32 + id i32 + tail-tf
# f32 + doc-length f32 (parallel/sharded.py all_gather operands).
MERGE_BYTES_PER_CAND = 16

# Wide merge passes (the light/heavy HEAVY pass, the TIER-2 pass and its
# heavy half): one rate per gathered candidate cell, calibrated at (b) on
# those passes together.
SBASE_GATHER_S_PER_ELEM = (
    (STAGE_MS["1m"]["merge_heavy"] + STAGE_MS["1m"]["merge_tier2"]) * 1e-3
    / sum(rows * cap for rows, cap in REF_1M_EXTRA))


def merge_pass_cost(n_rows: int, cand_cap: int,
                    n_shards: int = 1, k: int = 10) -> float:
    """Seconds for one extra sparse-merge pass (heavy or tier-2) over
    ``n_rows`` tail rows at candidate width ``cand_cap``; per-shard
    postings df (and so the cap beyond the k leaders) shrinks ~1/S on
    a doc-sharded mesh, mirroring sharded_candidate_cap."""
    local_cap = k + max((cand_cap - k) // max(n_shards, 1), 1)
    return n_rows * local_cap * SBASE_GATHER_S_PER_ELEM


@dataclass
class StageCosts:
    """Per-batch stage times (seconds) and merge traffic (bytes)."""

    matmul: float
    selection: float
    merge: float
    tf_transform: float
    all_gather: float
    ici_bytes: int
    n_shards: int
    nq: int = 8192

    @property
    def total(self) -> float:
        return (self.matmul + self.selection + self.merge +
                self.tf_transform + self.all_gather)

    def throughput(self, nq: int) -> float:
        return nq / self.total

    def breakdown(self) -> dict:
        return {
            "matmul_ms": self.matmul * 1e3,
            "selection_ms": self.selection * 1e3,
            "merge_ms": self.merge * 1e3,
            "tf_transform_ms": self.tf_transform * 1e3,
            "all_gather_ms": self.all_gather * 1e3,
            "total_ms": self.total * 1e3,
            "ici_bytes_per_query": self.ici_bytes // max(self.nq, 1),
        }


def retrieval_cost(
    n_docs: int,
    nq: int = 8192,
    K: int = 2048,
    k: int = 10,
    n_shards: int = 1,
    local_k: int | None = None,
    matmul_passes: int = 2,
    tail_row_frac: float = 0.5,
    cand_cap: int = 266,
    peak_flops: float = PEAK_BF16_FLOPS,
    extra_passes: tuple = (),
) -> StageCosts:
    """Model one sparse-retrieval batch on an S-shard 1-D ('d',) mesh.

    Stages mirror sharded_retrieve_topk_split: each shard scores its
    D/S doc slice (matmul), selects local_k leaders (selection), merges
    its rare postings (merge, postings df shrink ~1/S per shard),
    computes winner tf + transform, then all_gathers local_k candidates
    x 16 B/query for the global top-k re-select. ``local_k`` defaults to
    k (exact merge; completeness holds because every shard contributes
    its full local top-k).

    tail_row_frac: fraction of queries with >= 1 rare term (0.5 at the
    50k reference point); cand_cap: host-computed candidate cap there.
    The unfused int8 path is ``matmul_passes=2,
    peak_flops=PEAK_INT8_OPS`` (the rates above are calibrated on it).

    ``extra_passes``: ((n_rows, cand_cap), ...) — the light/heavy HEAVY
    pass and the width-capped TIER-2 pass, costed by
    :func:`merge_pass_cost` (per-shard caps shrink ~1/S like the primary
    merge). E.g. the 1M reference chunk is
    ``extra_passes=REF_1M_EXTRA``.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if local_k is None:
        local_k = k
    if local_k > n_docs // max(n_shards, 1):
        raise ValueError("local_k cannot exceed the per-shard doc count")

    d_local = (n_docs + n_shards - 1) // n_shards

    t_matmul = (2.0 * nq * K * d_local * matmul_passes
                / (peak_flops * MATMUL_EFF))
    # Selection reads the (nq, d_local) f32 score matrix twice: once
    # through K1's block maxima, once for the leading tiles.
    score_bytes = 4.0 * nq * d_local
    t_select = score_bytes / BMAX_BW + score_bytes / EXTRACT_BW
    # Merge work scales with tail rows x candidate width; per-shard
    # postings df (and so the cap beyond the k leaders) shrinks ~1/S.
    local_cap = k + max((cand_cap - k) // n_shards, 1)
    merge_cells = (nq * tail_row_frac) * local_cap
    t_merge = MERGE_REF_S * merge_cells / MERGE_REF_CELLS
    for rows, cap_x in extra_passes:
        t_merge += merge_pass_cost(rows, cap_x, n_shards, k)
    t_tf = TF_REF_S * (nq * local_k) / TF_REF_CELLS

    if n_shards == 1:
        return StageCosts(t_matmul, t_select, t_merge, t_tf, 0.0, 0,
                          n_shards, nq)

    # Ring all_gather of V bytes per shard across S shards moves
    # V * (S-1) bytes through each card's links.
    v_bytes = nq * local_k * MERGE_BYTES_PER_CAND
    t_ag = v_bytes * (n_shards - 1) / ICI_BW
    # Global re-select over (nq, S * local_k) gathered candidates —
    # tiny next to the big matrices; modeled at the extract rate.
    t_reselect = 4.0 * nq * n_shards * local_k / EXTRACT_BW
    return StageCosts(t_matmul, t_select, t_merge, t_tf + t_reselect,
                      t_ag, v_bytes * n_shards, n_shards, nq)


def scaling_table(n_docs: int, shards=(1, 2, 4, 8), **kw) -> list[dict]:
    """Predicted per-shard-count throughput, normalized to 1 shard."""
    base = retrieval_cost(n_docs, n_shards=1, **kw)
    rows = []
    for s in shards:
        c = retrieval_cost(n_docs, n_shards=s, **kw)
        rows.append({
            "n_shards": s,
            "predicted_speedup": base.total / c.total,
            "efficiency": base.total / c.total / s,
            **c.breakdown(),
        })
    return rows


def crossover_shards(n_docs: int, max_shards: int = 64, **kw) -> int:
    """Largest shard count that still improves batch latency — past it
    the all_gather + fixed per-shard costs outgrow the D/S savings."""
    best_s, best_t = 1, retrieval_cost(n_docs, n_shards=1, **kw).total
    s = 2
    while s <= max_shards:
        t = retrieval_cost(n_docs, n_shards=s, **kw).total
        if t < best_t:
            best_s, best_t = s, t
        s *= 2
    return best_s
