"""The comparison that decides ``correct``: a sample of the answers the
timed entry returned, drawn from the seed, against the plain reference.

Numbers, each against the cell's limit (``perfbench/limits/<cell>.json``):
  score_gap    widest shortfall, over sampled rows and ranks, of the
               reference score of the document returned at rank i below
               the reference's i-th best score, as a share of the row's
               best (0 for an exact top-k in order; ties read 0)
  prob_gap     widest |returned probability - reference probability of
               the returned document|, with alpha, beta and the base
               rate worked out by the reference (its ``calibration``)
  bad_ids      ids outside [-1, n_docs) and ids repeated within a row
  rows_missing sampled rows whose answer is absent or misshapen
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import probability

NUMBERS = ("score_gap", "prob_gap", "bad_ids", "rows_missing")


def sample_rows(n_rows: int, want: int, rng) -> np.ndarray:
    """Sorted indices of ``want`` answers among ``n_rows``, drawn from
    the seed (all of them when there are fewer)."""
    if n_rows <= want:
        return np.arange(n_rows)
    return np.sort(rng.choice(n_rows, size=want, replace=False))


def compare(ref, cal, queries: list, got_ids: list, got_probs: list,
            k: int, block: int = 64) -> dict:
    """Numbers for ``queries`` (token-id arrays) against the entry's
    answers (``got_ids[i]``, ``got_probs[i]``: row i's arrays, or None
    where the answer is missing)."""
    alpha, beta, base_rate = cal
    D = ref.n_docs
    k_eff = min(k, D)
    out = dict(score_gap=0.0, prob_gap=0.0, bad_ids=0, rows_missing=0)
    for lo in range(0, len(queries), block):
        qs = queries[lo:lo + block]
        ids = np.full((len(qs), k_eff), -1, dtype=np.int64)
        probs = np.zeros((len(qs), k_eff))
        live = np.zeros(len(qs), dtype=bool)
        for j in range(len(qs)):
            gi, gp = got_ids[lo + j], got_probs[lo + j]
            if (gi is None or gp is None or np.shape(gi) != (k_eff,)
                    or np.shape(gp) != (k_eff,)):
                out["rows_missing"] += 1
                continue
            live[j] = True
            ids[j], probs[j] = gi, gp
        bad = (ids < -1) | (ids >= D)
        srt = np.sort(np.where(bad | (ids < 0), -1, ids), axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        out["bad_ids"] += int(bad[live].sum() + dup[live].sum())
        ids = np.where(bad, -1, ids)

        S = ref.scores(qs)
        best = torch.topk(S, k_eff, dim=1).values.cpu().numpy()
        idt = torch.as_tensor(ids, device=S.device)
        at = torch.gather(S, 1, idt.clamp(min=0)).cpu().numpy()
        at = np.where(ids >= 0, at, 0.0)
        top = best[:, :1]
        gap = np.where(top > 0, np.maximum(best - at, 0.0)
                       / np.where(top > 0, top, 1.0), 0.0)
        tf = ref.tf_at(qs, idt).cpu().numpy()
        dlr = (ref.dl[idt.clamp(min=0)] / ref.avgdl).cpu().numpy()
        p_ref = np.where(ids >= 0, probability(at, tf, dlr, alpha, beta,
                                               base_rate), 0.0)
        if live.any():
            out["score_gap"] = max(out["score_gap"], float(gap[live].max()))
            out["prob_gap"] = max(out["prob_gap"], float(
                np.abs(probs - p_ref)[live].max()))
        del S
    return out


def compared(limits: dict) -> list:
    """The numbers a cell compares: those its limits file names."""
    return [n for n in NUMBERS if n in limits]


def verdict(numbers: dict, limits: dict) -> bool:
    names = compared(limits)
    return bool(names) and all(numbers[n] <= limits[n] for n in names)


def lines(numbers: dict, limits: dict) -> list:
    return [f"check {n} {numbers[n]!r} limit {limits[n]!r}"
            for n in compared(limits)]
