"""Plain reference of what a cell's entry returns: Robertson BM25 (the
classic (k1 + 1) scale) over every document, the exact top-k, and the
Bayesian transform, all in float64, in plain PyTorch on the term ids
the benchmark generated. It imports nothing of the program and takes
nothing the program made: the statistics, alpha, beta and the base rate
are worked out again here, by the same seed-42 pseudo-query protocol
the scorer's ``index()`` documents."""

from __future__ import annotations

import numpy as np
import torch

_CHUNK = 1 << 26   # postings scattered at a time


class Reference:
    def __init__(self, corpus, *, k1: float = 1.2, b: float = 0.75,
                 device="cpu"):
        dev = torch.device(device)
        self.device = dev
        lengths = np.diff(corpus.offsets)
        D = len(lengths)
        self.n_docs = D
        self.k1, self.b = k1, b
        ids = torch.as_tensor(corpus.ids, device=dev).long()
        doc = torch.repeat_interleave(
            torch.arange(D, device=dev), torch.as_tensor(lengths, device=dev))
        key = torch.sort(ids * D + doc).values
        # Where each term first appears in the corpus, read in order.
        self.first = torch.full((int(ids.max()) + 1 if len(ids) else 1,),
                                len(ids), dtype=torch.int64, device=dev
                                ).scatter_reduce_(
            0, ids, torch.arange(len(ids), device=dev), "amin")
        del ids, doc
        # One entry per (term, doc): term-major, docs ascending.
        self.key, tf = torch.unique_consecutive(key, return_counts=True)
        del key
        term = self.key // D
        self.doc = self.key % D
        V = int(term[-1]) + 1 if len(term) else 1
        df = torch.bincount(term, minlength=V)
        self.ptr = torch.zeros(V + 1, dtype=torch.int64, device=dev)
        self.ptr[1:] = torch.cumsum(df, 0)
        dff = df.double()
        self.idf = torch.clamp(torch.log((D - dff + 0.5) / (dff + 0.5)),
                               min=0.0)
        self.dl = torch.as_tensor(lengths, device=dev).double()
        self.avgdl = float(self.dl.mean())
        tff = tf.double()
        norm = 1.0 - b + b * self.dl[self.doc] / self.avgdl
        self.w = self.idf[term] * (k1 + 1.0) * tff / (tff + k1 * norm)
        del term, tf, tff, norm
        self.df_host = df.cpu().numpy()
        self.idf_host = self.idf.cpu().numpy()

    def _pairs(self, queries):
        """(row, term, count) of each query's distinct terms that carry
        weight (in the corpus, idf > 0)."""
        rows, terms, counts = [], [], []
        V = len(self.df_host)
        for r, q in enumerate(queries):
            t, c = np.unique(np.asarray(q, dtype=np.int64), return_counts=True)
            keep = t < V
            t, c = t[keep], c[keep]
            keep = self.idf_host[t] > 0
            rows.append(np.full(int(keep.sum()), r))
            terms.append(t[keep])
            counts.append(c[keep])
        return (np.concatenate(rows or [np.zeros(0, int)]),
                np.concatenate(terms or [np.zeros(0, int)]),
                np.concatenate(counts or [np.zeros(0, int)]))

    def scores(self, queries, w=None) -> torch.Tensor:
        """(nq, n_docs) float64 BM25 scores of token-id queries, from
        each posting's weight ``w`` (default the exact ones)."""
        dev, D = self.device, self.n_docs
        w = self.w if w is None else w
        out = torch.zeros(len(queries) * D, dtype=torch.float64, device=dev)
        rows, terms, counts = self._pairs(queries)
        lens = self.df_host[terms]
        lo = 0
        while lo < len(terms):
            hi, tot = lo, 0
            while hi < len(terms) and (hi == lo or tot + lens[hi] <= _CHUNK):
                tot += int(lens[hi])
                hi += 1
            g_len = torch.as_tensor(lens[lo:hi], device=dev)
            rep = torch.repeat_interleave(
                torch.arange(hi - lo, device=dev), g_len)
            first = torch.cumsum(g_len, 0) - g_len
            start = self.ptr[torch.as_tensor(terms[lo:hi], device=dev)]
            pos = start[rep] + torch.arange(tot, device=dev) - first[rep]
            flat = torch.as_tensor(rows[lo:hi], device=dev)[rep] * D \
                + self.doc[pos]
            cnt = torch.as_tensor(counts[lo:hi], device=dev).double()
            out.index_add_(0, flat, cnt[rep] * w[pos])
            lo = hi
        return out.view(len(queries), D)

    def tf_at(self, queries, ids: torch.Tensor) -> torch.Tensor:
        """(nq, k) count of each query's distinct terms present in the
        document ``ids`` names (-1: 0)."""
        D = self.n_docs
        nq, k = ids.shape
        width = max([len(np.unique(q)) for q in queries] + [1])
        qt = torch.full((nq, width), -1, dtype=torch.int64)
        for r, q in enumerate(queries):
            u = np.unique(np.asarray(q, dtype=np.int64))
            qt[r, :len(u)] = torch.as_tensor(u)
        qt = qt.to(self.device)
        want = qt[:, None, :] * D + ids.long().clamp(min=0)[:, :, None]
        pos = torch.searchsorted(self.key, want).clamp(max=len(self.key) - 1)
        hit = (self.key[pos] == want) & (qt[:, None, :] >= 0) \
            & (ids[:, :, None] >= 0)
        return hit.sum(dim=2).double()

    def int8_pair_scores(self, queries, frequent: int) -> torch.Tensor:
        """(nq, n_docs) scores as an int8 pair stores and sums them, in
        float32: the ``frequent`` terms of highest df (of equal df, the
        one that appears first in the corpus) held as int8 hi and lo,
        rounded half to even, on float32 scales of each document's own
        (s its largest frequent weight over 127, s2 its largest residual
        over 127), summed as whole numbers and combined as
        fma(HI, s, LO * s2); the other terms' float32 weights added to
        that."""
        D = self.n_docs
        df = torch.as_tensor(self.df_host, device=self.device)
        first = self.first[:len(df)]
        rank = (len(df) - df) * (int(first.max()) + 1) + first
        is_f = torch.zeros(len(df), dtype=torch.bool, device=self.device)
        is_f[torch.argsort(rank)[:frequent]] = True
        f = is_f[self.key // D]
        w = self.w.float()
        doc, wf = self.doc[f], w[f]

        def doc_max(v):
            return torch.zeros(D, dtype=torch.float32, device=self.device
                               ).scatter_reduce_(0, doc, v, "amax")

        amax = doc_max(wf)
        s = torch.where(amax > 0, amax / 127.0, 1.0)
        q = wf / s[doc]
        hi = torch.round(q).clamp_(-127, 127)
        resid = (q - hi) * s[doc]
        rmax = doc_max(resid.abs())
        s2 = torch.where(rmax > 0, rmax / 127.0, 1.0)
        lo = torch.round(resid / s2[doc]).clamp_(-127, 127)

        def part(v):
            full = torch.zeros_like(self.w)
            full[f] = v.double()
            return self.scores(queries, full)

        # Whole numbers and float32 products are exact in float64, so
        # each float32 rounding below is the program's one.
        lo_part = (part(lo) * s2.double()).float().double()
        freq = (part(hi) * s.double() + lo_part).float().double()
        rare = self.scores(queries, torch.where(f, 0.0, w.double()))
        return (freq + rare.float().double()).float()

    def calibration(self, corpus, base_rate_auto: bool = True,
                    stored: dict | None = None):
        """alpha, beta and (with ``base_rate="auto"``) the percentile
        base rate from <= 50 documents' first five tokens, sampled with
        ``default_rng(42)``. The percentile counts the scores at or above
        it, so it jumps where scores tie, and a storage that rounds each
        document on a scale of its own unties some of the scores that
        are equal in exact arithmetic. ``stored`` ({"storage": "int8_pair",
        "frequent_terms": K}) makes the base rate's scores the ones that
        storage holds, rounded to float32 as the program's are; alpha
        and beta always come from the exact scores."""
        n = len(corpus)
        pick = np.random.default_rng(42).choice(n, size=min(n, 50),
                                                replace=False)
        qs = [corpus.row(i)[:5] for i in pick if len(corpus.row(i))]
        exact = self.scores(qs).cpu().numpy()
        per = [s[s > 0] for s in exact]
        per = [s for s in per if len(s)]
        pooled = np.concatenate(per)
        beta = float(np.median(pooled))
        std = float(np.std(pooled))
        alpha = 1.0 / std if std > 0 else 1.0
        base_rate = None
        if base_rate_auto:
            if stored is not None:
                if stored["storage"] != "int8_pair":
                    raise ValueError(f"no stored form {stored['storage']!r}")
                held = self.int8_pair_scores(
                    qs, int(stored["frequent_terms"])).double().cpu().numpy()
                per = [h[h > 0] for h in held]
                per = [s for s in per if len(s)]
            ratios = [float(np.sum(s >= np.percentile(s, 95))) / n
                      for s in per]
            base_rate = float(np.clip(np.mean(ratios), 1e-6, 0.5))
        return alpha, beta, base_rate


def probability(score, tf, dl_ratio, alpha, beta, base_rate=None):
    """The Bayesian transform in float64 (numpy arrays): sigmoid
    likelihood, the composite tf / length prior, Bayes' rule, then the
    base rate; 0 where the score is not positive."""
    score = np.asarray(score, dtype=np.float64)
    like = 0.5 * (1.0 + np.tanh(0.5 * alpha * (score - beta)))
    p_tf = 0.2 + 0.7 * np.minimum(np.asarray(tf, np.float64) / 10.0, 1.0)
    p_norm = 0.3 + 0.6 * (1.0 - np.minimum(
        np.abs(np.asarray(dl_ratio, np.float64) - 0.5) * 2.0, 1.0))
    prior = np.clip(0.7 * p_tf + 0.3 * p_norm, 0.1, 0.9)
    eps = 1e-10
    post = np.clip(like * prior / (like * prior + (1 - like) * (1 - prior)),
                   eps, 1 - eps)
    if base_rate is not None:
        post = np.clip(post * base_rate
                       / (post * base_rate + (1 - post) * (1 - base_rate)),
                       eps, 1 - eps)
    return np.where(score > 0, post, 0.0)
