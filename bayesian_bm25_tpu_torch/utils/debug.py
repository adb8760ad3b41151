"""FusionDebugger: white-box tracing of the probability and fusion
pipeline.

Counterpart of ``bayesian_bm25_tpu/utils/debug.py``: the trace
dataclasses (every intermediate: likelihood, priors, logits, the base
rate's share, gating, the fusion aggregates), ``trace_fusion``,
document traces, two-document comparison with the dominant signal and
the crossover, and the text formatters, whose output equals the JAX
package's character for character.

A debugger computes on its transform's device. ``bm25_trace_fields``
computes every field of ``BM25SignalTrace`` for a whole block of
(score, tf, length ratio) in one pass there and copies them to the host
once: ``trace_bm25`` calls it for one score, and the scorer's
``retrieve(explain=True)`` for every (query, rank) of a batch, where
the JAX package makes five scalar transform calls per trace.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bayesian_bm25_tpu_torch.api_fusion import cosine_to_probability, prob_not
from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform, logit, sigmoid)
from bayesian_bm25_tpu_torch.ops import mathx
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.ops.fusion import apply_gating

_F64 = torch.float64
# BM25SignalTrace's per-score fields, in the order bm25_trace_fields
# stacks them (logit_base_rate, one value a transform, goes between
# logit_prior and posterior in the dataclass).
_BM25_FIELDS = ("raw_score", "tf", "doc_len_ratio", "likelihood", "tf_prior",
                "norm_prior", "composite_prior", "logit_likelihood",
                "logit_prior", "posterior")


@dataclass
class BM25SignalTrace:
    """One BM25 score through the full probability pipeline."""

    raw_score: float
    tf: float
    doc_len_ratio: float
    likelihood: float
    tf_prior: float
    norm_prior: float
    composite_prior: float
    logit_likelihood: float
    logit_prior: float
    logit_base_rate: float | None
    posterior: float
    alpha: float
    beta: float
    base_rate: float | None


@dataclass
class VectorSignalTrace:
    """A cosine similarity (or calibrated distance) through conversion."""

    cosine_score: float
    probability: float
    logit_probability: float
    distance: float | None = None
    f_R: float | None = None
    f_G: float | None = None
    log_density_ratio: float | None = None
    calibration_method: str | None = None


@dataclass
class NotTrace:
    """A probabilistic NOT: complement + logit sign flip."""

    input_probability: float
    input_name: str
    complement: float
    logit_input: float
    logit_complement: float


@dataclass
class FusionTrace:
    """The combination step across probability signals."""

    signal_probabilities: list
    signal_names: list
    method: str
    logits: list | None
    mean_logit: float | None
    alpha: float | None
    n_alpha_scale: float | None
    scaled_logit: float | None
    weights: list | None
    fused_probability: float
    gating: str | None = None
    gating_beta: float | None = None
    log_probs: list | None = None
    log_prob_sum: float | None = None
    complements: list | None = None
    log_complements: list | None = None
    log_complement_sum: float | None = None


@dataclass
class DocumentTrace:
    """All signals + fusion for one document."""

    doc_id: object
    signals: dict
    fusion: FusionTrace
    final_probability: float


@dataclass
class ComparisonResult:
    """Two documents compared: per-signal deltas, dominant signal, crossover."""

    doc_a: DocumentTrace
    doc_b: DocumentTrace
    signal_deltas: dict
    dominant_signal: str
    crossover_stage: str | None


def _clamp(p: float) -> float:
    return float(np.clip(p, 1e-10, 1.0 - 1e-10))


def bm25_trace_fields(transform, scores, tfs, doc_len_ratios) -> dict:
    """Every numeric field of ``BM25SignalTrace`` for a block of (score,
    tf, length ratio), by the transform's own float64 pipeline on its
    device, copied to the host in one transfer: numpy arrays of the
    inputs' shape, and ``logit_base_rate`` (a float, or None without a
    base rate)."""
    dev, br = transform.device, transform.base_rate
    s = mathx.as_float(scores, _F64, dev)
    tf = mathx.as_float(tfs, _F64, dev)
    r = mathx.as_float(doc_len_ratios, _F64, dev)
    L = T.likelihood(s, transform.alpha, transform.beta, _F64)
    comp = T.composite_prior(tf, r, _F64)
    cols = torch.stack([s, tf, r, L, T.tf_prior(tf, _F64),
                        T.norm_prior(r, _F64), comp, mathx.logit(L, _F64),
                        mathx.logit(comp, _F64),
                        T.posterior(L, comp, br, _F64)])
    flat = cols.reshape(-1)
    if br is not None:
        flat = torch.cat([flat, mathx.logit(
            torch.full((1,), br, dtype=_F64, device=dev), _F64)])
    host = flat.cpu().numpy()
    out = dict(zip(_BM25_FIELDS, host[:cols.numel()].reshape(cols.shape)))
    out["logit_base_rate"] = None if br is None else float(host[-1])
    return out


def _bm25_trace(transform, v, logit_base_rate) -> BM25SignalTrace:
    """The trace of one entry: ``v`` holds the _BM25_FIELDS values."""
    return BM25SignalTrace(*v[:9], logit_base_rate, v[9], transform.alpha,
                           transform.beta, transform.base_rate)


def bm25_trace_rows(transform, scores, tfs, doc_len_ratios) -> list:
    """``BM25SignalTrace`` for each entry of (nq, k) blocks of (score, tf,
    length ratio), row by row, and None where the score is not positive
    (an empty rank): ``retrieve(explain=True)``'s explanations."""
    fields = bm25_trace_fields(transform, scores, tfs, doc_len_ratios)
    lbr = fields["logit_base_rate"]
    cols = [fields[name].tolist() for name in _BM25_FIELDS]
    return [[_bm25_trace(transform, v, lbr) if v[0] > 0 else None
             for v in zip(*row)] for row in zip(*cols)]


class FusionDebugger:
    """Traces intermediate values through the fusion pipeline, on the
    transform's device."""

    def __init__(self, transform: BayesianProbabilityTransform) -> None:
        self._transform = transform
        self._device = transform.device

    def _logit(self, p):
        return logit(p, self._device)

    # -- signal traces -----------------------------------------------------

    def trace_bm25(self, score: float, tf: float, doc_len_ratio: float
                   ) -> BM25SignalTrace:
        f = bm25_trace_fields(self._transform, score, tf, doc_len_ratio)
        # The inputs are kept as given, as in the JAX package.
        v = [score, tf, doc_len_ratio,
             *(float(f[name]) for name in _BM25_FIELDS[3:])]
        return _bm25_trace(self._transform, v, f["logit_base_rate"])

    def trace_vector(self, cosine_score: float) -> VectorSignalTrace:
        p = float(cosine_to_probability(cosine_score, device=self._device))
        return VectorSignalTrace(
            cosine_score=cosine_score, probability=p,
            logit_probability=float(self._logit(p)),
        )

    def trace_calibrated_vector(
        self, distance: float, probability: float, *,
        f_R: float | None = None, calibration_method: str | None = None,
        calibrator: object | None = None,
    ) -> VectorSignalTrace:
        """Trace a calibrated distance; with a calibrator, also records
        the background density f_G and the log density ratio."""
        f_G = None
        log_ratio = None
        if calibrator is not None:
            mu_G = getattr(calibrator, "mu_G", None)
            sigma_G = getattr(calibrator, "sigma_G", None)
            if mu_G is not None and sigma_G is not None:
                z = (distance - mu_G) / sigma_G
                f_G = float(
                    np.exp(-0.5 * z * z) / (sigma_G * np.sqrt(2 * np.pi))
                )
                if f_R is not None:
                    log_ratio = float(
                        np.log(max(f_R, 1e-10) / max(f_G, 1e-10))
                    )
        return VectorSignalTrace(
            cosine_score=distance, probability=probability,
            logit_probability=float(self._logit(probability)),
            distance=distance, f_R=f_R, f_G=f_G,
            log_density_ratio=log_ratio, calibration_method=calibration_method,
        )

    def trace_not(self, probability: float, *, name: str = "signal") -> NotTrace:
        comp = float(prob_not(probability, device=self._device))
        return NotTrace(
            input_probability=probability, input_name=name, complement=comp,
            logit_input=float(self._logit(probability)),
            logit_complement=float(self._logit(comp)),
        )

    # -- fusion traces -------------------------------------------------------

    def trace_fusion(
        self, probabilities, *, names=None, method: str = "log_odds",
        alpha: float | None = None, weights=None, gating: str | None = None,
        gating_beta: float | None = None,
    ) -> FusionTrace:
        probs = [float(p) for p in probabilities]
        n = len(probs)
        if names is None:
            names = [f"signal_{i}" for i in range(n)]
        if method == "log_odds":
            return self._trace_log_odds(probs, names, alpha, weights,
                                        gating, gating_beta)
        if method == "prob_and":
            return self._trace_product(probs, names, "prob_and")
        if method == "prob_or":
            return self._trace_complement(probs, names, "prob_or")
        if method == "prob_not":
            return self._trace_complement(probs, names, "prob_not")
        raise ValueError(
            f"method must be 'log_odds', 'prob_and', 'prob_or', or"
            f" 'prob_not', got {method!r}"
        )

    def _trace_log_odds(self, probs, names, alpha, weights, gating,
                        gating_beta) -> FusionTrace:
        n = len(probs)
        clamped = [_clamp(p) for p in probs]
        raw = mathx.logit(mathx.as_float(clamped, _F64, self._device), _F64)
        if gating is not None and gating != "none":
            beta = 1.0 if gating_beta is None else gating_beta
            raw = apply_gating(raw, gating, beta)
        gated = raw.cpu().tolist()

        if weights is not None:
            w = np.asarray(weights, dtype=np.float64)
            eff_alpha = 0.0 if alpha is None else alpha
            scale = float(n ** eff_alpha)
            weighted = float(np.sum(w * np.array(gated)))
            scaled = scale * weighted
            return FusionTrace(
                signal_probabilities=clamped, signal_names=names,
                method="log_odds", logits=gated, mean_logit=weighted,
                alpha=eff_alpha, n_alpha_scale=scale, scaled_logit=scaled,
                weights=[float(x) for x in w],
                fused_probability=float(sigmoid(scaled, self._device)),
                gating=gating, gating_beta=gating_beta,
            )

        eff_alpha = 0.5 if alpha is None else alpha
        mean_l = float(np.mean(gated))
        scale = float(n ** eff_alpha)
        scaled = mean_l * scale
        return FusionTrace(
            signal_probabilities=clamped, signal_names=names,
            method="log_odds", logits=gated, mean_logit=mean_l,
            alpha=eff_alpha, n_alpha_scale=scale, scaled_logit=scaled,
            weights=None,
            fused_probability=float(sigmoid(scaled, self._device)),
            gating=gating, gating_beta=gating_beta,
        )

    def _trace_product(self, probs, names, method) -> FusionTrace:
        clamped = [_clamp(p) for p in probs]
        logs = [float(np.log(p)) for p in clamped]
        s = float(np.sum(logs))
        return FusionTrace(
            signal_probabilities=clamped, signal_names=names, method=method,
            logits=None, mean_logit=None, alpha=None, n_alpha_scale=None,
            scaled_logit=None, weights=None,
            fused_probability=float(np.exp(s)),
            log_probs=logs, log_prob_sum=s,
        )

    def _trace_complement(self, probs, names, method) -> FusionTrace:
        """prob_or: 1 - prod(1-p); prob_not: prod(1-p) (none relevant)."""
        clamped = [_clamp(p) for p in probs]
        comps = [float(1.0 - p) for p in clamped]
        logs = [float(np.log(c)) for c in comps]
        s = float(np.sum(logs))
        fused = float(np.exp(s)) if method == "prob_not" else float(1.0 - np.exp(s))
        return FusionTrace(
            signal_probabilities=clamped, signal_names=names, method=method,
            logits=None, mean_logit=None, alpha=None, n_alpha_scale=None,
            scaled_logit=None, weights=None, fused_probability=fused,
            complements=comps, log_complements=logs, log_complement_sum=s,
        )

    # -- document-level --------------------------------------------------------

    def trace_document(
        self, *, bm25_score=None, tf=None, doc_len_ratio=None,
        cosine_score=None, method: str = "log_odds", alpha=None,
        weights=None, doc_id=None,
    ) -> DocumentTrace:
        signals: dict = {}
        probs: list = []
        names: list = []
        if bm25_score is not None:
            if tf is None or doc_len_ratio is None:
                raise ValueError(
                    "tf and doc_len_ratio are required when bm25_score is provided"
                )
            bt = self.trace_bm25(bm25_score, tf, doc_len_ratio)
            signals["BM25"] = bt
            probs.append(bt.posterior)
            names.append("BM25")
        if cosine_score is not None:
            vt = self.trace_vector(cosine_score)
            signals["Vector"] = vt
            probs.append(vt.probability)
            names.append("Vector")
        if not probs:
            raise ValueError(
                "At least one of bm25_score or cosine_score must be provided"
            )
        ft = self.trace_fusion(probs, names=names, method=method,
                               alpha=alpha, weights=weights)
        return DocumentTrace(
            doc_id=doc_id, signals=signals, fusion=ft,
            final_probability=ft.fused_probability,
        )

    def compare(self, trace_a: DocumentTrace, trace_b: DocumentTrace
                ) -> ComparisonResult:
        names = list(dict.fromkeys(
            list(trace_a.signals) + list(trace_b.signals)
        ))
        deltas = {
            n: self._signal_probability(trace_a, n)
            - self._signal_probability(trace_b, n)
            for n in names
        }
        dominant = max(deltas, key=lambda k: abs(deltas[k]))
        fused_delta = trace_a.final_probability - trace_b.final_probability
        crossover = None
        for n, d in deltas.items():
            if n == dominant:
                continue
            if fused_delta != 0.0 and d != 0.0 and (fused_delta > 0) != (d > 0):
                crossover = n
                break
        return ComparisonResult(trace_a, trace_b, deltas, dominant, crossover)

    @staticmethod
    def _signal_probability(trace: DocumentTrace, name: str) -> float:
        sig = trace.signals.get(name)
        if sig is None:
            return 0.5
        if isinstance(sig, BM25SignalTrace):
            return sig.posterior
        if isinstance(sig, VectorSignalTrace):
            return sig.probability
        return 0.5

    # -- formatting ----------------------------------------------------------
    #
    # The text equals the JAX package's character for character (the
    # tests compare them), so traces diff across the two packages.

    @staticmethod
    def _fmt_seq(values, spec=".3f") -> str:
        return "[" + ", ".join(format(v, spec) for v in values) + "]"

    def format_not(self, trace: NotTrace) -> str:
        name, p, q = trace.input_name, trace.input_probability, trace.complement
        header = f"  [NOT {name}]"
        body = (
            (f"P({name}) = {p:.3f}"),
            (f"P(NOT {name}) = 1 - {p:.3f} = {q:.3f}"),
            (f"logit({p:.3f}) = {trace.logit_input:+.3f}"),
            (f"logit({q:.3f}) = {trace.logit_complement:+.3f}  (sign flipped)"),
        )
        return "\n".join([header] + ["    " + line for line in body])

    def _bm25_block(self, name: str, sig: BM25SignalTrace,
                    verbose: bool) -> list[str]:
        pad = " " * 9
        out = [
            f"  [{name}] raw={sig.raw_score:.2f}"
            f" -> likelihood={sig.likelihood:.3f}"
            f" (alpha={sig.alpha:.2f}, beta={sig.beta:.2f})",
            pad + f"tf={sig.tf:.0f} -> tf_prior={sig.tf_prior:.3f}",
            pad + f"dl_ratio={sig.doc_len_ratio:.2f}"
                  f" -> norm_prior={sig.norm_prior:.3f}",
            pad + f"composite_prior={sig.composite_prior:.3f}",
        ]
        if sig.base_rate is None:
            out.append(pad + f"posterior={sig.posterior:.3f}")
        else:
            # Prior-only posterior first, then the base-rate-shifted one,
            # so the base rate's contribution is visible in isolation.
            plain = float(self._transform.posterior(
                sig.likelihood, sig.composite_prior, base_rate=None))
            out.append(pad + f"posterior={plain:.3f}")
            out.append(pad + f"with base_rate={sig.base_rate:.3f}:"
                             f" posterior={sig.posterior:.3f}")
        if verbose:
            out.append(
                pad + f"logit(posterior)={float(self._logit(sig.posterior)):.3f}")
        out.append("")
        return out

    @staticmethod
    def _vector_block(name: str, sig: VectorSignalTrace,
                      verbose: bool) -> list[str]:
        out = [f"  [{name}] cosine={sig.cosine_score:.3f}"
               f" -> prob={sig.probability:.3f}"]
        if verbose:
            out.append(" " * 11 + f"logit(prob)={sig.logit_probability:.3f}")
        out.append("")
        return out

    def _fusion_block(self, f: FusionTrace, verbose: bool) -> list[str]:
        head = f"  [Fusion] method={f.method}"
        if f.alpha is not None:
            head += f", alpha={f.alpha}"
        head += f", n={len(f.signal_probabilities)}"
        if f.gating is not None and f.gating != "none":
            head += f", gating={f.gating}"
            if f.gating_beta is not None and f.gating != "gelu":
                head += f"(beta={f.gating_beta})"
        out = [head]
        if verbose:
            pad = " " * 11
            # Ordered spec: (present?, lines) per intermediate family --
            # log-odds, then prob_and, then prob_or.
            families = (
                (f.logits is not None,
                 lambda: [pad + f"logits={self._fmt_seq(f.logits)}"]),
                (f.mean_logit is not None,
                 lambda: [pad + f"mean_logit={f.mean_logit:.3f}"]),
                (f.n_alpha_scale is not None,
                 lambda: [pad + f"n^alpha={f.n_alpha_scale:.3f},"
                                f" scaled={f.scaled_logit:.3f}"]),
                (f.weights is not None,
                 lambda: [pad + f"weights={self._fmt_seq(f.weights)}"]),
                (f.log_probs is not None,
                 lambda: [pad + f"ln(P)={self._fmt_seq(f.log_probs)}",
                          pad + f"sum(ln(P))={f.log_prob_sum:.3f}"]),
                (f.complements is not None,
                 lambda: [pad + f"1-P={self._fmt_seq(f.complements)}"]),
                (f.log_complements is not None,
                 lambda: [pad + f"ln(1-P)={self._fmt_seq(f.log_complements)}",
                          pad + f"sum(ln(1-P))={f.log_complement_sum:.3f}"]),
            )
            for present, produce in families:
                if present:
                    out.extend(produce())
        out.append(" " * 11 + f"-> final={f.fused_probability:.3f}")
        return out

    def format_trace(self, trace: DocumentTrace, *, verbose: bool = True) -> str:
        label = "unknown" if trace.doc_id is None else trace.doc_id
        lines = [f"Document: {label}"]
        for name, sig in trace.signals.items():
            if isinstance(sig, BM25SignalTrace):
                lines += self._bm25_block(name, sig, verbose)
            elif isinstance(sig, VectorSignalTrace):
                lines += self._vector_block(name, sig, verbose)
        lines += self._fusion_block(trace.fusion, verbose)
        return "\n".join(lines)

    def format_summary(self, trace: DocumentTrace) -> str:
        tags = {BM25SignalTrace: ("BM25", "posterior"),
                VectorSignalTrace: ("Vec", "probability")}
        parts = []
        for sig in trace.signals.values():
            tag = tags.get(type(sig))
            if tag is not None:
                parts.append(f"{tag[0]}={getattr(sig, tag[1]):.3f}")
        f = trace.fusion
        method = f.method if f.alpha is None else f"{f.method}, alpha={f.alpha}"
        label = "unknown" if trace.doc_id is None else trace.doc_id
        return (f"{label}: {' '.join(parts)}"
                f" -> Fused={f.fused_probability:.3f} ({method})")

    def format_comparison(self, comparison: ComparisonResult) -> str:
        a, b = comparison.doc_a, comparison.doc_b
        la = "doc_a" if a.doc_id is None else a.doc_id
        lb = "doc_b" if b.doc_id is None else b.doc_id

        def row(name, pa, pb, delta, note=""):
            return (f"  {name:<12} {pa:>8.3f}  {pb:>8.3f}"
                    f"  {delta:>+8.3f}{note}")

        lines = [
            f"Comparison: {la} vs {lb}",
            f"  {'Signal':<12} {str(la):>8}  {str(lb):>8}"
            f"  {'delta':>8}   dominant",
        ]
        for name, delta in comparison.signal_deltas.items():
            lines.append(row(
                name,
                self._signal_probability(a, name),
                self._signal_probability(b, name),
                delta,
                "   <-- largest" if name == comparison.dominant_signal else "",
            ))
        fused_delta = a.final_probability - b.final_probability
        lines.append(row("Fused", a.final_probability, b.final_probability,
                         fused_delta))
        lines.append("")
        if fused_delta == 0:
            lines.append("  Rank order: tied")
        else:
            hi, lo = (la, lb) if fused_delta > 0 else (lb, la)
            lines.append(
                f"  Rank order: {hi} > {lo} (by +{abs(fused_delta):.3f})")
        dom = comparison.dominant_signal
        dom_delta = comparison.signal_deltas[dom]
        favored = la if dom_delta >= 0 else lb
        lines.append(
            f"  Dominant signal: {dom} ({dom_delta:+.3f} in {favored}'s favor)")
        cross = comparison.crossover_stage
        if cross is not None:
            cf = la if comparison.signal_deltas[cross] >= 0 else lb
            lines.append(
                f"  Note: {cross} favored {cf}, but {dom} signal outweighed it")
        return "\n".join(lines)
