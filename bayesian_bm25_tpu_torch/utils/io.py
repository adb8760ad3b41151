"""Parameter serialization: save/load of fitted models and scorers to
.npz archives.

Counterpart of ``bayesian_bm25_tpu/utils/io.py``, in the JAX package's
archive format: the same keys, the same ``_meta`` tag and
``_FORMAT_VERSION``, and ``load_scorer`` accepts the same older archive
variants (a newline-joined vocabulary, no ``kernel_cfg``, no
``score_scale``, no ``delta``, no ``tok_opts``, no ``deleted_ids``). A
file saved by either package opens in the other. The port's models keep
torch tensors (the fusion weights' parameters and averages, the
isotonic breakpoints); they become float64 numpy arrays in the archive
and tensors on the loader's ``device`` (the card unless the caller
names another). ``load_scorer`` rebuilds the split index from the
archived table on that device. Loading into a sharded scorer (``mesh``,
``n_devices``, ``mesh_shape``) waits for the port of ``parallel/*``.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine.index import BM25Index, to_device
from bayesian_bm25_tpu_torch.models.calibration import (IsotonicCalibrator,
                                                        PlattCalibrator)
from bayesian_bm25_tpu_torch.models.fusion_weights import (
    AttentionLogOddsWeights,
    LearnableLogOddsWeights,
    MultiHeadAttentionLogOddsWeights,
)
from bayesian_bm25_tpu_torch.models.probability import (
    BayesianProbabilityTransform,
    TemporalBayesianTransform,
)
from bayesian_bm25_tpu_torch.ops.mathx import resolve_device
from bayesian_bm25_tpu_torch.utils.convert import array_to_numpy

_FORMAT_VERSION = 1


def _meta(kind: str) -> np.ndarray:
    return np.array([kind, str(_FORMAT_VERSION)])


def _np(x) -> np.ndarray:
    """A model's array (tensor or numpy) as float64 numpy."""
    return np.asarray(array_to_numpy(x), dtype=np.float64)


def _opt_rate(v):
    return np.nan if v is None else v


def save_model(path: str, model) -> None:
    """Serialize a fitted model to an .npz archive (type-tagged)."""
    if isinstance(model, TemporalBayesianTransform):
        np.savez(
            path, _meta=_meta("temporal_transform"),
            alpha=model.alpha, beta=model.beta,
            base_rate=_opt_rate(model.base_rate),
            mode=np.array([model._training_mode]),
            n_updates=model._n_updates,
            grad_alpha_ema=model._grad_alpha_ema,
            grad_beta_ema=model._grad_beta_ema,
            alpha_avg=model._alpha_avg, beta_avg=model._beta_avg,
            decay_half_life=model._decay_half_life,
            timestamp=model._timestamp,
        )
    elif isinstance(model, BayesianProbabilityTransform):
        np.savez(
            path, _meta=_meta("transform"),
            alpha=model.alpha, beta=model.beta,
            base_rate=_opt_rate(model.base_rate),
            mode=np.array([model._training_mode]),
            n_updates=model._n_updates,
            grad_alpha_ema=model._grad_alpha_ema,
            grad_beta_ema=model._grad_beta_ema,
            alpha_avg=model._alpha_avg, beta_avg=model._beta_avg,
        )
    elif isinstance(model, LearnableLogOddsWeights):
        np.savez(
            path, _meta=_meta("learnable_weights"),
            logits=_np(model._logits), alpha=model._alpha,
            base_rate=_opt_rate(model._base_rate),
            n_updates=model._n_updates,
            grad_logits_ema=_np(model._grad_logits_ema),
            weights_avg=_np(model._weights_avg),
        )
    elif isinstance(model, MultiHeadAttentionLogOddsWeights):
        heads = model.heads
        np.savez(
            path, _meta=_meta("multihead_attention"),
            n_heads=model.n_heads,
            n_signals=heads[0].n_signals,
            n_query_features=heads[0].n_query_features,
            alpha=heads[0].alpha,
            normalize=heads[0].normalize,
            W=np.stack([_np(h._W) for h in heads]),
            b=np.stack([_np(h._b) for h in heads]),
            W_avg=np.stack([_np(h._W_avg) for h in heads]),
            b_avg=np.stack([_np(h._b_avg) for h in heads]),
        )
    elif isinstance(model, AttentionLogOddsWeights):
        np.savez(
            path, _meta=_meta("attention_weights"),
            W=_np(model._W), b=_np(model._b), alpha=model._alpha,
            normalize=model._normalize,
            base_rate=_opt_rate(model._base_rate),
            n_updates=model._n_updates,
            grad_W_ema=_np(model._grad_W_ema),
            grad_b_ema=_np(model._grad_b_ema),
            W_avg=_np(model._W_avg), b_avg=_np(model._b_avg),
        )
    elif isinstance(model, PlattCalibrator):
        np.savez(path, _meta=_meta("platt"), a=model.a, b=model.b)
    elif isinstance(model, IsotonicCalibrator):
        if model._x is None:
            raise ValueError("IsotonicCalibrator must be fitted before saving")
        np.savez(path, _meta=_meta("isotonic"), x=_np(model._x),
                 y=_np(model._y))
    else:
        raise TypeError(f"Unsupported model type: {type(model).__name__}")


def save_scorer(path: str, scorer) -> None:
    """Serialize a fitted BayesianBM25Scorer (index, transform and
    configuration) to one compressed .npz archive, in the JAX package's
    format: the vocabulary as an id-ordered UTF-8 blob with byte
    offsets, the doc-major table from the index's host mirrors, the
    transform, the tokenizer options, the kernel configuration and the
    tombstoned ids. The split index is derived state, rebuilt on load;
    the corpus tokens are not kept."""
    idx = scorer.bm25_index
    if idx is None:
        raise ValueError("scorer must be indexed before saving")
    t = scorer.transform
    terms = [None] * idx.n_terms
    for tok, tid in idx.vocab.items():
        terms[tid] = tok
    encoded = [tok.encode("utf-8") for tok in terms]
    vocab_offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=vocab_offsets[1:])

    def table(host, dev, dtype):
        return np.asarray(host if host is not None else array_to_numpy(dev),
                          dtype=dtype)

    np.savez_compressed(
        path, _meta=_meta("scorer"),
        k1=scorer._k1, b=scorer._b, method=np.array([scorer._method]),
        score_scale=np.array([scorer._score_scale]),
        delta=scorer._delta,
        base_rate_method=np.array([scorer._base_rate_method]),
        term_ids=table(idx.term_ids_host, idx.term_ids, np.int32),
        weights=table(idx.weights_host, idx.weights, np.float32),
        doc_lengths=table(idx.doc_lengths_host, idx.doc_lengths, np.float32),
        doc_frequencies=idx.doc_frequencies,
        idf=idx.idf,
        n_docs=idx.n_docs, n_terms=idx.n_terms, avgdl=idx.avgdl,
        max_doc_terms=idx.max_doc_terms,
        vocab_blob=np.frombuffer(b"".join(encoded), dtype=np.uint8),
        vocab_offsets=vocab_offsets,
        alpha=t.alpha, beta=t.beta,
        base_rate=_opt_rate(t.base_rate),
        mode=np.array([t._training_mode]),
        tok_opts=np.array([
            str(scorer._tok_opts.get("lowercase", True)),
            str(scorer._tok_opts.get("remove_stopwords", True)),
            str(scorer._tok_opts.get("stem", True)),
        ]),
        kernel_cfg=np.array([
            scorer._matmul_precision_name,
            scorer._impact_storage or "",
        ]),
        deleted_ids=(np.flatnonzero(scorer._deleted).astype(np.int64)
                     if scorer._deleted is not None
                     else np.zeros(0, np.int64)),
    )


def _decode_tok_opt(v: str):
    if v == "True":
        return True
    if v == "False":
        return False
    return v


def load_scorer(path: str, *, mesh=None, n_devices: int | None = None,
                mesh_shape: tuple[int, int] | None = None, device=None,
                prob_dtype: torch.dtype = torch.float32):
    """Reconstruct a scorer saved by ``save_scorer`` (of either package)
    on ``device``, the card unless the caller names another.
    ``prob_dtype`` is the loaded scorer's, as its constructor takes it.
    ``mesh`` / ``n_devices`` / ``mesh_shape`` load into a
    ``ShardedBayesianBM25Scorer`` (``device`` then places every shard on
    that one device, None a mesh over the cards); the archived doc axis
    is re-padded to the mesh's multiple with the build's pad rows."""
    from bayesian_bm25_tpu_torch.models.scorer import BayesianBM25Scorer

    sharded = (mesh is not None or n_devices is not None
               or mesh_shape is not None)
    if not sharded:
        device = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    if str(data["_meta"][0]) != "scorer":
        raise ValueError("archive is not a scorer checkpoint")
    blob = bytes(np.asarray(data["vocab_blob"]))
    if "vocab_offsets" in data:
        off = np.asarray(data["vocab_offsets"])
        terms = [blob[off[i]:off[i + 1]].decode("utf-8")
                 for i in range(len(off) - 1)]
    else:  # format v1 archives: newline-joined blob
        text = blob.decode("utf-8")
        terms = text.split("\n") if text else []
    vocab = {tok: i for i, tok in enumerate(terms)}

    kernel_kw = {}
    if "kernel_cfg" in data:  # v<=3 archives predate kernel_cfg
        raw = [str(x) for x in np.asarray(data["kernel_cfg"])]
        kernel_kw = dict(matmul_precision=raw[0],
                         impact_storage=raw[1] or None)
    # v<=4 archives predate score_scale (all were classic-scaled).
    scale = (str(data["score_scale"][0]) if "score_scale" in data
             else "classic")
    delta = float(data["delta"]) if "delta" in data else 0.5
    kernel_kw.update(
        k1=float(data["k1"]), b=float(data["b"]),
        method=str(data["method"][0]),
        base_rate_method=str(data["base_rate_method"][0]),
        score_scale=scale, delta=delta, device=device, prob_dtype=prob_dtype)
    if sharded:
        from bayesian_bm25_tpu_torch.parallel.sharded_scorer import (
            ShardedBayesianBM25Scorer)

        scorer = ShardedBayesianBM25Scorer(
            mesh=mesh, n_devices=n_devices, mesh_shape=mesh_shape,
            **kernel_kw)
    else:
        scorer = BayesianBM25Scorer(**kernel_kw)
    # The archive's tables double as the host mirrors, so the split
    # build reads them without a copy back from the device.
    term_ids = np.asarray(data["term_ids"])
    weights = np.asarray(data["weights"])
    doc_lengths = np.asarray(data["doc_lengths"])
    # A sharded scorer's doc axis divides its mesh: re-pad with the
    # build's pad rows (term id -1, weight 0, length max(avgdl, 1)).
    pad_to = scorer._doc_pad_multiple()
    extra = -term_ids.shape[0] % pad_to
    if extra:
        term_ids = np.concatenate(
            [term_ids, np.full((extra, term_ids.shape[1]), -1,
                               term_ids.dtype)])
        weights = np.concatenate(
            [weights, np.zeros((extra, weights.shape[1]), weights.dtype)])
        doc_lengths = np.concatenate(
            [doc_lengths, np.full(extra, max(float(data["avgdl"]), 1.0),
                                  doc_lengths.dtype)])
    dev = scorer._index_device
    scorer._index = BM25Index(
        k1=float(data["k1"]), b=float(data["b"]),
        method=str(data["method"][0]), score_scale=scale, delta=delta,
        vocab=vocab,
        term_ids=to_device(term_ids, dev),
        weights=to_device(weights, dev),
        doc_lengths=to_device(doc_lengths, dev),
        doc_frequencies=np.asarray(data["doc_frequencies"]),
        idf=np.asarray(data["idf"]),
        n_docs=int(data["n_docs"]), n_terms=int(data["n_terms"]),
        avgdl=float(data["avgdl"]),
        max_doc_terms=int(data["max_doc_terms"]),
        term_ids_host=term_ids, weights_host=weights,
        doc_lengths_host=doc_lengths,
    )
    scorer._maybe_build_split()
    scorer._finalize_index()
    br = float(data["base_rate"])
    scorer._transform = BayesianProbabilityTransform(
        alpha=float(data["alpha"]), beta=float(data["beta"]),
        base_rate=None if np.isnan(br) else br, device=scorer.device,
    )
    scorer._transform._training_mode = str(data["mode"][0])
    if "tok_opts" in data:  # v1/v2 archives predate tok_opts; keep defaults
        raw = [str(x) for x in np.asarray(data["tok_opts"])]
        scorer._tok_opts = dict(
            lowercase=_decode_tok_opt(raw[0]),
            remove_stopwords=_decode_tok_opt(raw[1]),
            stem=_decode_tok_opt(raw[2]),
        )
    if "deleted_ids" in data:
        ids = np.asarray(data["deleted_ids"])
        if ids.size:
            scorer.delete_documents(ids)
    return scorer


def load_model(path: str, device=None):
    """Reconstruct a model saved by ``save_model`` (of either package) on
    ``device``, the card unless the caller names another."""
    dev = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    kind = str(data["_meta"][0])

    def _opt(v):
        v = float(v)
        return None if np.isnan(v) else v

    def _t(v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)

    if kind in ("transform", "temporal_transform"):
        base_rate = _opt(data["base_rate"])
        if kind == "temporal_transform":
            model = TemporalBayesianTransform(
                alpha=float(data["alpha"]), beta=float(data["beta"]),
                base_rate=base_rate,
                decay_half_life=float(data["decay_half_life"]), device=dev,
            )
            model._timestamp = int(data["timestamp"])
        else:
            model = BayesianProbabilityTransform(
                alpha=float(data["alpha"]), beta=float(data["beta"]),
                base_rate=base_rate, device=dev,
            )
        model._training_mode = str(data["mode"][0])
        model._n_updates = int(data["n_updates"])
        model._grad_alpha_ema = float(data["grad_alpha_ema"])
        model._grad_beta_ema = float(data["grad_beta_ema"])
        model._alpha_avg = float(data["alpha_avg"])
        model._beta_avg = float(data["beta_avg"])
        return model

    if kind == "learnable_weights":
        logits = np.asarray(data["logits"])
        model = LearnableLogOddsWeights(
            n_signals=len(logits), alpha=float(data["alpha"]),
            base_rate=_opt(data["base_rate"]), device=dev,
        )
        model._logits = _t(logits)
        model._n_updates = int(data["n_updates"])
        model._grad_logits_ema = _t(data["grad_logits_ema"])
        model._weights_avg = _t(data["weights_avg"])
        return model

    if kind == "attention_weights":
        W = np.asarray(data["W"])
        model = AttentionLogOddsWeights(
            n_signals=W.shape[0], n_query_features=W.shape[1],
            alpha=float(data["alpha"]), normalize=bool(data["normalize"]),
            base_rate=_opt(data["base_rate"]), device=dev,
        )
        model._W = _t(W)
        model._b = _t(data["b"])
        model._n_updates = int(data["n_updates"])
        model._grad_W_ema = _t(data["grad_W_ema"])
        model._grad_b_ema = _t(data["grad_b_ema"])
        model._W_avg = _t(data["W_avg"])
        model._b_avg = _t(data["b_avg"])
        return model

    if kind == "multihead_attention":
        model = MultiHeadAttentionLogOddsWeights(
            n_heads=int(data["n_heads"]), n_signals=int(data["n_signals"]),
            n_query_features=int(data["n_query_features"]),
            alpha=float(data["alpha"]), normalize=bool(data["normalize"]),
            device=dev,
        )
        for i, head in enumerate(model.heads):
            head._W = _t(data["W"][i])
            head._b = _t(data["b"][i])
            head._W_avg = _t(data["W_avg"][i])
            head._b_avg = _t(data["b_avg"][i])
        return model

    if kind == "platt":
        return PlattCalibrator(a=float(data["a"]), b=float(data["b"]),
                               device=dev)

    if kind == "isotonic":
        model = IsotonicCalibrator(device=dev)
        model._x = _t(data["x"])
        model._y = _t(data["y"])
        return model

    raise ValueError(f"Unknown model kind: {kind!r}")
