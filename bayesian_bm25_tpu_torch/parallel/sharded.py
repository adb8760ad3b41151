"""Document-sharded scoring, the distributed top-k, and sharded training.

Counterpart of ``bayesian_bm25_tpu/parallel/sharded.py``. The JAX module
runs one program over a ``jax.sharding.Mesh`` under ``shard_map``; here
one process drives a :class:`ShardMesh`, an array of ``torch.device``
with axis names, and launches each shard's work in turn. Launches are
asynchronous, so shards on different cards overlap, and a mesh may hold
several shards on one device (the CPU in the tests, one card in
``chip_smoke.py``). The two collectives are ordered by shard:

  * all_gather (:func:`_all_gather`): the parts concatenated in shard
    order on the first part's device, the merge device;
  * psum (:func:`_psum`): the parts summed in shard order there.

A doc-sharded operand is a list of per-shard tensors, each on its
shard's device (:func:`shard_index_arrays`,
:func:`shard_split_index_arrays`); a whole tensor or numpy array given
instead is cut along the doc axis and placed. Replicated operands (the
query encodings) are copied to each device once. Every kernel of the
single-device path runs per shard: K5 for the compare tables, K4 (with
``fused_mm``) or the library product for the frequent terms, K1 + K3 for
the leader selection, K2 in each merge pass; K3 again merges the
shards' candidates, which arrive shard-major, so equal scores go to the
lowest global id, as on one device. Dense outputs stay doc-sharded: a
list of (nq, D_local) parts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import cuda_matmul, cuda_topk, scoring
from bayesian_bm25_tpu_torch.engine import split_index as sidx
from bayesian_bm25_tpu_torch.engine.index import to_device
from bayesian_bm25_tpu_torch.ops import transform as T
from bayesian_bm25_tpu_torch.ops.mathx import (clamp_probability,
                                               resolve_device, sigmoid)

_F32 = torch.float32
_NEG_INF = float("-inf")


class ShardMesh:
    """The port's mesh: ``devices`` a numpy object array of
    ``torch.device``, one axis per name; ``axis_names`` ``("d",)``
    (document shards) or ``("q", "d")`` (query rows x document shards);
    ``shape`` a dict of axis sizes, so ``mesh.shape["d"]`` reads as on a
    ``jax.sharding.Mesh``. A device may appear more than once."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D devices for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return (f"ShardMesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _cards(n: int) -> list:
    """The first n CUDA devices; raises without CUDA or with fewer."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh over the cards needs CUDA, which is not available; "
            "pass device='cpu' to put the shards on the host")
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(
            f"need {n} devices for the mesh, have {have} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _one_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, *, device=None,
              axis: str = "d") -> ShardMesh:
    """1-D mesh over the document axis. With ``device`` None: the first
    ``n_devices`` cards (default: all of them), raising without CUDA or
    with fewer cards, as the JAX package raises with fewer devices.
    With ``device`` given: ``n_devices`` shards (default 1) on that one
    device."""
    if device is None:
        if n_devices is None:
            _cards(0)
            n_devices = torch.cuda.device_count()
        devs = _cards(n_devices)
    else:
        devs = [_one_device(device)] * (1 if n_devices is None
                                        else n_devices)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    return ShardMesh(devs, (axis,))


def make_mesh_2d(n_query: int, n_doc: int, *, device=None) -> ShardMesh:
    """2-D mesh: query rows ('q', the batch split) x document shards
    ('d'), over the first n_query * n_doc cards or on one ``device``."""
    need = n_query * n_doc
    devs = (_cards(need) if device is None
            else [_one_device(device)] * need)
    return ShardMesh(np.asarray(devs, dtype=object).reshape(n_query, n_doc),
                     ("q", "d"))


def _n(mesh: ShardMesh) -> int:
    return int(mesh.shape["d"])


def _doc_devices(mesh: ShardMesh) -> list:
    """The device of each doc shard (row 0 of a 2-D mesh)."""
    return list(mesh.devices.reshape(-1, _n(mesh))[0])


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x))


def _split_doc(mesh: ShardMesh, x, axis: int = 0) -> list:
    """A doc-sharded operand as per-shard parts on the shard devices: a
    list is taken as placed (a list of rows, too: see :func:`_rows`); a
    tensor or array is cut into equal parts along ``axis``; None gives a
    None per shard."""
    n = _n(mesh)
    if x is None:
        return [None] * n
    if isinstance(x, (list, tuple)):
        if x and isinstance(x[0], (list, tuple)):
            return list(x)
        if len(x) != n:
            raise ValueError(f"{len(x)} parts for a {n}-shard mesh")
        return list(x)
    t = _tensor(x)
    if t.shape[axis] % n:
        raise ValueError(
            f"doc axis {t.shape[axis]} must divide the {n}-shard mesh")
    return [p.to(d).contiguous()
            for p, d in zip(t.chunk(n, dim=axis), _doc_devices(mesh))]


def _split_stack(mesh: ShardMesh, x) -> list:
    """Per-shard tables stacked on axis 0, (n_shards, ...), as parts;
    a list is taken as placed."""
    if x is None or isinstance(x, (list, tuple)):
        return _split_doc(mesh, x)
    t = _tensor(x)
    return [t[s].to(d).contiguous()
            for s, d in enumerate(_doc_devices(mesh))]


def _replicate(x, devices) -> list:
    """A replicated operand on each of ``devices``, copied once per
    distinct device."""
    if x is None:
        return [None] * len(devices)
    placed = {}
    for d in devices:
        if d not in placed:
            placed[d] = (x.to(d) if isinstance(x, torch.Tensor)
                         else to_device(np.asarray(x), d))
    return [placed[d] for d in devices]


def _rows(mesh: ShardMesh, parts: list) -> list:
    """Row r's parts of a doc-sharded operand on a 2-D mesh: shard s on
    ``devices[r, s]``, the row-0 tensor itself where the device is the
    same. Nested lists are taken as placed."""
    if parts and isinstance(parts[0], (list, tuple)):
        return parts
    devs = mesh.devices
    return [[p if p is None or p.device == devs[r, s] else p.to(devs[r, s])
             for s, p in enumerate(parts)]
            for r in range(devs.shape[0])]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _all_gather(parts: list, axis: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the parts concatenated in
    shard order along ``axis`` on the first part's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=axis)


def _psum(parts: list) -> torch.Tensor:
    """``lax.psum``: the parts summed in shard order on the first part's
    device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def _leader_topk(scores: torch.Tensor, k: int):
    """Per-shard exact leader selection: blockwise (K1 + K3) on
    256-aligned local widths, K3 alone otherwise. Both return
    ``lax.top_k``'s values and positions, tie order included; masked
    (-inf) scores pass through. Positions are int64."""
    d_local = scores.shape[1]
    if d_local % 256 == 0 and k < d_local // 256:
        v, p = sidx.exact_topk_blockwise(scores, k, block=256,
                                         valid_upto=d_local)
    else:
        v, p = cuda_topk.topk(scores.contiguous(), k)
    return v, p.long()


def _local_score(term_ids, weights, qids, qcnt):
    """Per-shard doc-major scores and tf counts (K5), the single-device
    compare on the shard's slab."""
    return scoring.score_all(term_ids, weights, qids, qcnt)


def _transform(scores, tfs, dl, avgdl, alpha, beta, base_rate, prior_free,
               prob_dtype):
    """The Bayesian transform of scores with their tf counts and doc
    lengths (same shape); 0 where the score is not positive."""
    probs = T.score_to_probability(
        scores, tfs, T.true_div(dl, float(avgdl)), alpha, beta, base_rate,
        prior_free=prior_free, dtype=prob_dtype)
    return torch.where(scores > 0, probs.to(_F32), 0.0)


def _doc_masks(mesh: ShardMesh, doc_mask, D_pad: int, n_real=None) -> list:
    """Per-shard validity masks over the doc axis, each None (nothing
    masked), an int (the shard's leading valid columns: pads only) or a
    bool tensor on the shard's device. ``n_real`` drops the global pad
    docs; ``doc_mask`` (length num_docs or D_pad) the excluded ones."""
    n = _n(mesh)
    D_local = D_pad // n
    base = np.ones(D_pad, bool)
    if n_real is not None:
        base[n_real:] = False
    if doc_mask is not None:
        m = _host(doc_mask).astype(bool)
        base &= np.concatenate([m[:D_pad],
                                np.ones(max(D_pad - m.shape[0], 0), bool)])
    out = []
    for s, d in enumerate(_doc_devices(mesh)):
        part = base[s * D_local:(s + 1) * D_local]
        if part.all():
            out.append(None)
        elif doc_mask is None:
            out.append(int(part.sum()))        # a suffix of global pads
        else:
            out.append(to_device(part, d))
    return out


def _apply_mask(scores: torch.Tensor, mask) -> torch.Tensor:
    """Masked columns of (nq, D_local) scores to -inf (see _doc_masks)."""
    if mask is None:
        return scores
    if isinstance(mask, int):
        scores[:, mask:] = _NEG_INF
        return scores
    return torch.where(mask[None, :], scores, _NEG_INF)


def _merge(cand, k: int, avgdl, alpha, beta, base_rate, *, n_docs=None,
           n_real=None, dead_rule: bool = True, prior_free: bool = False,
           prob_dtype=_F32):
    """The cross-shard merge on the merge device: gather each shard's
    (score, global id, tf, dl) candidates, take the top-k with K3 (the
    lowest position, so the lowest global id, wins a tie), apply the dead
    rule (non-finite scores and, with ``n_real``, ids outside
    [0, n_real) -> id -1, score 0) and the transform. ``n_docs`` masks
    candidates at or past it to -inf first. Returns (ids int32, probs,
    scores, tfs)."""
    cand_s, cand_id, cand_tf, cand_dl = (_all_gather(p, 1) for p in cand)
    if n_docs is not None:
        cand_s = torch.where(cand_id < n_docs, cand_s, _NEG_INF)
    merge_s, pos = cuda_topk.topk(cand_s.contiguous(),
                                  min(k, cand_s.shape[1]))
    pos = pos.long()
    ids = torch.gather(cand_id, 1, pos)
    tfs = torch.gather(cand_tf, 1, pos)
    dl = torch.gather(cand_dl, 1, pos)
    if dead_rule:
        dead = ~torch.isfinite(merge_s)
        if n_real is not None:
            dead = dead | (ids >= n_real) | (ids < 0)
        merge_s = torch.where(dead, 0.0, merge_s)
        ids = torch.where(dead, -1, ids)
    probs = _transform(merge_s, tfs, dl, avgdl, alpha, beta, base_rate,
                       prior_free, prob_dtype)
    return ids.to(torch.int32), probs, merge_s, tfs


def _densified(fslots, fcnt, K: int, devices) -> list:
    """(fslots, fcnt, qvec, qpres) of the replicated frequent-term
    encoding on each device, placed and densified once per distinct
    device."""
    fs, fc = _replicate(fslots, devices), _replicate(fcnt, devices)
    done = {}
    for d, a, b in zip(devices, fs, fc):
        if d not in done:
            done[d] = (a, b, *sidx._densify_queries(a, b, K))
    return [done[d] for d in devices]


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def shard_index_arrays(mesh: ShardMesh, term_ids, weights, doc_lengths):
    """The doc-major index arrays as per-shard parts over the mesh."""
    return tuple(_split_doc(mesh, a) for a in (term_ids, weights,
                                               doc_lengths))


def shard_split_index_arrays(mesh: ShardMesh, split):
    """A SplitBM25Index's (dense_impact, dense_presence, tail_term_ids,
    tail_weights) as per-shard parts over the mesh."""
    return tuple(_split_doc(mesh, a) for a in (
        split.dense_impact, split.dense_presence, split.tail_term_ids,
        split.tail_weights))


def _scale_operand(mesh: ShardMesh, impact_scale) -> list:
    """Per-shard parts of the (2, D_pad) int8 dequantization scales, cut
    along the doc axis (axis 1), or a None per shard."""
    return _split_doc(mesh, impact_scale, axis=1)


def _int8_ok(impact_scale, fcnt) -> bool:
    """Host-side: the batch's query counts fit int8 (the near-universal
    case). Only consulted under int8 storage; False routes the shards to
    the dequantizing float32 product."""
    if impact_scale is None or (isinstance(impact_scale, list)
                                and impact_scale[0] is None):
        return True
    return float(_host(fcnt).max(initial=0.0)) <= 127.0


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------


def sharded_retrieve_topk(mesh: ShardMesh, term_ids, weights, doc_lengths,
                          avgdl, qids, qcnt, k: int, alpha, beta,
                          base_rate=None, n_docs: int | None = None,
                          prior_free: bool = False, return_tfs: bool = False,
                          doc_mask=None, prob_dtype: torch.dtype = _F32):
    """Distributed top-k over the doc-major table: per shard, the compare
    (K5), the ``doc_mask`` to -inf and the local top-k with global ids;
    then the merge. ``n_docs`` masks pad rows out of the merge (each
    shard still offers min(k, D_local) candidates, so the true top-k is
    covered). Returns (ids, probs, scores) on the merge device, and the
    tf counts with ``return_tfs``."""
    tids, w, dl = shard_index_arrays(mesh, term_ids, weights, doc_lengths)
    devs = _doc_devices(mesh)
    D_local = tids[0].shape[0]
    masks = _doc_masks(mesh, doc_mask, D_local * _n(mesh))
    qi, qc = _replicate(qids, devs), _replicate(qcnt, devs)
    lk = min(k, D_local)
    cand = ([], [], [], [])
    for s in range(_n(mesh)):
        scores, tfs = _local_score(tids[s], w[s], qi[s], qc[s])
        scores = _apply_mask(scores, masks[s])
        top_s, top_local = _leader_topk(scores, lk)
        for lst, v in zip(cand, (top_s, top_local + s * D_local,
                                 torch.gather(tfs, 1, top_local),
                                 dl[s][top_local])):
            lst.append(v)
    out = _merge(cand, k, avgdl, alpha, beta, base_rate, n_docs=n_docs,
                 prior_free=prior_free, prob_dtype=prob_dtype)
    return out if return_tfs else out[:3]


def sharded_retrieve_topk_2d(mesh: ShardMesh, term_ids, weights,
                             doc_lengths, avgdl, qids, qcnt, k: int, alpha,
                             beta, base_rate=None,
                             prob_dtype: torch.dtype = _F32):
    """Top-k on a (query x document) 2-D mesh: query row r of the mesh
    serves its slice of the batch against every doc shard; candidates
    merge over 'd' only, on ``devices[r, 0]``. As in the JAX package,
    this doc-major form has no pad or dead-slot rule. Returns (ids,
    probs, scores), the rows concatenated on the first device."""
    rows = [_rows(mesh, p) for p in shard_index_arrays(
        mesh, term_ids, weights, doc_lengths)]
    return _by_query_row(mesh, qids.shape[0], lambda r, q0, q1: _merge(
        _candidates_2d(mesh, r, rows, *(
            _replicate(_tensor(x)[q0:q1], list(mesh.devices[r]))
            for x in (qids, qcnt)), k), k, avgdl, alpha, beta, base_rate,
        dead_rule=False, prob_dtype=prob_dtype))[:3]


def _candidates_2d(mesh, r, rows, qi, qc, k):
    tids, w, dl = (x[r] for x in rows)
    D_local = tids[0].shape[0]
    lk = min(k, D_local)
    cand = ([], [], [], [])
    for s in range(_n(mesh)):
        scores, tfs = _local_score(tids[s], w[s], qi[s], qc[s])
        top_s, top_local = _leader_topk(scores, lk)
        for lst, v in zip(cand, (top_s, top_local + s * D_local,
                                 torch.gather(tfs, 1, top_local),
                                 dl[s][top_local])):
            lst.append(v)
    return cand


def _by_query_row(mesh: ShardMesh, nq: int, fn):
    """fn(r, q0, q1) for each query row r of a 2-D mesh over its slice
    [q0, q1) of the batch; the rows' outputs concatenated on the first
    device."""
    n_q = int(mesh.shape["q"])
    if nq % n_q:
        raise ValueError(f"{nq} queries do not split over {n_q} query rows")
    nql = nq // n_q
    outs = [fn(r, r * nql, (r + 1) * nql) for r in range(n_q)]
    return tuple(_all_gather([o[i] for o in outs], 0)
                 for i in range(len(outs[0])))


def sharded_retrieve_topk_split(mesh: ShardMesh, dense_impact,
                                dense_presence, tail_ids, tail_w,
                                doc_lengths, avgdl, fslots, fcnt, tail_rows,
                                tail_qids, tail_qcnt, k: int, alpha, beta,
                                base_rate=None, n_docs: int | None = None,
                                prior_free: bool = False,
                                return_tfs: bool = False, doc_mask=None,
                                impact_lo=None, impact_scale=None,
                                prob_dtype: torch.dtype = _F32):
    """Distributed top-k over the frequency-split index with the dense
    compare tail (the path of an index whose rare postings are refused):
    per shard, the frequent-term product on the shard's slab, the tail
    compare (K5) added by row, the ``doc_mask``, the leader top-k and tf
    at the local winners (presence rows plus the rare-term equality
    count); then the merge."""
    imp, pres, tids, tw = (_split_doc(mesh, a) for a in (
        dense_impact, dense_presence, tail_ids, tail_w))
    dl = _split_doc(mesh, doc_lengths)
    lo, sc = _split_doc(mesh, impact_lo), _scale_operand(mesh, impact_scale)
    devs = _doc_devices(mesh)
    D_local, K = imp[0].shape
    q8 = _int8_ok(sc, fcnt)
    dens = _densified(fslots, fcnt, K, devs)
    trow, tqi, tqc = (_replicate(x, devs) for x in (tail_rows, tail_qids,
                                                    tail_qcnt))
    masks = _doc_masks(mesh, doc_mask, D_local * _n(mesh))
    lk = min(k, D_local)
    cand = ([], [], [], [])
    for s in range(_n(mesh)):
        fs, fc, qvec, _ = dens[s]
        scores = sidx._impact_matmul(qvec, imp[s], lo[s], scale=sc[s],
                                     q_int8_ok=q8)
        t_scores, _ = sidx._compare_table(tids[s], tw[s], tqi[s], tqc[s])
        scores.index_add_(0, trow[s].long(), t_scores)
        scores = _apply_mask(scores, masks[s])
        top_s, top_local = _leader_topk(scores, lk)
        top_tf = (sidx._winner_tf_freq(pres[s], fs, fc, top_local)
                  + sidx._winner_tf_tail(tids[s], trow[s], tqi[s],
                                         top_local))
        for lst, v in zip(cand, (top_s, top_local + s * D_local, top_tf,
                                 dl[s][top_local])):
            lst.append(v)
    out = _merge(cand, k, avgdl, alpha, beta, base_rate, n_docs=n_docs,
                 prior_free=prior_free, prob_dtype=prob_dtype)
    return out if return_tfs else out[:3]


def sharded_retrieve_topk_split_sparse(
        mesh: ShardMesh, dense_impact, dense_presence, post_ids_sh,
        post_w_sh, doc_lengths, avgdl, fslots, fcnt, tail_rows, tail_slots,
        tail_qcnt, k: int, cand_cap: int, alpha, beta, base_rate=None, *,
        n_docs: int | None = None, prior_free: bool = False,
        approx: bool = False, doc_mask=None, impact_lo=None,
        local_k: int | None = None, tf_from_sign: bool = False,
        compact=None, compact_rmax: int = 0, impact_scale=None,
        post2_ids_sh=None, post2_w_sh=None, tailB_rows=None,
        tailB_slots=None, tailB_qcnt=None, tailB_slots2=None,
        tailB_qcnt2=None, cand_cap2: int = 0, tailH_rows=None,
        tailH_slots=None, tailH_qcnt=None, cand_capH: int = 0,
        compactH=None, compactH_rmax: int = 0, fused_mm: bool = False,
        impact_cols=None, prob_dtype: torch.dtype = _F32):
    """Distributed sparse-candidate exact top-k, the main sharded path:
    per shard, one frequent-term product (K4 with its block maxima when
    ``fused_mm``, reading ``impact_cols``, each shard's column-major
    pair; the library product otherwise), the pad and ``doc_mask``
    columns to -inf, the leader selection (K1 + K3), the rare-postings
    merge (K2, K3) against the shard-local postings
    (``split_index.build_sharded_postings``) in the single-device pass
    structure (light, heavy with ``cand_capH``, tier-2 with
    ``cand_cap2``), tf at the winners and global ids; then the merge of
    every shard's k winners (K3) and the dead rule.

    Exact like the single-device path: the global top-k lies in the
    union of the shards' top-k sets, each shard's merge visits entries
    in the single-device order restricted to its range, and shard-major
    candidates keep the lowest-id tie order. ``local_k`` < k trades
    recall for a smaller merge (exact only when no shard holds more
    than ``local_k`` of the true top-k). ``approx`` selects exactly, as
    on one device. The packed candidate builds (``compact``,
    ``compactH``) keep the global row indexing, so one host compaction
    serves every shard."""
    imp, pres, dl = (_split_doc(mesh, a) for a in (
        dense_impact, dense_presence, doc_lengths))
    pid, pw = _split_stack(mesh, post_ids_sh), _split_stack(mesh, post_w_sh)
    pid2, pw2 = (_split_stack(mesh, post2_ids_sh),
                 _split_stack(mesh, post2_w_sh))
    lo, sc = _split_doc(mesh, impact_lo), _scale_operand(mesh, impact_scale)
    cols = (impact_cols if impact_cols is not None
            else [None] * _n(mesh))
    devs = _doc_devices(mesh)
    D_local, K = imp[0].shape
    D_pad = D_local * _n(mesh)
    n_real = n_docs if n_docs is not None else D_pad
    lk = min(local_k or k, k)
    q8 = _int8_ok(sc, fcnt)
    fused = fused_mm and doc_mask is None and not approx and q8
    if fused and impact_cols is None:
        raise ValueError("fused_mm needs impact_cols, each shard's "
                         "column-major impact pair")
    dens = _densified(fslots, fcnt, K, devs)
    rep = {name: _replicate(x, devs) for name, x in dict(
        trow=tail_rows, tsl=tail_slots, tqc=tail_qcnt, cpk=compact,
        trowH=tailH_rows, tslH=tailH_slots, tqcH=tailH_qcnt, cpkH=compactH,
        trowB=tailB_rows, tslB=tailB_slots, tqcB=tailB_qcnt,
        tsl2B=tailB_slots2, tqc2B=tailB_qcnt2).items()}
    masks = _doc_masks(mesh, doc_mask, D_pad, n_real)
    cand = ([], [], [], [])
    for s in range(_n(mesh)):
        fs, fc, qvec, _ = dens[s]
        r = {name: v[s] for name, v in rep.items()}
        nv = min(max(n_real - s * D_local, 0), D_local)
        bmax = None
        if fused:
            scores, bmax = cuda_matmul.impact_matmul_bmax(qvec, *cols[s],
                                                          sc[s], nv)
        else:
            scores = sidx._impact_matmul(qvec, imp[s], lo[s], scale=sc[s],
                                         q_int8_ok=q8)
        # Global pad docs and doc_mask drop before the leader selection,
        # so they can neither lead nor win through postings.
        scores = _apply_mask(scores, masks[s])
        if bmax is not None and lk < bmax.shape[1]:
            topm_s, topm_i = sidx._topk_from_bmax(
                scores.reshape(scores.shape[0], -1, 256), bmax, lk, 256, nv)
        else:
            topm_s, topm_i = _leader_topk(scores, lk)
        out_ids, out_s, out_tf = sidx._sparse_merge(
            scores, topm_s, topm_i, pid[s], pw[s], r["trow"], r["tsl"],
            r["tqc"], lk, cand_cap, D_local, tf_from_sign=tf_from_sign,
            compact=(r["cpk"], compact_rmax) if compact is not None
            else None)
        if cand_capH:
            # Heavy pass: rows disjoint from the light pass's, at their
            # own (wider) cap, over its output.
            out_ids, out_s, out_tf = sidx._sparse_merge(
                scores, out_s, out_ids, pid[s], pw[s], r["trowH"],
                r["tslH"], r["tqcH"], lk, cand_capH, D_local,
                tf_from_sign=tf_from_sign,
                compact=(r["cpkH"], compactH_rmax) if compactH is not None
                else None, base_tail_tf=out_tf)
        if cand_cap2:
            # Tier-2 pass: group-B rows merge their leaders with their
            # shard-local tier-1 and tier-2 postings in one candidate set.
            R2 = pid2[s].shape[0] - 1
            out_ids, out_s, out_tf = sidx._sparse_merge(
                scores, out_s, out_ids, pid[s], pw[s], r["trowB"],
                r["tslB"], r["tqcB"], lk, cand_cap2, D_local,
                tf_from_sign=tf_from_sign,
                postings2=(pid2[s], pw2[s], r["tsl2B"], r["tqc2B"]),
                pad_row_mask=(r["tsl2B"] >= R2).all(dim=1),
                base_tail_tf=out_tf)
        del scores
        # Slots the merge left at -inf may hold the sentinel D_local:
        # clamped for the gathers, dead in the merge.
        safe = out_ids.clamp(0, D_local - 1)
        tf = sidx._winner_tf_freq(pres[s], fs, fc, safe) + out_tf
        for lst, v in zip(cand, (out_s, out_ids + s * D_local, tf,
                                 dl[s][safe])):
            lst.append(v)
    return _merge(cand, k, avgdl, alpha, beta, base_rate, n_real=n_real,
                  prior_free=prior_free, prob_dtype=prob_dtype)


def sharded_retrieve_topk_split_2d(mesh: ShardMesh, dense_impact,
                                   dense_presence, tail_ids, tail_w,
                                   doc_lengths, avgdl, fslots, fcnt,
                                   tail_rows, tail_qids, tail_qcnt, k: int,
                                   alpha, beta, base_rate=None,
                                   n_docs: int | None = None,
                                   prior_free: bool = False, impact_lo=None,
                                   approx: bool = False, doc_mask=None,
                                   impact_scale=None,
                                   return_tfs: bool = False,
                                   prob_dtype: torch.dtype = _F32):
    """Frequency-split top-k on a (query x document) 2-D mesh: query row
    r serves its slice of the batch, the split tables shard over 'd'.
    The tail group is replicated; each row scatters only the tail rows
    inside its slice (the others go to a trash row), so every tail row
    lands once across 'q'. Candidates merge over 'd' only, on
    ``devices[r, 0]``; the rows' outputs are concatenated on the first
    device. ``approx`` selects exactly."""
    del approx
    tables = [_rows(mesh, _split_doc(mesh, a)) for a in (
        dense_impact, dense_presence, tail_ids, tail_w, doc_lengths,
        impact_lo)]
    sc_rows = _rows(mesh, _scale_operand(mesh, impact_scale))
    nq = _host(fslots).shape[0]
    D_local, K = tables[0][0][0].shape
    D_pad = D_local * _n(mesh)
    n_real = n_docs if n_docs is not None else D_pad
    masks = _doc_masks(mesh, doc_mask, D_pad, n_real)
    q8 = _int8_ok(sc_rows[0], fcnt)
    lk = min(k, D_local)

    def row(r, q0, q1):
        imp, pres, tids, tw, dl, lo = (t[r] for t in tables)
        sc = sc_rows[r]
        devs = list(mesh.devices[r])
        dens = _densified(_tensor(fslots)[q0:q1], _tensor(fcnt)[q0:q1], K,
                          devs)
        trow, tqi, tqc = (_replicate(x, devs) for x in (
            tail_rows, tail_qids, tail_qcnt))
        nql = q1 - q0
        cand = ([], [], [], [])
        for s in range(_n(mesh)):
            _, _, qvec, qpres = dens[s]
            scores = sidx._impact_matmul(qvec, imp[s], lo[s], scale=sc[s],
                                         q_int8_ok=q8)
            tfs = qpres @ pres[s].to(_F32).t()
            t_scores, t_tfs = sidx._compare_table(tids[s], tw[s], tqi[s],
                                                  tqc[s])
            local = trow[s].long() - q0
            row_safe = torch.where((local >= 0) & (local < nql), local, nql)
            zero = scores.new_zeros((1, D_local))
            scores = torch.cat([scores, zero]).index_add_(
                0, row_safe, t_scores)[:nql]
            tfs = torch.cat([tfs, zero]).index_add_(0, row_safe,
                                                    t_tfs)[:nql]
            mask = masks[s]
            if mask is not None and not isinstance(mask, int):
                mask = mask.to(devs[s])
            scores = _apply_mask(scores.contiguous(), mask)
            top_s, top_local = _leader_topk(scores, lk)
            for lst, v in zip(cand, (top_s, top_local + s * D_local,
                                     torch.gather(tfs, 1, top_local),
                                     dl[s][top_local])):
                lst.append(v)
        return _merge(cand, k, avgdl, alpha, beta, base_rate, n_docs=n_docs,
                      prior_free=prior_free, prob_dtype=prob_dtype)

    out = _by_query_row(mesh, nq, row)
    return out if return_tfs else out[:3]


# ---------------------------------------------------------------------------
# Dense scores and probabilities (outputs doc-sharded: per-shard parts)
# ---------------------------------------------------------------------------


def sharded_scores_all(mesh: ShardMesh, term_ids, weights, qids, qcnt):
    """Dense (nq, D_local) BM25 scores and unique-overlap tf counts per
    shard (K5), as two lists of parts."""
    tids, w = _split_doc(mesh, term_ids), _split_doc(mesh, weights)
    devs = _doc_devices(mesh)
    qi, qc = _replicate(qids, devs), _replicate(qcnt, devs)
    outs = [_local_score(tids[s], w[s], qi[s], qc[s])
            for s in range(_n(mesh))]
    return [o[0] for o in outs], [o[1] for o in outs]


def sharded_probabilities_all(mesh: ShardMesh, term_ids, weights,
                              doc_lengths, avgdl, qids, qcnt, alpha, beta,
                              base_rate=None, prior_free: bool = False,
                              prob_dtype: torch.dtype = _F32):
    """Dense calibrated probabilities per shard (0 where the score is
    0, pad rows included)."""
    scores, tfs = sharded_scores_all(mesh, term_ids, weights, qids, qcnt)
    return apply_transform_sharded(mesh, scores, tfs, doc_lengths, avgdl,
                                   alpha, beta, base_rate,
                                   prior_free=prior_free,
                                   prob_dtype=prob_dtype)


def sharded_scores_all_split(mesh: ShardMesh, dense_impact, dense_presence,
                             tail_ids, tail_w, fslots, fcnt, tail_rows,
                             tail_qids, tail_qcnt, impact_lo=None,
                             impact_scale=None):
    """Dense scores and tf counts per shard through the split index: the
    shard's product, its presence dot and its tail compare (K5), each
    element equal to the single-device split scores."""
    imp, pres, tids, tw = (_split_doc(mesh, a) for a in (
        dense_impact, dense_presence, tail_ids, tail_w))
    lo, sc = _split_doc(mesh, impact_lo), _scale_operand(mesh, impact_scale)
    devs = _doc_devices(mesh)
    q8 = _int8_ok(sc, fcnt)
    enc = [_replicate(x, devs) for x in (fslots, fcnt, tail_rows, tail_qids,
                                         tail_qcnt)]
    outs = [sidx._split_scores(imp[s], pres[s], tids[s], tw[s],
                               *(e[s] for e in enc), impact_lo=lo[s],
                               impact_scale=sc[s], q_int8_ok=q8)
            for s in range(_n(mesh))]
    return [o[0] for o in outs], [o[1] for o in outs]


def apply_transform_sharded(mesh: ShardMesh, scores, tfs, doc_lengths,
                            avgdl, alpha, beta, base_rate=None,
                            prior_free: bool = False,
                            prob_dtype: torch.dtype = _F32):
    """Dense probabilities per shard from doc-sharded scores and tf."""
    sp, tp, dl = (_split_doc(mesh, a, axis) for a, axis in (
        (scores, 1), (tfs, 1), (doc_lengths, 0)))
    return [_transform(sp[s], tp[s], dl[s][None, :], avgdl, alpha, beta,
                       base_rate, prior_free, prob_dtype)
            for s in range(_n(mesh))]


def corpus_stats_psum(mesh: ShardMesh, doc_lengths, term_ids, n_terms: int):
    """Global corpus statistics from the shards: (N, avgdl, df), N and
    the doc-length sum psum'd in float32, df a per-shard count of term
    ids (int32, exact) psum'd. Pad rows count, as on the device table."""
    dl, tids = _split_doc(mesh, doc_lengths), _split_doc(mesh, term_ids)
    ns, sums, dfs = [], [], []
    for d, t in zip(dl, tids):
        ns.append(torch.tensor(float(d.shape[0]), dtype=_F32,
                               device=d.device))
        sums.append(d.to(_F32).sum())
        valid = (t >= 0).to(torch.int32).reshape(-1)
        dfs.append(torch.zeros(n_terms, dtype=torch.int32,
                               device=t.device).index_add_(
            0, t.clamp(0, n_terms - 1).reshape(-1).long(), valid))
    n = _psum(ns)
    return n, _psum(sums) / n, _psum(dfs)


# ---------------------------------------------------------------------------
# Sharded fits
# ---------------------------------------------------------------------------


def sharded_fit_transform(mesh: ShardMesh, scores, labels, *, alpha0=1.0,
                          beta0=0.0, prior_aware: bool = False, priors=None,
                          learning_rate: float = 0.01,
                          max_iterations: int = 1000,
                          tolerance: float = 1e-6):
    """Data-parallel transform fit in float32: the samples shard over the
    mesh, each step sums the shards' mean gradients weighted by their
    sample counts (psum, in shard order) over the total, and the loop
    stops as the single-device fit does (both moves below
    ``tolerance``, that step applied, or ``max_iterations``). Returns
    (alpha, beta) as 0-dim tensors on the first device and the step
    count."""
    s_p = [p.to(_F32) for p in _split_doc(mesh, scores)]
    y_p = [p.to(_F32) for p in _split_doc(mesh, labels)]
    p_p = ([torch.zeros_like(s) for s in s_p] if priors is None
           else [p.to(_F32) for p in _split_doc(mesh, priors)])
    ones = [torch.ones_like(s) for s in s_p]
    n_total = float(sum(s.shape[0] for s in s_p))
    dev = s_p[0].device
    lr = torch.tensor(learning_rate, dtype=_F32, device=dev)
    tol = torch.tensor(tolerance, dtype=_F32, device=dev)
    a = torch.tensor(alpha0, dtype=_F32, device=dev)
    b = torch.tensor(beta0, dtype=_F32, device=dev)
    it, done = 0, False
    while not done and it < max_iterations:
        g = [T._bce_grads(a.to(s.device), b.to(s.device), s, y, p, o,
                          prior_aware, _F32)
             for s, y, p, o in zip(s_p, y_p, p_p, ones)]
        g_a = T.true_div(_psum([ga * float(s.shape[0])
                                for (ga, _), s in zip(g, s_p)]), n_total)
        g_b = T.true_div(_psum([gb * float(s.shape[0])
                                for (_, gb), s in zip(g, s_p)]), n_total)
        na = a - lr * g_a
        nb = b - lr * g_b
        # One device-to-host read a step.
        done = bool((torch.abs(na - a) < tol) & (torch.abs(nb - b) < tol))
        a, b = na, nb
        it += 1
    return a, b, it


def _bce_step(score_parts, label_parts, alpha, beta, learning_rate):
    """One GD step on the mean BCE of the likelihood over every shard's
    (score, label) pairs: sums and counts psum'd, the gradient in
    (alpha, beta) only (the scores are constants: no kernel needs a
    backward). Returns (alpha', beta', loss) as 0-dim tensors."""
    dev = score_parts[0].device
    a = torch.tensor(float(alpha), dtype=_F32, device=dev,
                     requires_grad=True)
    b = torch.tensor(float(beta), dtype=_F32, device=dev,
                     requires_grad=True)
    totals, count = [], 0
    for s, y in zip(score_parts, label_parts):
        L = clamp_probability(sigmoid(a.to(s.device) * (s - b.to(s.device)),
                                      _F32), _F32)
        bce = -(y * torch.log(L) + (1.0 - y) * torch.log1p(-L))
        totals.append(bce.sum())
        count += bce.numel()
    loss = T.true_div(_psum(totals), float(count))
    g_a, g_b = torch.autograd.grad(loss, (a, b))
    with torch.no_grad():
        return (a - learning_rate * g_a, b - learning_rate * g_b,
                loss.detach())


def sharded_train_step(mesh: ShardMesh, term_ids, weights, doc_lengths,
                       avgdl, qids, qcnt, labels, alpha, beta,
                       learning_rate: float = 0.01):
    """One training step over the sharded corpus: each shard scores the
    batch against its slab (K5), the BCE of the likelihood against the
    (nq, D_pad) labels (cut along the doc axis) is psum'd, and one GD
    step moves (alpha, beta)."""
    del doc_lengths, avgdl  # the likelihood reads the scores only
    with torch.no_grad():
        scores, _ = sharded_scores_all(mesh, term_ids, weights, qids, qcnt)
    labels = [p.to(_F32) for p in _split_doc(mesh, labels, axis=1)]
    return _bce_step(scores, labels, alpha, beta, learning_rate)


def sharded_train_step_split(mesh: ShardMesh, dense_impact, dense_presence,
                             tail_ids, tail_w, fslots, fcnt, tail_rows,
                             tail_qids, tail_qcnt, labels, alpha, beta,
                             learning_rate: float = 0.01, impact_lo=None,
                             impact_scale=None):
    """:func:`sharded_train_step` with the split index's scores (the
    frequent-term product plus the compare tail, K5), the kernels that
    serve retrieval."""
    with torch.no_grad():
        scores, _ = sharded_scores_all_split(
            mesh, dense_impact, dense_presence, tail_ids, tail_w, fslots,
            fcnt, tail_rows, tail_qids, tail_qcnt, impact_lo=impact_lo,
            impact_scale=impact_scale)
    labels = [p.to(_F32) for p in _split_doc(mesh, labels, axis=1)]
    return _bce_step(scores, labels, alpha, beta, learning_rate)


def doc_pad_multiple(n_shards: int) -> int:
    """The doc-axis padding that divides the mesh: lcm(2048, n_shards)."""
    return 2048 * n_shards // math.gcd(2048, n_shards)
