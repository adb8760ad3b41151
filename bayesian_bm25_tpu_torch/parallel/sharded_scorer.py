"""ShardedBayesianBM25Scorer: the document-sharded scorer.

Counterpart of ``bayesian_bm25_tpu/parallel/sharded_scorer.py``: the API
of ``BayesianBM25Scorer`` with the document axis of every index table
cut over a mesh (``parallel/sharded.py``) and retrieval run as per-shard
scoring, leader selection and merge, then the cross-shard merge on the
merge device (the mesh's first device, where the transform lives). The
tables are built on the host and each shard's part is placed on its
device; the scorer keeps no device tensor that spans the whole doc
axis, so a mesh of n shards on one card holds the corpus once. The
host mirrors stay, as on the single-device scorer.

Exactness: ids, their order, tie order and integer tf equal the
single-device scorer's; scores and probabilities too wherever the
shard's frequent-term product rounds as the whole product does (int8
storage always: integer dots and a per-element epilogue).
"""

from __future__ import annotations

import numpy as np
import torch

from bayesian_bm25_tpu_torch.engine import cuda_matmul
from bayesian_bm25_tpu_torch.engine import split_index as sidx
from bayesian_bm25_tpu_torch.engine.tokenize import tokenize_texts
from bayesian_bm25_tpu_torch.models.scorer import BayesianBM25Scorer
from bayesian_bm25_tpu_torch.parallel import sharded

# Split-index tables cut along the doc axis (axis 0), besides the
# doc-major term_ids / weights / doc_lengths of the base index.
_SPLIT_TABLES = ("dense_impact", "dense_impact_lo", "dense_presence",
                 "tail_term_ids", "tail_weights")


class ShardedBayesianBM25Scorer(BayesianBM25Scorer):
    """Document-sharded scorer over a mesh.

    Parameters are those of ``BayesianBM25Scorer`` (its ``device``
    excepted) plus:

    mesh: a ``sharded.ShardMesh``, 1-D with axis ``'d'`` or 2-D with
        axes ``('q', 'd')``; or
    n_devices: a 1-D mesh over the first n cards (default: all); or
    mesh_shape: a 2-D (q, d) mesh, e.g. ``mesh_shape=(2, 4)``;
    device: None (the default) builds the mesh over the cards; a named
        device (``"cuda"``, ``"cpu"``) puts every shard on it.

    Retrieval takes the sharded sparse-candidate path on 1-D meshes (the
    dense compare tail when the rare postings are refused, the doc-major
    compare for small vocabularies) and the q x d split path on 2-D
    meshes. ``retrieve``, ``retrieve_many`` and ``retrieve_stream`` are
    the base class's, around :meth:`_retrieve_launch`.
    """

    def __init__(self, *args, mesh=None, n_devices: int | None = None,
                 mesh_shape: tuple[int, int] | None = None, device=None,
                 **kwargs) -> None:
        if mesh is None:
            mesh = (sharded.make_mesh_2d(*mesh_shape, device=device)
                    if mesh_shape is not None
                    else sharded.make_mesh(n_devices, device=device))
        if tuple(getattr(mesh, "axis_names", ())) == ("d",):
            self._is_2d = False
        elif tuple(getattr(mesh, "axis_names", ())) == ("q", "d"):
            # 2-D (query x document): retrieval splits the batch over
            # 'q'; every other entry point shards over 'd' only.
            self._is_2d = True
        else:
            raise ValueError(
                "mesh must be 1-D ('d',) or 2-D ('q', 'd'), got "
                f"{getattr(mesh, 'axis_names', mesh)}")
        super().__init__(*args, device=mesh.devices.flat[0], **kwargs)
        self._mesh = mesh
        self._n_shards = int(mesh.shape["d"])
        self._sh: dict = {}     # table name -> per-shard parts
        self._post_sh = None    # sharded rare postings (ids, w, df)
        self._post2_sh = None   # sharded tier-2 rectangle (capped builds)

    @property
    def mesh(self) -> sharded.ShardMesh:
        return self._mesh

    # -- construction hooks ---------------------------------------------------

    @property
    def _index_device(self) -> torch.device:
        return torch.device("cpu")

    def _doc_pad_multiple(self) -> int:
        # The doc axis divides the mesh, for the first build and for
        # every add_documents append.
        return sharded.doc_pad_multiple(self._n_shards)

    def _finalize_index(self) -> None:
        """Cut every doc-axis table over the mesh and drop the whole
        ones: term table, weights, doc lengths, the split's impact
        matrices, presence, tail table and int8 scales (axis 1), and the
        rare postings re-cut by doc range with shard-local ids."""
        idx, s, mesh = self._index, self._split, self._mesh
        self._post_sh = self._post2_sh = None
        if s is not None and s.over_term_ids is not None:
            # Overflow tables index docs globally: rebuild without one.
            storage = ("int8" if s.impact_scale is not None else
                       "hilo" if s.dense_impact_lo is not None else
                       "bf16" if s.dense_impact.dtype == torch.bfloat16
                       else "f32")
            self._split = s = sidx.build_split_index(
                idx, n_frequent=s.n_frequent, enable_overflow=False,
                storage=storage, device=self._index_device)
        sh = {name: sharded._split_doc(mesh, getattr(idx, name))
              for name in ("term_ids", "weights", "doc_lengths")}
        idx.term_ids = idx.weights = idx.doc_lengths = None
        if s is not None:
            if s.post_doc_ids is not None:
                pid, pw, df = sidx.build_sharded_postings(s, self._n_shards)
                self._post_sh = (sharded._split_stack(mesh, pid),
                                 sharded._split_stack(mesh, pw), df)
                t2 = sidx.build_sharded_postings2(s, self._n_shards)
                if t2 is not None:
                    self._post2_sh = (sharded._split_stack(mesh, t2[0]),
                                      sharded._split_stack(mesh, t2[1]),
                                      t2[2])
            for name in _SPLIT_TABLES:
                sh[name] = sharded._split_doc(mesh, getattr(s, name))
                setattr(s, name, None)
            sh["impact_scale"] = sharded._scale_operand(mesh, s.impact_scale)
            s.impact_scale = None
            s._impact_cols = None
        self._sh = sh
        if self._is_2d:
            self._rows = {name: sharded._rows(mesh, parts)
                          for name, parts in sh.items()}

    def _doc_lengths_device(self) -> torch.Tensor:
        return sharded._all_gather(self._sh["doc_lengths"], 0)

    def _impact_columns(self) -> list:
        """Each shard's column-major impact pair (K4's operands), built
        on the first fused call and kept."""
        if "impact_cols" not in self._sh:
            self._sh["impact_cols"] = [
                sidx._column_major(hi, lo) for hi, lo in zip(
                    self._sh["dense_impact"], self._sh["dense_impact_lo"])]
        return self._sh["impact_cols"]

    def index_texts(self, texts, *, lowercase: bool = True,
                    remove_stopwords: bool = True,
                    stem: bool | str = True) -> None:
        # Through index(), so the doc axis pads to the mesh's multiple.
        self.index(tokenize_texts(texts, lowercase=lowercase,
                                  remove_stopwords=remove_stopwords,
                                  stem=stem))
        self._tok_opts = dict(lowercase=lowercase,
                              remove_stopwords=remove_stopwords, stem=stem)

    # -- querying -------------------------------------------------------------

    def _retrieve_launch(self, query_tokens, k, approx, doc_mask,
                         coarse: bool = False):
        """Encode on the host and queue every shard's retrieval, then the
        merge; no host sync. Returns (nq, top_ids, probs, top_scores,
        top_tfs) on the merge device."""
        if coarse:
            raise ValueError("the sharded scorer has no coarse tier")
        if self._transform is None:
            raise RuntimeError("Call index() before retrieve().")
        idx, s, t = self._index, self._split, self._transform
        k_eff = min(k, idx.n_docs)
        nq = len(query_tokens)
        doc_mask = self._host_mask(doc_mask)
        if k_eff == 0:
            empty = torch.zeros((nq, 0), dtype=torch.float32,
                                device=self._device)
            return nq, empty.to(torch.int32), empty, empty, empty
        queries = list(query_tokens) or [[]]
        sh = self._sh
        common = dict(n_docs=idx.n_docs,
                      prior_free=t._training_mode == "prior_free",
                      doc_mask=doc_mask, prob_dtype=self._prob_dtype)
        scalars = (t.alpha, t.beta, t.base_rate)
        if self._is_2d:
            if s is None:
                raise RuntimeError(
                    "2-D mesh retrieval requires the split index (corpus "
                    "too small/vocab too narrow for a split build)")
            n_q = int(self._mesh.shape["q"])
            queries += [[]] * (-len(queries) % n_q)
            rows = self._rows
            out = sharded.sharded_retrieve_topk_split_2d(
                self._mesh, rows["dense_impact"], rows["dense_presence"],
                rows["tail_term_ids"], rows["tail_weights"],
                rows["doc_lengths"], idx.avgdl,
                *sidx.encode_queries_split(queries, s), k_eff, *scalars,
                impact_lo=rows["dense_impact_lo"], approx=approx,
                impact_scale=rows["impact_scale"], return_tfs=True,
                **common)
        elif s is not None and self._post_sh is not None:
            out = self._sparse_launch(queries, k_eff, approx, common)
        elif s is not None:
            out = sharded.sharded_retrieve_topk_split(
                self._mesh, sh["dense_impact"], sh["dense_presence"],
                sh["tail_term_ids"], sh["tail_weights"], sh["doc_lengths"],
                idx.avgdl, *sidx.encode_queries_split(queries, s), k_eff,
                *scalars, return_tfs=True, impact_lo=sh["dense_impact_lo"],
                impact_scale=sh["impact_scale"], **common)
        else:
            out = sharded.sharded_retrieve_topk(
                self._mesh, sh["term_ids"], sh["weights"], sh["doc_lengths"],
                idx.avgdl, *self._encode(queries), k_eff, *scalars,
                return_tfs=True, **common)
        return (nq, *(a[:nq] for a in out))

    def _sparse_launch(self, queries, k_eff, approx, common):
        """The sharded sparse-candidate path: the single-device host pass
        structure (tier partition, then the light/heavy split of the
        tier-1 group, decided on global dfs), caps from the per-shard df
        tables, then ``sharded_retrieve_topk_split_sparse``."""
        s, t, sh = self._split, self._transform, self._sh
        fslots, fcnt, trows, tqids, tqcnt = sidx.encode_queries_split(
            queries, s)
        pid_sh, pw_sh, df_sh = self._post_sh
        R = pid_sh[0].shape[0] - 1
        P = pid_sh[0].shape[1]
        (trows, tslots, tqcnt), grpB = sidx.split_tail_groups(
            trows, tqids, tqcnt, s)
        lh = (sidx.split_light_heavy(trows, tslots, tqcnt, s, k_eff)
              if sidx.LIGHT_HEAVY else None)
        kw: dict = {}
        if lh is not None:
            (trows, tslots, tqcnt), (hrows, hslots, hqcnt) = lh
            kw.update(tailH_rows=hrows, tailH_slots=hslots, tailH_qcnt=hqcnt,
                      cand_capH=sidx.sharded_candidate_cap(df_sh, hslots,
                                                           k_eff, P))
            if sidx.PACKED_BUILD:
                packedH, r_maxH = sidx.compact_tail_postings(hslots, hqcnt, R)
                if r_maxH < hslots.shape[1]:
                    kw.update(compactH=packedH, compactH_rmax=r_maxH)
        if grpB is not None:
            pid2_sh, pw2_sh, df2_sh = self._post2_sh
            trB, s1B, qcB, s2B, qc2B = grpB
            kw.update(post2_ids_sh=pid2_sh, post2_w_sh=pw2_sh,
                      tailB_rows=trB, tailB_slots=s1B, tailB_qcnt=qcB,
                      tailB_slots2=s2B, tailB_qcnt2=qc2B,
                      cand_cap2=sidx.sharded_candidate_cap2(
                          df_sh, df2_sh, s1B, s2B, k_eff, P,
                          pid2_sh[0].shape[1]))
        cap = sidx.sharded_candidate_cap(df_sh, tslots, k_eff, P)
        compact, r_max = None, 0
        if sidx.PACKED_BUILD:
            packed, r_max = sidx.compact_tail_postings(tslots, tqcnt, R)
            if r_max < tslots.shape[1]:
                compact = packed
            else:
                r_max = 0
        # K4 per shard where the single-device gate would take it.
        use_fmm = cuda_matmul.fused_route(
            sh["dense_impact"][0], sh["dense_impact_lo"][0],
            sh["impact_scale"][0], len(fslots), doc_mask=common["doc_mask"],
            approx=approx,
            q_int8_ok=sharded._int8_ok(sh["impact_scale"], fcnt))
        return sharded.sharded_retrieve_topk_split_sparse(
            self._mesh, sh["dense_impact"], sh["dense_presence"], pid_sh,
            pw_sh, sh["doc_lengths"], self._index.avgdl, fslots, fcnt,
            trows, tslots, tqcnt, k_eff, cap, t.alpha, t.beta, t.base_rate,
            approx=approx, impact_lo=sh["dense_impact_lo"],
            tf_from_sign=s.post_w_positive, compact=compact,
            compact_rmax=r_max, impact_scale=sh["impact_scale"],
            fused_mm=use_fmm,
            impact_cols=self._impact_columns() if use_fmm else None,
            **common, **kw)

    def _dense_parts(self, queries):
        """Per-shard dense (scores, tfs) parts of a query batch."""
        sh = self._sh
        if self._split is not None:
            return sharded.sharded_scores_all_split(
                self._mesh, sh["dense_impact"], sh["dense_presence"],
                sh["tail_term_ids"], sh["tail_weights"],
                *sidx.encode_queries_split(queries, self._split),
                impact_lo=sh["dense_impact_lo"],
                impact_scale=sh["impact_scale"])
        return sharded.sharded_scores_all(self._mesh, sh["term_ids"],
                                          sh["weights"],
                                          *self._encode(queries))

    def _dense_scores_tfs_device(self, query_tokens_batch):
        nq = len(query_tokens_batch)
        scores, tfs = self._dense_parts(list(query_tokens_batch) or [[]])
        n = self._index.n_docs
        return (sharded._all_gather(scores, 1)[:nq, :n],
                sharded._all_gather(tfs, 1)[:nq, :n])

    def _scores_internal(self, query_tokens_batch) -> np.ndarray:
        # The shards' parts meet on the host, not on the merge device.
        if self._index is None:
            raise RuntimeError("Call index() before scoring.")
        nq = len(query_tokens_batch)
        scores, _ = self._dense_parts(list(query_tokens_batch) or [[]])
        dense = np.concatenate([p.cpu().numpy() for p in scores], axis=1)
        return self._apply_deleted(
            dense[:nq, : self._index.n_docs].astype(np.float64))

    def _dense_probs_device(self, query_tokens_batch) -> torch.Tensor:
        if self._transform is None:
            raise RuntimeError("Call index() before get_probabilities().")
        idx, t = self._index, self._transform
        nq = len(query_tokens_batch)
        scores, tfs = self._dense_parts(list(query_tokens_batch) or [[]])
        probs = sharded.apply_transform_sharded(
            self._mesh, scores, tfs, self._sh["doc_lengths"], idx.avgdl,
            t.alpha, t.beta, t.base_rate,
            prior_free=t._training_mode == "prior_free",
            prob_dtype=self._prob_dtype)
        return sharded._all_gather(probs, 1)[:nq, : idx.n_docs]
