// K5 bm25_compare: BM25 scores and unique-overlap tf counts of a query
// batch against a doc-major term table.
//
// Replaces bayesian_bm25_tpu/engine/pallas_bm25.py (_bm25_kernel, launched
// through _score_chunk_pallas / score_all_pallas).
//
//   scores[q, r] = sum_j c[q, j] * s_j,   s_j = sum_t w[r, t] * [ids[r, t] == qids[q, j]]
//   tfs[q, r]    = sum_j sum_t [ids[r, t] == qids[q, j]]
//
// for any table (R, T), batch (nq, Q). The summation order is the one
// engine/scoring.py:score_all_xla (the path the JAX package runs) and the
// compare tail split_index._compare_table use: query slots j in ascending
// order, acc = fmaf(c_j, s_j, acc), with s_j = 0.0f + w on a match and 0
// otherwise. A table row holds each id at most once (DOC_PAD -1 aside, in
// any position), so s_j has at most one term; XLA contracts
// acc + c_j * s_j into one FMA, so the result is bit-equal to the JAX
// package. A row that repeats an id is outside the contract: the id then
// matches once, with one of its weights.
//
// Bound: bytes. The function needs one lookup per (query slot, row) and
// moves the table once, the queries once and both outputs once; at
// (8192 queries, a 51200 x 128 doc-major table, Q = 8) that is 3.4 GB,
// ~1.0 ms at 3.35 TB/s, against ~3.4e9 lookups. An all-pairs scan (each
// slot against each of the row's T ids) does T times the lookups' work
// and is bound by the instruction rate instead.
//
// Design, rows of T <= kHashMaxT ids. A block owns 32 table rows, one per
// lane, and builds each row's open-addressed hash (id -> weight) in shared
// memory once: H = 2^L slots, the next power of two >= 2T and at least
// 256, linear probing. DOC_PAD entries are not inserted and -1 is the
// empty-slot key, so a probe for any id other than -1 stops at an empty
// slot and never matches one. When every id of the block's rows lies in
// [0, H) (every doc-major table: at most 256 terms), the slot is the id
// itself, a perfect hash: one probe decides every query slot, with no
// probe loop and no branch. Otherwise multiplicative hashing, at a load of
// at most one half (at most 1/8 for the split tail's T = 32). The 32 rows'
// tables are interleaved (slot s of the row of lane l is the 8-byte word
// s * 32 + l), so every lane reads its own banks whatever slot it probes;
// the build gives lane l row l too, so its atomicCAS inserts are
// conflict-free. Each warp then takes one query at a time: its ids and
// counts are staged in shared memory per 128-query tile and read as
// broadcasts; each lane probes its own row once per slot, the first probes
// of 8 slots in flight together, keeps the sum in a register and writes
// each output once. Lanes are consecutive rows, so the stores are
// coalesced; there are no atomics on the outputs.
//
// What bounds it is the instruction rate and shared-memory latency, not the
// lookups' count: a per-slot branch (slot in range, slot -1, id below -1,
// direct or not) cost more than the probe itself, and in a hashed table the
// longest of the 32 lanes' probe chains sets each slot's time. So the rare
// cases leave the per-slot path: a tile that holds a slot of -1 (no index
// produces one; it matches the row's pads) takes a path that scans the row
// in global memory for that slot and sums the pads' weights in row order;
// slots past Q are staged as INT_MIN with count 0, which no direct table
// holds; and a QUERY_PAD slot probes only in a block whose rows hold an
// id below -1, the only place it can match (as in the reference).
//
// A block walks a run of query tiles with its hash kept; the runs are as
// long as leaves ~16 waves of blocks on the card, so the table is read a
// few times in all (4 times at the doc-major shape, ~6% of the output
// bytes). Q > 32 runs in chunks of 32 slots, the sum carried through the
// output between chunks in the same j order.
//
// Rows wider than kHashMaxT, whose hash would not fit the shared-memory
// budget, take bm25_scan_kernel: the same block shape, each lane scanning
// its row in global memory against the query's ids in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // table rows per block: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = 128;  // queries staged per tile, 16 per warp
constexpr int kDocPad = -1;    // also the empty-slot key of the hash
constexpr int kNoId = -2147483647 - 1;  // padding slots: never a direct key
constexpr int kHashMaxT = 256;  // 512 slots x 32 rows x 8 B = 128 KB
constexpr int kWaves = 16;      // blocks wanted per resident block slot
constexpr int kProbeGroup = 8;  // query slots whose first probes overlap

// Slots per row: at least 256, so every doc-major table (ids < 256) is
// direct, and at least 2T.
__host__ __device__ inline int log2_slots(int T) {
  int l = 8;
  while ((1 << l) < 2 * T) ++l;
  return l;
}

__device__ __forceinline__ unsigned slot_of(int id, int log2h) {
  return ((unsigned)id * 2654435761u) >> (32 - log2h);
}

template <int QM>
__host__ __device__ inline size_t query_smem() {
  return (size_t)kQueries * QM * (sizeof(int) + sizeof(float));
}

// Stage query slots [j0, j0 + qn) of queries [q0, q0 + nt) as a
// (kQueries, QM) tile. Slots past qn hold kNoId with count 0: in a direct
// table no key is negative but -1 (empty), so kNoId never matches, and
// the hashed paths stop at qn. Returns whether this thread staged a -1.
template <int QM>
__device__ __forceinline__ bool stage_queries(
    const int* __restrict__ qids, const float* __restrict__ qcnt, int* s_qid,
    float* s_qc, int q0, int nt, int Q, int j0, int qn) {
  bool pad_slot = false;
  for (int i = threadIdx.x; i < kQueries * QM; i += kThreads) {
    const int qq = i / QM;
    const int j = i - qq * QM;
    const bool ok = qq < nt && j < qn;
    const long long src = (long long)(q0 + qq) * Q + j0 + j;
    const int id = ok ? __ldg(qids + src) : kNoId;
    pad_slot |= id == kDocPad;
    s_qid[i] = id;
    s_qc[i] = ok ? __ldg(qcnt + src) : 0.0f;
  }
  return pad_slot;
}

// One query against the lane's row, no slot -1: the first probes of a
// group of slots in flight together, then each slot resolved. DIRECT:
// the slot is the id, so one probe decides every slot, the padding slots
// included.
template <int QM, bool DIRECT>
__device__ __forceinline__ void score_query(const int2* tab, const int* q,
                                            const float* c, int qn,
                                            unsigned mask, int log2h,
                                            bool probe_neg, float& acc,
                                            int& matches) {
  constexpr int G = QM < kProbeGroup ? QM : kProbeGroup;
#pragma unroll
  for (int g = 0; g < QM; g += G) {
    if (!DIRECT && g >= qn) break;  // warp-uniform
    int2 e[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (DIRECT || (g + j < qn && (q[g + j] > kDocPad || probe_neg)))
        e[j] = tab[(DIRECT ? (unsigned)q[g + j] & mask
                           : slot_of(q[g + j], log2h)) * kRows];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (!DIRECT && g + j >= qn) break;  // warp-uniform
      const int id = q[g + j];
      int2 ej = e[j];
      bool hit;
      if (DIRECT) {
        hit = ej.x == id;
      } else if (id > kDocPad || probe_neg) {  // warp-uniform
        for (unsigned sl = slot_of(id, log2h);
             ej.x != id && ej.x != kDocPad;) {
          sl = (sl + 1) & mask;
          ej = tab[sl * kRows];
        }
        hit = ej.x == id;
      } else {
        hit = false;  // QUERY_PAD, and the block holds no id below -1
      }
      acc = fmaf(c[g + j], hit ? __int_as_float(ej.y) : 0.0f, acc);
      matches += hit;
    }
  }
}

// One query of a tile that holds a slot -1: such a slot matches the row's
// pads, so it scans the row in global memory and sums their weights in
// row order; the other slots probe one at a time. q and c are the staged
// slots in shared memory.
__device__ void score_query_pads(const int2* tab, const int* q,
                                 const float* c, int qn, unsigned mask,
                                 int log2h, bool direct, const int* rid,
                                 const float* rw, int T, bool row_ok,
                                 float& acc, int& matches) {
  for (int j = 0; j < qn; ++j) {
    const int id = q[j];
    float s = 0.0f;
    if (id == kDocPad) {  // warp-uniform
      if (row_ok)
        for (int t = 0; t < T; ++t)
          if (__ldg(rid + t) == kDocPad) {
            s = s + __ldg(rw + t);
            ++matches;
          }
    } else {
      unsigned sl = direct ? (unsigned)id & mask : slot_of(id, log2h);
      int2 e = tab[sl * kRows];
      while (!direct && e.x != id && e.x != kDocPad) {
        sl = (sl + 1) & mask;
        e = tab[sl * kRows];
      }
      if (e.x == id) {
        s = __int_as_float(e.y);
        ++matches;
      }
    }
    acc = fmaf(c[j], s, acc);
  }
}

template <int QM>
__global__ void __launch_bounds__(kThreads)
    bm25_hash_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                     const int* __restrict__ qids,
                     const float* __restrict__ qcnt,
                     float* __restrict__ scores, float* __restrict__ tfs,
                     int R, int T, int nq, int Q, int log2h, int q_run) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = 1 << log2h;
  const unsigned mask = (unsigned)H - 1;
  int2* s_tab = reinterpret_cast<int2*>(smem);  // (key, weight bits)
  int* s_qid = reinterpret_cast<int*>(s_tab + (size_t)H * kRows);
  float* s_qc = reinterpret_cast<float*>(s_qid + kQueries * QM);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + lane;
  const bool row_ok = row < R;
  const int rows_here = min(kRows, R - r0);

  // Build. Thread i takes position i >> 5 of row i & 31, so a warp's
  // inserts land in 32 rows' tables, one bank each. A first pass finds
  // whether every id lies in [0, H): then the slot is the id itself
  // (direct), a perfect hash; else multiplicative hashing.
  bool wide = false, neg = false;
  for (int i = threadIdx.x; i < H * kRows; i += kThreads)
    s_tab[i] = make_int2(kDocPad, 0);
  for (int i = threadIdx.x; i < kRows * T; i += kThreads) {
    const int d = i & (kRows - 1);
    if (d >= rows_here) continue;
    const int id = __ldg(ids + (long long)(r0 + d) * T + (i >> 5));
    wide |= id != kDocPad && (unsigned)id >= (unsigned)H;
    neg |= id < kDocPad;
  }
  const bool direct = !__syncthreads_or(wide);
  const bool probe_neg = __syncthreads_or(neg);
  for (int i = threadIdx.x; i < kRows * T; i += kThreads) {
    const int d = i & (kRows - 1);
    if (d >= rows_here) continue;
    const long long g = (long long)(r0 + d) * T + (i >> 5);
    const int id = __ldg(ids + g);
    if (id == kDocPad) continue;
    const int wbits = __float_as_int(__fadd_rn(0.0f, __ldg(w + g)));
    for (unsigned s = direct ? (unsigned)id : slot_of(id, log2h);;
         s = (s + 1) & mask) {
      int2* e = s_tab + s * kRows + d;
      const int prev = atomicCAS(&e->x, kDocPad, id);
      if (prev == kDocPad) {
        e->y = wbits;
        break;
      }
      if (prev == id) break;  // a repeated id: outside the contract
    }
  }

  const int2* tab = s_tab + lane;
  const long long roff = row_ok ? (long long)row * T : 0;
  const int q_end = min(nq, (int)blockIdx.y * q_run + q_run);
  const int n_chunks = Q > QM ? (Q + QM - 1) / QM : 1;
  for (int q0 = blockIdx.y * q_run; q0 < q_end; q0 += kQueries) {
    const int nt = min(kQueries, q_end - q0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j0 = ch * QM;
      const int qn = min(QM, Q - j0);  // 0 when Q == 0
      __syncthreads();  // the table is built; the last tile is read
      const bool pads = __syncthreads_or(
          stage_queries<QM>(qids, qcnt, s_qid, s_qc, q0, nt, Q, j0, qn));
      for (int qq = warp; qq < nt; qq += kWarps) {
        int q[QM];
        float c[QM];
        const int4* qv = reinterpret_cast<const int4*>(s_qid + qq * QM);
        const float4* cv = reinterpret_cast<const float4*>(s_qc + qq * QM);
#pragma unroll
        for (int v = 0; v < QM / 4; ++v) {
          const int4 a = qv[v];
          const float4 b = cv[v];
          q[4 * v] = a.x;
          q[4 * v + 1] = a.y;
          q[4 * v + 2] = a.z;
          q[4 * v + 3] = a.w;
          c[4 * v] = b.x;
          c[4 * v + 1] = b.y;
          c[4 * v + 2] = b.z;
          c[4 * v + 3] = b.w;
        }
        const long long o = (long long)(q0 + qq) * R + row;
        float acc = (ch && row_ok) ? scores[o] : 0.0f;
        int matches = 0;
        if (pads)  // block-uniform
          score_query_pads(tab, s_qid + qq * QM, s_qc + qq * QM, qn, mask,
                           log2h, direct, ids + roff, w + roff, T, row_ok,
                           acc, matches);
        else if (direct)
          score_query<QM, true>(tab, q, c, qn, mask, log2h, probe_neg, acc,
                                matches);
        else
          score_query<QM, false>(tab, q, c, qn, mask, log2h, probe_neg, acc,
                                 matches);
        if (row_ok) {
          scores[o] = acc;
          tfs[o] = (ch ? tfs[o] : 0.0f) + (float)matches;
        }
      }
    }
  }
}

template <int QM>
__global__ void __launch_bounds__(kThreads)
    bm25_scan_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                     const int* __restrict__ qids,
                     const float* __restrict__ qcnt,
                     float* __restrict__ scores, float* __restrict__ tfs,
                     int R, int T, int nq, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_qid = reinterpret_cast<int*>(smem);
  float* s_qc = reinterpret_cast<float*>(s_qid + kQueries * QM);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRows + lane;
  const bool row_ok = row < R;
  const int q0 = blockIdx.y * kQueries;
  const int nt = min(kQueries, nq - q0);
  const long long roff = row_ok ? (long long)row * T : 0;
  const int* rid = ids + roff;
  const float* rw = w + roff;

  const int n_chunks = Q > QM ? (Q + QM - 1) / QM : 1;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int j0 = ch * QM;
    const int qn = min(QM, Q - j0);
    __syncthreads();
    stage_queries<QM>(qids, qcnt, s_qid, s_qc, q0, nt, Q, j0, qn);
    __syncthreads();
    for (int qq = warp; qq < nt; qq += kWarps) {
      int q[QM];
#pragma unroll
      for (int j = 0; j < QM; ++j) q[j] = s_qid[qq * QM + j];
      const int bound = row_ok ? T : 0;
      float s[QM];
#pragma unroll
      for (int j = 0; j < QM; ++j) s[j] = 0.0f;
      int matches = 0;
      for (int t = 0; t < bound; ++t) {
        const int id = __ldg(rid + t);
        const float wt = __ldg(rw + t);
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          const bool m = j < qn && id == q[j];
          s[j] = m ? s[j] + wt : s[j];
          matches += m;
        }
      }
      if (!row_ok) continue;
      const long long o = (long long)(q0 + qq) * R + row;
      float acc = ch ? scores[o] : 0.0f;
#pragma unroll
      for (int j = 0; j < QM; ++j)
        if (j < qn) acc = fmaf(s_qc[qq * QM + j], s[j], acc);
      scores[o] = acc;
      tfs[o] = (ch ? tfs[o] : 0.0f) + (float)matches;
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int QM>
int launch(const int* ids, const float* w, const int* qids, const float* qcnt,
           float* scores, float* tfs, int R, int T, int nq, int Q,
           cudaStream_t stream) {
  const int row_tiles = (R + kRows - 1) / kRows;
  const int q_tiles = (nq + kQueries - 1) / kQueries;
  if (T > kHashMaxT) {
    const size_t bytes = query_smem<QM>();
    int e = allow_smem(bm25_scan_kernel<QM>, bytes);
    if (e) return e;
    bm25_scan_kernel<QM><<<dim3(row_tiles, q_tiles), kThreads, bytes,
                           stream>>>(ids, w, qids, qcnt, scores, tfs, R, T,
                                     nq, Q);
    return (int)cudaGetLastError();
  }
  const int log2h = log2_slots(T);
  const size_t bytes = ((size_t)kRows << log2h) * sizeof(int2) +
                       query_smem<QM>();
  auto kernel = bm25_hash_kernel<QM>;
  int e = allow_smem(kernel, bytes);
  if (e) return e;
  // Query runs as long as leaves ~kWaves waves of blocks: enough blocks to
  // even out the last wave, few re-reads of the table.
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = (int)cudaGetDevice(&dev)) ||
      (e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) ||
      (e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, bytes)))
    return e;
  const long long want = (long long)kWaves * sms * (per_sm > 0 ? per_sm : 1);
  long long splits = (want + row_tiles - 1) / row_tiles;
  splits = splits < 1 ? 1 : (splits > q_tiles ? q_tiles : splits);
  const int run_tiles = (int)((q_tiles + splits - 1) / splits);
  const int n_runs = (q_tiles + run_tiles - 1) / run_tiles;
  kernel<<<dim3(row_tiles, n_runs), kThreads, bytes, stream>>>(
      ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, log2h,
      run_tiles * kQueries);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bb25_bm25_compare(const int* ids, const float* w,
                                 const int* qids, const float* qcnt,
                                 float* scores, float* tfs, int R, int T,
                                 int nq, int Q, void* stream) {
  if (R <= 0 || nq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 4) return launch<4>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
  if (Q <= 8) return launch<8>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
  if (Q <= 16)
    return launch<16>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
  return launch<32>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
}
