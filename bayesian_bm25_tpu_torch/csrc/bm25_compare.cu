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
// order, acc = fmaf(c_j, s_j, acc), with s_j the row's matched weight. Doc
// rows hold unique ids, so s_j has at most one nonzero term and is exact;
// XLA contracts acc + c_j * s_j into one FMA, so the result is bit-equal
// to the JAX package. Pads never match (DOC_PAD -1, QUERY_PAD -2).
//
// Bound: compares. With only the rows' real ids counted, the work is
// nq * nnz(ids) * Q compare-and-selects; at (8192 queries, a 51200 x 128
// doc-major table, Q = 8) that is far above the bytes (the table once,
// both outputs once: 3.4 GB, ~1.0 ms at 3.35 TB/s).
//
// Design. The TPU kernel prefetched query scalars into SMEM, accumulated
// across a sequential term-block grid and capped chunks at 512 queries.
// Here one block owns 32 table rows (one per lane) and 128 queries (16 per
// warp). It stages the rows' (32 x T) ids and weights in shared memory once
// (a stride of T | 1 words keeps lanes on distinct banks), so one read of
// the table serves 128 queries, and stages its queries' ids and counts in
// shared memory. Each warp walks its queries one at a time; each lane scans
// its row over T with the query's ids in registers and writes its output
// once: lanes are consecutive rows, so the store is coalesced. There are no
// atomics. A row's trailing DOC_PAD run is skipped unless the query itself
// holds a -1 id, which is the only id it could match. Query slots run in
// chunks of QM (8, 16 or 32) ids in registers; the rare Q > 32 carries the
// sum through the output between chunks, in the same j order. Rows wider
// than the shared-memory budget are read from global memory instead.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // table rows per block: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = 128;  // queries per block, 16 per warp
constexpr int kDocPad = -1;
constexpr int kMaxSmem = 200 * 1024;

__host__ __device__ inline int row_stride(int t) { return t | 1; }

template <int QM>
__host__ __device__ inline size_t query_smem() {
  return (size_t)kQueries * QM * (sizeof(int) + sizeof(float)) +
         kRows * sizeof(int);
}

template <int QM, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    bm25_compare_kernel(const int* __restrict__ ids,
                        const float* __restrict__ w,
                        const int* __restrict__ qids,
                        const float* __restrict__ qcnt,
                        float* __restrict__ scores, float* __restrict__ tfs,
                        int R, int T, int nq, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_qid = reinterpret_cast<int*>(smem);
  float* s_qc = reinterpret_cast<float*>(s_qid + kQueries * QM);
  int* s_len = reinterpret_cast<int*>(s_qc + kQueries * QM);
  int* s_id = s_len + kRows;
  const int ld = row_stride(T);
  float* s_w = reinterpret_cast<float*>(s_id + kRows * ld);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kRows;
  const int q0 = blockIdx.y * kQueries;
  const int row = r0 + lane;
  const bool row_ok = row < R;

  const int* rid;
  const float* rw;
  if (STAGED) {
    // The block's rows are one contiguous run of the table.
    const long long base = (long long)r0 * T;
    const int n = kRows * T;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int d = i / T;
      const int t = i - d * T;
      const bool ok = r0 + d < R;
      s_id[d * ld + t] = ok ? __ldg(ids + base + i) : kDocPad;
      s_w[d * ld + t] = ok ? __ldg(w + base + i) : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < kRows) {
      int len = T;
      const int* r = s_id + threadIdx.x * ld;
      while (len > 0 && r[len - 1] == kDocPad) --len;
      s_len[threadIdx.x] = len;
    }
    rid = s_id + lane * ld;
    rw = s_w + lane * ld;
  } else {
    const long long off = row_ok ? (long long)row * T : 0;
    rid = ids + off;
    rw = w + off;
  }

  const int n_chunks = Q > QM ? (Q + QM - 1) / QM : 1;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int j0 = ch * QM;
    const int qn = min(QM, Q - j0);  // 0 when Q == 0
    __syncthreads();  // previous chunk's query slots are no longer read
    for (int i = threadIdx.x; i < kQueries * QM; i += kThreads) {
      const int qq = i / QM;
      const int j = i - qq * QM;
      const bool ok = q0 + qq < nq && j < qn;
      const long long src = (long long)(q0 + qq) * Q + j0 + j;
      s_qid[i] = ok ? __ldg(qids + src) : 0;
      s_qc[i] = ok ? __ldg(qcnt + src) : 0.0f;
    }
    __syncthreads();

    for (int qq = warp; qq < kQueries; qq += kWarps) {
      const int qi = q0 + qq;
      if (qi >= nq) break;  // warp-uniform
      int q[QM];
      bool has_pad_id = false;
#pragma unroll
      for (int j = 0; j < QM; ++j) {
        q[j] = s_qid[qq * QM + j];
        has_pad_id |= j < qn && q[j] == kDocPad;
      }
      int bound = 0;
      if (row_ok) bound = (STAGED && !has_pad_id) ? s_len[lane] : T;
      float s[QM];
#pragma unroll
      for (int j = 0; j < QM; ++j) s[j] = 0.0f;
      int matches = 0;
      for (int t = 0; t < bound; ++t) {
        const int id = rid[t];
        const float wt = rw[t];
#pragma unroll
        for (int j = 0; j < QM; ++j) {
          const bool m = j < qn && id == q[j];
          s[j] = m ? s[j] + wt : s[j];
          matches += m;
        }
      }
      if (!row_ok) continue;
      const long long o = (long long)qi * R + row;
      float acc = ch ? scores[o] : 0.0f;
#pragma unroll
      for (int j = 0; j < QM; ++j)
        if (j < qn) acc = fmaf(s_qc[qq * QM + j], s[j], acc);
      scores[o] = acc;
      tfs[o] = (ch ? tfs[o] : 0.0f) + (float)matches;
    }
  }
}

template <int QM>
int launch(const int* ids, const float* w, const int* qids, const float* qcnt,
           float* scores, float* tfs, int R, int T, int nq, int Q,
           cudaStream_t stream) {
  const size_t slab = (size_t)kRows * row_stride(T) * (sizeof(int) + sizeof(float));
  const bool staged = query_smem<QM>() + slab <= (size_t)kMaxSmem;
  const size_t bytes = query_smem<QM>() + (staged ? slab : 0);
  auto kernel = staged ? bm25_compare_kernel<QM, true>
                       : bm25_compare_kernel<QM, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((R + kRows - 1) / kRows, (nq + kQueries - 1) / kQueries);
  kernel<<<grid, kThreads, bytes, stream>>>(ids, w, qids, qcnt, scores, tfs,
                                            R, T, nq, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bb25_bm25_compare(const int* ids, const float* w,
                                 const int* qids, const float* qcnt,
                                 float* scores, float* tfs, int R, int T,
                                 int nq, int Q, void* stream) {
  if (R <= 0 || nq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 8) return launch<8>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
  if (Q <= 16)
    return launch<16>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
  return launch<32>(ids, w, qids, qcnt, scores, tfs, R, T, nq, Q, s);
}
