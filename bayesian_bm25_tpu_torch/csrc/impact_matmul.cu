// K4 impact_matmul_bmax: the frequent-term scoring product with the
// leader-selection block maxima computed in the same pass.
//
// Replaces bayesian_bm25_tpu/engine/pallas_matmul.py (_kernel_pair :69,
// _kernel_int8 :79 and _kernel_single :93, launched through _call :102 /
// impact_matmul_bmax :149).
//
//   scores[r, d] = int8: fma(hidot, s0[d], lodot * s1[d])
//                  pair: hidot + lodot    (each summed on its own)
//                  single: hidot
//   hidot = sum_k q[r, k] * hi[d, k], lodot likewise over lo
//   bmax[r, g]   = max over d in [256 g, 256 g + 256), d < n_docs, of
//                  scores[r, d]; -inf where no column of the block is valid
//
// Scores are raw (pad columns included); only the maxima are masked.
// Exactness: int8 dots are integer sums (exact in any order) and the
// epilogue is written with explicit intrinsics, __fmaf_rn(hi, s0,
// __fmul_rn(lo, s1)), the rounding of the unfused route's
// lo.mul_(s1).addcmul_(hi, s0): nvcc contracts a*b + c*d into an FMA of
// its own choosing otherwise. The bf16 modes sum the nonzero terms of
// each dot in ascending k with __fmaf_rn, then add hi and lo once; a
// count times a bf16 value is exact in float32, so only the order of the
// few nonzero terms can round differently from a library product. The
// maxima reduce the very values written to scores.
//
// Bound: bytes. At the main path's (8192, 2048) x (51200, 2048) the
// function must read q (67 MB) and the int8 pair (210 MB; the bf16 pair
// 420 MB) and write the scores (1.68 GB) and maxima (6.6 MB): about
// 0.59 ms (int8) or 0.65 ms (hilo) at 3.35 TB/s. The query rows are
// counts of at most a query's frequent terms: at 8 tokens per query over
// 2,048 columns, >= 99% of q is zero, so the operations these inputs
// need (~2 * nnz(q) * D * passes ~ 1e10) are far below the bytes, and a
// dense product would do hundreds of times that work.
//
// Design: a score row is a weighted sum of the few impact columns its
// query touches, so the product reads the impact matrices column-major.
// A first kernel transposes each (D, K) matrix into a (K, D) scratch
// copy (32 x 32 tiles through shared memory). In the product, one warp
// owns 4 query rows over a run of 256-doc blocks: it compacts each row's
// nonzero (column, count) pairs into shared memory once (ballot and
// prefix count, ascending column), then streams the docs 128 at a time,
// 4 per lane. For each nonzero it reads the 128 docs' entries of that
// impact column as one coalesced 128-byte (int8) or 256-byte (bf16) load,
// so each impact byte a query needs is read once for it and no zero term
// is ever added. Scores leave as float4 stores; the maximum of each
// 256-doc block is a per-lane running max and one warp shuffle
// reduction: no block barrier, no atomics, no second pass. A row with
// more than kCap nonzeros is summed straight from q instead, in the same
// ascending order. The TPU kernel's transposed (8, RQ) maxima layout
// existed only for the TPU's (8, 128) block rule and is not carried
// over. Not done: keeping the transposed copy across calls, tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBlock = 256;    // doc columns per maximum
constexpr int kWarps = 8;      // warps per thread block
constexpr int kRowsPerWarp = 4;
constexpr int kCap = 64;       // nonzeros per row kept in shared memory
constexpr int kTile = 32;      // transpose tile

enum Mode { kInt8 = 0, kPair = 1, kSingle = 2 };

// (D, K) -> (K, D) for 1- or 2-byte elements.
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 int D, int K) {
  __shared__ T tile[kTile][kTile + 1];
  const int k0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kTile;
  for (int i = threadIdx.y; i < kTile; i += blockDim.y) {
    const int d = d0 + i, k = k0 + threadIdx.x;
    if (d < D && k < K) tile[i][threadIdx.x] = in[(size_t)d * K + k];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += blockDim.y) {
    const int k = k0 + i, d = d0 + threadIdx.x;
    if (d < D && k < K) out[(size_t)k * D + d] = tile[threadIdx.x][i];
  }
}

__device__ __forceinline__ float bf16_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

// Four consecutive entries of one impact column, widened.
template <int MODE>
struct Four;
template <>
struct Four<kInt8> {
  int v[4];
  __device__ __forceinline__ void load(const unsigned char* col, int d) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(col + d));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<int>(static_cast<signed char>((w >> (8 * i)) & 0xffu));
  }
};
template <int MODE>
struct Four {
  float v[4];
  __device__ __forceinline__ void load(const unsigned char* col, int d) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(col + 2 * d));
    v[0] = bf16_to_float(w.x & 0xffffu);
    v[1] = bf16_to_float(w.x >> 16);
    v[2] = bf16_to_float(w.y & 0xffffu);
    v[3] = bf16_to_float(w.y >> 16);
  }
};

template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
impact_matmul_bmax_kernel(const float* __restrict__ q,
                          const unsigned char* __restrict__ hi_t,
                          const unsigned char* __restrict__ lo_t,
                          const float* __restrict__ scale,
                          float* __restrict__ scores,
                          float* __restrict__ bmax, int nq, int K, int ldq,
                          int D, int n_docs, int blocks_per_run) {
  using Acc = typename std::conditional<MODE == kInt8, int, float>::type;
  constexpr size_t kEs = MODE == kInt8 ? 1 : 2;
  constexpr bool kTwo = MODE != kSingle;
  __shared__ int s_col[kWarps][kRowsPerWarp][kCap];
  __shared__ float s_val[kWarps][kRowsPerWarp][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  if (r0 >= nq) return;  // no rows for this warp; no block barrier follows
  const int G = D / kBlock;
  const int g_begin = blockIdx.y * blocks_per_run;
  const int g_end = min(G, g_begin + blocks_per_run);
  const int nchunks = (K + 31) / 32;
  const unsigned below = (1u << lane) - 1u;

  // Compact each row's nonzeros, ascending column.
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = r0 + j;
    int n = 0;
#pragma unroll 4
    for (int c = 0; c < nchunks; ++c) {
      const int k = c * 32 + lane;
      const float v = (r < nq && k < K) ? __ldg(q + (size_t)r * ldq + k) : 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, v != 0.0f);
      const int pos = n + __popc(m & below);
      if (v != 0.0f && pos < kCap) {
        s_col[warp][j][pos] = k;
        s_val[warp][j][pos] = v;
      }
      n += __popc(m);
    }
    cnt[j] = n;
  }
  __syncwarp();

  const size_t col_bytes = (size_t)D * kEs;
  float run_max[kRowsPerWarp];
  for (int d0 = g_begin * kBlock; d0 < g_end * kBlock; d0 += 128) {
    const int d = d0 + 4 * lane;
    Acc acc_hi[kRowsPerWarp][4];
    Acc acc_lo[kRowsPerWarp][4];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_hi[j][i] = 0;
        acc_lo[j][i] = 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      // One term: count v times impact column k at this lane's 4 docs.
      auto add = [&](int k, float v) {
        Four<MODE> h, l;
        h.load(hi_t + (size_t)k * col_bytes, d);
        if constexpr (kTwo) l.load(lo_t + (size_t)k * col_bytes, d);
        if constexpr (MODE == kInt8) {
          const int vi = __float2int_rz(v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_hi[j][i] += vi * h.v[i];
            acc_lo[j][i] += vi * l.v[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_hi[j][i] = __fmaf_rn(v, h.v[i], acc_hi[j][i]);
            if constexpr (kTwo)
              acc_lo[j][i] = __fmaf_rn(v, l.v[i], acc_lo[j][i]);
          }
        }
      };
      if (cnt[j] <= kCap) {
#pragma unroll 4
        for (int t = 0; t < cnt[j]; ++t) add(s_col[warp][j][t], s_val[warp][j][t]);
      } else {
        // A dense row: walk q itself, 32 columns per ballot.
        const int r = r0 + j;
        for (int c = 0; c < nchunks; ++c) {
          const int k = c * 32 + lane;
          const float v = k < K ? __ldg(q + (size_t)r * ldq + k) : 0.0f;
          unsigned m = __ballot_sync(0xffffffffu, v != 0.0f);
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            add(c * 32 + b, __shfl_sync(0xffffffffu, v, b));
          }
        }
      }
    }

    // Epilogue: scores as float4, the running maxima, and each 256-doc
    // block's maximum after its second step.
    float s0v[4] = {0.f, 0.f, 0.f, 0.f}, s1v[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE == kInt8) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + d));
      const float4 b = __ldg(reinterpret_cast<const float4*>(scale + D + d));
      s0v[0] = a.x; s0v[1] = a.y; s0v[2] = a.z; s0v[3] = a.w;
      s1v[0] = b.x; s1v[1] = b.y; s1v[2] = b.z; s1v[3] = b.w;
    }
    const bool first_half = ((d0 / 128) & 1) == 0;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      float out[4];
      float m = first_half ? -INFINITY : run_max[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (MODE == kInt8) {
          out[i] = __fmaf_rn(__int2float_rn(acc_hi[j][i]), s0v[i],
                             __fmul_rn(__int2float_rn(acc_lo[j][i]), s1v[i]));
        } else if constexpr (MODE == kPair) {
          out[i] = __fadd_rn(acc_hi[j][i], acc_lo[j][i]);
        } else {
          out[i] = acc_hi[j][i];
        }
        if (d + i < n_docs) m = fmaxf(m, out[i]);
      }
      const int r = r0 + j;
      if (r < nq)
        *reinterpret_cast<float4*>(scores + (size_t)r * D + d) =
            make_float4(out[0], out[1], out[2], out[3]);
      run_max[j] = m;
      if (!first_half) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0 && r < nq) bmax[(size_t)r * G + d0 / kBlock] = m;
      }
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <typename T>
void transpose(const void* in, void* out, int D, int K, cudaStream_t stream) {
  const dim3 grid((K + kTile - 1) / kTile, (D + kTile - 1) / kTile);
  transpose_kernel<T><<<grid, dim3(kTile, 8), 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), D, K);
}

template <int MODE>
int launch(const float* q, const void* hi, const void* lo,
           const float* scale, float* scores, float* bmax, void* scratch,
           int nq, int K, int ldq, int D, int n_docs, cudaStream_t stream) {
  const int G = D / kBlock;
  if (nq <= 0 || G <= 0) return (int)cudaGetLastError();
  using T = typename std::conditional<MODE == kInt8, uint8_t, uint16_t>::type;
  T* hi_t = static_cast<T*>(scratch);
  T* lo_t = hi_t + (size_t)K * D;
  transpose<T>(hi, hi_t, D, K, stream);
  if (MODE != kSingle) transpose<T>(lo, lo_t, D, K, stream);
  const int rows_per_block = kWarps * kRowsPerWarp;
  const int tiles = (nq + rows_per_block - 1) / rows_per_block;
  // Split the doc blocks into runs so that about eight thread blocks per
  // SM are in flight; a run amortises its rows' compaction.
  int runs = (8 * sm_count() + tiles - 1) / tiles;
  runs = std::max(1, std::min(runs, G));
  const int per = (G + runs - 1) / runs;
  runs = (G + per - 1) / per;
  impact_matmul_bmax_kernel<MODE><<<dim3(tiles, runs), kWarps * 32, 0, stream>>>(
      q, reinterpret_cast<const unsigned char*>(hi_t),
      reinterpret_cast<const unsigned char*>(lo_t), scale, scores, bmax, nq,
      K, ldq, D, n_docs, per);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 int8 pair (scale is (2, D) float), 1 bf16 pair, 2 single bf16.
// q (nq, K) float32 with row stride ldq >= K; hi, lo (D, K) row-major;
// scores (nq, D); bmax (nq, D / 256); scratch takes the transposed
// matrices, 2 (pairs) or 1 (single) times K * D elements. D must be a
// multiple of 256; n_docs in [0, D].
extern "C" int bb25_impact_matmul_bmax(const float* q, const void* hi,
                                       const void* lo, const float* scale,
                                       float* scores, float* bmax,
                                       void* scratch, int mode, int nq, int K,
                                       int ldq, int D, int n_docs,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kInt8:
      return launch<kInt8>(q, hi, lo, scale, scores, bmax, scratch, nq, K,
                           ldq, D, n_docs, s);
    case kPair:
      return launch<kPair>(q, hi, lo, scale, scores, bmax, scratch, nq, K,
                           ldq, D, n_docs, s);
    case kSingle:
      return launch<kSingle>(q, hi, lo, scale, scores, bmax, scratch, nq, K,
                             ldq, D, n_docs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
