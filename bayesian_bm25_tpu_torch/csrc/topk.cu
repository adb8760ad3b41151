// K3 topk: exact row-wise top-k with lax.top_k's order.
//
// Replaces bayesian_bm25_tpu/engine/pallas_topk.py (_topk_kernel, launched
// through _topk_call / topk).
//
// vals[r, j], pos[r, j] is the j-th entry of row r in (value descending,
// index ascending) order: equal values come lowest index first, and a row
// with fewer than k finite entries steps through its -inf entries in index
// order, exactly as lax.top_k does. Inputs hold no NaN. torch.topk does
// not give this order, and the exactness proof of the blockwise leader
// selection depends on it.
//
// Bound: k passes over a row that stays in L1 after the first; at the main
// path's shapes ((8192, 200), (8192, 2560) and (nt, cand_cap) with k = 10)
// the kernel is latency-bound on k block-wide reductions per row, not on
// bytes. Design: one thread block per row, k rounds of a block-wide
// arg-max over (value desc, index asc), as the TPU kernel's k rounds of
// masked max and first-occurrence arg-min do. The taken mask is the
// (value, index) watermark of the previous pick: an entry is taken iff it
// sorts at or before the watermark, so the mask needs no storage and the
// kernel takes any row width C and any k <= C, with no C % 128 or k <= 64
// limit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void topk_kernel(const float* __restrict__ x,
                            float* __restrict__ vals, int* __restrict__ pos,
                            int c, int k) {
  __shared__ float s_v[kMaxThreads / 32];
  __shared__ int s_i[kMaxThreads / 32];
  __shared__ float pick_v;
  __shared__ int pick_i;
  const float* row = x + (long long)blockIdx.x * c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float wv = INFINITY;  // watermark: everything at or before it is taken
  int wi = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;  // "none": loses to every real entry, -inf included
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      const float v = __ldg(row + j);
      const bool untaken = v < wv || (v == wv && j > wi);
      if (untaken && better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      s_v[warp] = bv;
      s_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < n_warps ? s_v[lane] : -INFINITY;
      bi = lane < n_warps ? s_i[lane] : INT_MAX;
      warp_best(bv, bi);
      if (lane == 0) {
        pick_v = bv;
        pick_i = bi;
        vals[(long long)blockIdx.x * k + r] = bv;
        pos[(long long)blockIdx.x * k + r] = bi;
      }
    }
    __syncthreads();
    wv = pick_v;
    wi = pick_i;
  }
}

}  // namespace

extern "C" int bb25_topk(const float* x, float* vals, int* pos, int nq, int c,
                         int k, void* stream) {
  if (nq > 0 && k > 0) {
    int threads = ((c + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                          : threads);
    topk_kernel<<<nq, threads, 0, (cudaStream_t)stream>>>(x, vals, pos, c,
                                                          k);
  }
  return (int)cudaGetLastError();
}
