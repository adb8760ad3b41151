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
// Bound: bytes. The function reads each row once and writes k pairs; at
// the main path's shapes ((8192, 200), (8192, 2560) and (nt, cand_cap),
// k = 10) that is ~0.03 ms at 3.35 TB/s.
//
// Design, k <= kWarpKMax (32): one warp per row, 8 rows per block. Each
// lane reads its strided elements once (float4 when C % 4 == 0, so a warp
// load is 512 contiguous bytes) and keeps its own best KM (4, 10, 16 or
// 32, the smallest >= k) in registers, sorted. After each stretch of 16
// elements a lane the warp sorts its 32 heads (bitonic, by shuffles): the
// k-th largest is a lower bound on the row's k-th best, and an element
// below it is not admitted. Without it nearly every element step of a
// wide row inserts in some lane, and the warp pays for the insertion.
// Values are compared as order-preserving unsigned keys (-0 taken as +0,
// as a float compare does); "none" is key 0 at index INT_MAX, which loses
// to every real entry, -inf (key 0x007fffff) included. A lane meets its
// elements in ascending index order, so a strict > on the key keeps the
// lower index of a tie. Then k rounds of a warp arg-best over the lanes'
// heads (five __shfl_xor_sync steps on (key, index)); the winning lane
// pops its head and lane j keeps the j-th winner. One read of the row, no
// shared memory and no __syncthreads; the output value is read back from
// the row, so it keeps its own bits.
//
// k > kWarpKMax: one thread block per row, k rounds of a block-wide
// arg-max over (value desc, index asc), as the TPU kernel's k rounds of
// masked max and first-occurrence arg-min do. The taken mask is the
// (value, index) watermark of the previous pick: an entry is taken iff it
// sorts at or before the watermark, so the mask needs no storage and the
// kernel takes any row width C and any k <= C. The row is read k times
// (from L1 after the first) and the block synchronises twice a round.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kWarpKMax = 32;  // largest k of the warp kernel
constexpr int kRowsPerBlock = 8;
constexpr int kUnroll = 4;     // loads in flight per lane
constexpr int kMaxThreads = 256;

__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Insert (key, idx) into the sorted list; the caller has checked that it
// beats the last entry.
template <int KM>
__device__ __forceinline__ void push(unsigned (&kl)[KM], int (&il)[KM],
                                     unsigned key, int idx) {
  bool above = true;  // key > kl[s], known for s = KM - 1
#pragma unroll
  for (int s = KM - 1; s > 0; --s) {
    const bool above_prev = key > kl[s - 1];
    kl[s] = above_prev ? kl[s - 1] : (above ? key : kl[s]);
    il[s] = above_prev ? il[s - 1] : (above ? idx : il[s]);
    above = above_prev;
  }
  if (above) {
    kl[0] = key;
    il[0] = idx;
  }
}

// Offer one element. thr is a lower bound on the key of the row's k-th
// best entry (k entries of the row sort at or above it), so an element
// below it cannot be in the top k.
template <int KM>
__device__ __forceinline__ void offer(unsigned (&kl)[KM], int (&il)[KM],
                                      unsigned thr, float v, int idx) {
  const unsigned key = order_key(v);
  if (key > kl[KM - 1] && key >= thr) push(kl, il, key, idx);
}

// The k-th largest of the 32 lanes' heads (descending bitonic sort across
// the warp), a lower bound on the row's k-th best key: k distinct entries
// reach it. Lanes without a real entry hold key 0, so the bound is then 0.
__device__ __forceinline__ unsigned warp_kth_head(unsigned head, int k,
                                                  int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned o = __shfl_xor_sync(0xffffffffu, head, stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      head = keep_max ? max(head, o) : min(head, o);
    }
  }
  return __shfl_sync(0xffffffffu, head, k - 1);
}

template <int KM>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    topk_warp_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ pos, int nq, int c, int k) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= nq) return;  // warp-uniform
  const float* row = x + (long long)r * c;
  unsigned kl[KM];
  int il[KM];
#pragma unroll
  for (int s = 0; s < KM; ++s) {
    kl[s] = 0u;
    il[s] = INT_MAX;
  }

  // Strides of 32 * kUnroll vectors (or elements), warp-uniform; after
  // each stretch but the last the warp raises its admission threshold.
  unsigned thr = 0u;
  if ((c & 3) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int c4 = c >> 2;
    for (int b = 0; b < c4; b += 32 * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j4 = b + 32 * u + lane;
        if (j4 < c4) v[u] = __ldg(row4 + j4);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j4 = b + 32 * u + lane;
        if (j4 < c4) {
          offer(kl, il, thr, v[u].x, 4 * j4);
          offer(kl, il, thr, v[u].y, 4 * j4 + 1);
          offer(kl, il, thr, v[u].z, 4 * j4 + 2);
          offer(kl, il, thr, v[u].w, 4 * j4 + 3);
        }
      }
      if (b + 32 * kUnroll < c4) thr = warp_kth_head(kl[0], k, lane);
    }
  } else {
    for (int b = 0; b < c; b += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = b + 32 * u + lane;
        if (j < c) v[u] = __ldg(row + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = b + 32 * u + lane;
        if (j < c) offer(kl, il, thr, v[u], j);
      }
      if (b + 32 * kUnroll < c) thr = warp_kth_head(kl[0], k, lane);
    }
  }

  // Merge: each of the row's top k entries was admitted and has at most
  // k - 1 entries above it in its lane, so the lists hold all k; every
  // round's winner is real and its index names one lane.
  int mine = 0;
  for (int round = 0; round < k; ++round) {
    unsigned bk = kl[0];
    int bi = il[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ok > bk || (ok == bk && oi < bi)) {
        bk = ok;
        bi = oi;
      }
    }
    if (lane == round) mine = bi;
    if (il[0] == bi) {
#pragma unroll
      for (int s = 0; s < KM - 1; ++s) {
        kl[s] = kl[s + 1];
        il[s] = il[s + 1];
      }
      kl[KM - 1] = 0u;
      il[KM - 1] = INT_MAX;
    }
  }
  if (lane < k) {
    vals[(long long)r * k + lane] = __ldg(row + mine);
    pos[(long long)r * k + lane] = mine;
  }
}

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

__global__ void topk_rounds_kernel(const float* __restrict__ x,
                                   float* __restrict__ vals,
                                   int* __restrict__ pos, int c, int k) {
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

template <int KM>
void launch_warp(const float* x, float* vals, int* pos, int nq, int c, int k,
                 cudaStream_t stream) {
  const int blocks = (nq + kRowsPerBlock - 1) / kRowsPerBlock;
  topk_warp_kernel<KM><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
      x, vals, pos, nq, c, k);
}

}  // namespace

extern "C" int bb25_topk(const float* x, float* vals, int* pos, int nq, int c,
                         int k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (nq <= 0 || k <= 0) return (int)cudaGetLastError();
  if (k <= 4) {
    launch_warp<4>(x, vals, pos, nq, c, k, s);
  } else if (k <= 10) {
    launch_warp<10>(x, vals, pos, nq, c, k, s);
  } else if (k <= 16) {
    launch_warp<16>(x, vals, pos, nq, c, k, s);
  } else if (k <= kWarpKMax) {
    launch_warp<kWarpKMax>(x, vals, pos, nq, c, k, s);
  } else {
    int threads = ((c + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                          : threads);
    topk_rounds_kernel<<<nq, threads, 0, s>>>(x, vals, pos, c, k);
  }
  return (int)cudaGetLastError();
}
