// K1 block_max: per-row maxima over contiguous column blocks.
//
// Replaces bayesian_bm25_tpu/engine/pallas_reduce.py (_bmax_kernel and
// _bmax2d_kernel, launched through _block_max_call / block_max).
//
// out[r, g] = max(x[r, g*block : (g+1)*block]), where columns at or past
// valid_upto count as -inf. -inf inputs are legal; inputs hold no NaN.
// max is exact and order-free, so the result is bit-identical to
// torch.amax over the reshaped (nq, G, block) view after the same mask.
//
// Bound: bytes read. At the main path's (8192, 51200) f32 score matrix the
// kernel reads 1.68 GB once and writes 6.5 MB; nothing is reused, so it
// runs at device-memory bandwidth or not at all. Design: one warp per
// (row, block); the 32 lanes read 32 neighbouring floats per step (one
// 128-byte transaction), fold them in registers, and finish with five
// shuffles. The validity mask is a compare in registers, so a padded
// matrix never needs a masked copy.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void block_max_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int nq, int d,
                                 int block, int valid_upto) {
  const int g = d / block;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)nq * g) return;  // whole warp leaves together
  const long long row = warp / g;
  const int c0 = (int)(warp % g) * block;
  const float* p = x + row * d + c0;
  float m = -INFINITY;
  for (int c = lane; c < block; c += 32) {
    const float v = c0 + c < valid_upto ? __ldg(p + c) : -INFINITY;
    m = fmaxf(m, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[warp] = m;
}

}  // namespace

extern "C" int bb25_block_max(const float* x, float* out, int nq, int d,
                              int block, int valid_upto, void* stream) {
  const long long warps = (long long)nq * (d / block);
  if (warps > 0) {
    const unsigned grid =
        (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    block_max_kernel<<<grid, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(x, out, nq, d, block,
                                               valid_upto);
  }
  return (int)cudaGetLastError();
}
