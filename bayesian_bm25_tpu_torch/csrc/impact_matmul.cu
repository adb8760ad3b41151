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
//   hidot = sum_k q[r, k] * hi[k, d], lodot likewise over lo, with the
//           counts q taken in int8 (int8 storage) or bf16 (the bf16
//           modes), as the JAX package casts them
//   bmax[r, g]   = max over d in [256 g, 256 g + 256), d < n_docs, of
//                  scores[r, d]; -inf where no column of the block is valid
//
// Scores are raw (pad columns included); only the maxima are masked.
//
// Bound: bytes, and the score write dominates them. At the main path's
// (8192, 2048) x (2048, 51200) the function reads q (67 MB) and the int8
// pair (210 MB; the bf16 pair 420 MB) and writes the scores (1.68 GB):
// 0.59 ms (int8) or 0.65 ms (hilo) at 3.35 TB/s; at the 1M chunk,
// (1024, 1024) x (1024, 1,001,472), 6.17 GB and 1.84 ms.
//
// Operands: the impact matrices come column-major, (K, D), the copy the
// split index keeps beside its row-major matrices
// (SplitBM25Index.impact_columns), so no call transposes them. A query
// row touches a handful of the K frequent columns (5.7 of 2,048 at the
// 50k bench, 5.6 of 1,024 at 1M), but a tile of 64 rows touches the
// union of theirs: ~123 columns at 50k and ~112 at 1M, spread over
// nearly every 64-column chunk of K. Skipping empty chunks would save
// ~15% of a dense product; compacting the tile's columns cuts the work
// to 64 x |U| per doc (int8) or to each row's own nonzeros (bf16), so
// the operations no longer bound the kernel.
//
// Design, two launches:
//  1. compact_kernel, one block per tile of 64 query rows: the union U
//     of the tile's nonzero columns, ascending (a ballot per 32 columns,
//     then a block scan), and the compacted counts q'[64, |U|] in int8 or
//     bf16, padded with zeros to slices of 128 columns; pad columns carry
//     id -1.
//  2. The product, grid (tiles, runs of kRun 256-doc blocks), 8 warps,
//     two blocks per SM. A block walks items of 128 docs and 128 columns
//     of U. cp.async brings an item's operands into shared memory while
//     the block multiplies the one before (the bf16 pair has room for one
//     stage: its copy starts after the product and overlaps the
//     epilogue): the U rows of the (K, D) pair for those docs, [k][doc],
//     each a contiguous run.
//     int8 (int8_kernel): on the tensor cores, mma.sync m16n8k32 s8 ->
//     s32, a 32 x 32 tile per warp. The int8 product takes K-major
//     operands only, so the rows are first transposed in shared memory
//     to [doc][k] with byte permutes, both tiles XOR-swizzled so that the
//     transpose and ldmatrix hit 32 distinct banks. The epilogue forms
//     __fmaf_rn(__int2float_rn(hi), s0, __fmul_rn(__int2float_rn(lo),
//     s1)), the rounding of the unfused lo.mul_(s1).addcmul_(hi, s0).
//     bf16 modes (bf16_kernel): on the CUDA cores, a warp per 8 query
//     rows and a lane per 4 docs. A row's nonzero columns in the slice
//     come from ballots over its compacted counts; for each, in
//     ascending column order, the lane reads 4 docs of that impact row
//     and adds count x impact with one fmaf each (the product of two
//     bf16 values is exact in float32), so a dot is the float32 sum of
//     its terms in column order, each addition rounded to nearest. The
//     tensor cores' bf16 product adds its terms in another order with
//     other roundings: 2 ulps from the plain version on hilo operands
//     of the path's sparsity with random impact values.
//     Both epilogues write the scores as streaming 16-byte stores and
//     keep each row's running maximum over the docs below n_docs.
//
// What bounds it (NVIDIA H100, PERF.md section 6): neither the bytes nor
// the operations. Taking out the score stores and the impact loads in
// turn left a fixed cost per item (barriers, epilogue instructions,
// staging) that two blocks an SM did not hide; copying the next item's
// operands during the product hides part of it. Short runs keep the
// blocks in flight on nearby docs, so the impact rows they share stay in
// L2; longer runs measured slower. The bf16 modes' CUDA-core product
// costs ~0.2 ms more at 50k than a tensor-core one; adding two or four
// rows' terms side by side, or a second stage for the pair (one block an
// SM), measured slower. Not done: wgmma and TMA, a tile of more query
// rows per block, staging the scores through shared memory.
//
// Exactness: int8 dots are exact integers and the epilogue is the
// unfused route's rounding, so int8 is bit-exact. The bf16 modes add
// exact terms in ascending column order, rounding each sum, as a
// float32 product that accumulates one k after another does. The maxima
// reduce the very values written to scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kBlock = 256;     // doc columns per maximum
constexpr int kRows = 64;       // query rows per tile
constexpr int kSlice = 128;     // compacted columns per slice
constexpr int kThreads = 256;   // 8 warps
constexpr int kCompactThreads = 256;
constexpr int kMaxWords = 1024; // bitmap words: K <= 32768
constexpr int kRun = 3;         // 256-doc blocks per thread block
constexpr int kDocs = 128;      // docs per item
constexpr int kParts = kBlock / kDocs;  // items per 256-doc block

enum Mode { kInt8 = 0, kPair = 1, kSingle = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The scratch the wrapper allocates, laid out per tile of kRows query
// rows: column ids (int32, a whole number of slices of kSlice), union
// sizes (int32, padded to 16 bytes), compacted counts (int8, or bf16 for
// the bf16 modes), [tile][slice][row][kSlice].
struct Scratch {
  size_t ucount, qc, bytes;
};

Scratch scratch_layout(int mode, int nq, int K) {
  const size_t tiles = (size_t)std::max(0, (nq + kRows - 1) / kRows);
  const size_t S = (size_t)std::max(0, (K + kSlice - 1) / kSlice);
  Scratch s;
  s.ucount = tiles * S * kSlice * 4;
  s.qc = s.ucount + (tiles * 4 + 15) / 16 * 16;
  s.bytes = s.qc + tiles * S * kRows * kSlice * (mode == kInt8 ? 1 : 2);
  return s;
}

// One block per tile of kRows query rows: the ascending union of the
// tile's nonzero columns into cols[tile][...] (-1 past |U|, up to a whole
// number of slices), |U| into ucount[tile], and the compacted counts into
// qc[tile][slice][row][kSlice] (zero for pads and rows >= nq).
template <typename T>
__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const float* __restrict__ q, int nq, int K, int ldq, int S,
               int* __restrict__ cols, int* __restrict__ ucount,
               T* __restrict__ qc) {
  __shared__ unsigned s_bits[kMaxWords];
  __shared__ int s_warp[kCompactThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int rows = min(kRows, nq - r0);
  int* tcols = cols + (size_t)tile * S * kSlice;
  const int nw = (K + 31) >> 5;
  for (int w = warp; w < nw; w += kCompactThreads / 32) {
    const int k = w * 32 + lane;
    bool nz = false;
    if (k < K) {
#pragma unroll 16
      for (int m = 0; m < rows; ++m)
        nz |= q[(size_t)(r0 + m) * ldq + k] != 0.0f;
    }
    const unsigned b = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) s_bits[w] = b;
  }
  __syncthreads();

  // Exclusive prefix of the words' populations: a run of words per
  // thread, a warp scan, then the warps' totals.
  const int wpt = (nw + kCompactThreads - 1) / kCompactThreads;
  const int w0 = min(nw, tid * wpt), w1 = min(nw, w0 + wpt);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(s_bits[w]);
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = 0, u = 0;
#pragma unroll
  for (int i = 0; i < kCompactThreads / 32; ++i) {
    if (i < warp) base += s_warp[i];
    u += s_warp[i];
  }
  int pos = base + incl - local;
  for (int w = w0; w < w1; ++w) {
    unsigned b = s_bits[w];
    while (b) {
      tcols[pos++] = w * 32 + __ffs(b) - 1;
      b &= b - 1;
    }
  }
  const int up = max(1, (u + kSlice - 1) / kSlice) * kSlice;
  for (int j = u + tid; j < up; j += kCompactThreads) tcols[j] = -1;
  if (tid == 0) ucount[tile] = u;
  __syncthreads();  // the block's column ids are visible to all of it

  for (int e = tid; e < kRows * up; e += kCompactThreads) {
    const int m = e / up, j = e - m * up;
    const float v = (j < u && m < rows)
                        ? q[(size_t)(r0 + m) * ldq + tcols[j]] : 0.0f;
    T out;
    if constexpr (std::is_same<T, int8_t>::value)
      out = static_cast<int8_t>(__float2int_rz(v));
    else
      out = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    qc[(((size_t)tile * S + j / kSlice) * kRows + m) * kSlice + j % kSlice] =
        out;
  }
}

// Item i of a block: 256-doc block g_begin + i / (kParts n_sl), its part
// (i / n_sl) % kParts of kDocs docs, column slice i % n_sl.
__device__ __forceinline__ int item_d0(int i, int g_begin, int n_sl) {
  return (g_begin + i / (kParts * n_sl)) * kBlock +
         ((i / n_sl) % kParts) * kDocs;
}

// ---------------------------------------------------------------------------
// int8: tensor cores.

// Swizzles of the int8 tiles' 16-byte chunks (each row is 8 chunks), so
// that the transpose's reads and writes and the ldmatrix reads each hit
// 32 distinct banks.
__device__ __forceinline__ int swz_raw(int k) { return ((k >> 2) & 3) << 1; }
__device__ __forceinline__ int swz_t(int r) { return (r ^ (r >> 3)) & 7; }

// Shared-memory layout of an int8 block, in bytes: A, the compacted
// counts of the current slice, [row][k], each row padded by 16 bytes so
// that the 8 rows an ldmatrix reads fall in distinct banks; two stages
// (one in use, one filling), each the raw rows of the pair as copied,
// [k][doc], 128 bytes whose 16-byte chunk c sits at c ^ swz_raw(k), and
// the two scale rows; the pair transposed, [doc][k], chunk c of row r at
// c ^ swz_t(r), as the s8 product takes it; the row maxima.
namespace i8 {
constexpr int kNi = kDocs / 32;  // 8-doc tiles per warp
constexpr int kLdA = kSlice + 16;
constexpr int kABytes = kRows * kLdA;
constexpr int kRawBytes = kSlice * kDocs;
constexpr int kStage = 2 * kRawBytes + 2 * kDocs * 4;
constexpr int kTOff = kABytes + 2 * kStage;
constexpr int kMaxOff = kTOff + 2 * kDocs * kSlice;
constexpr int kSmem = kMaxOff + 2 * 4 * kRows * 4;
}  // namespace i8

// 8 warps: 2 (rows) x 4 (docs), a 32 x 32 tile each.
__global__ void __launch_bounds__(kThreads, 2)
int8_kernel(const unsigned char* __restrict__ qc,
            const int* __restrict__ cols, const int* __restrict__ ucount,
            int S, const unsigned char* __restrict__ hi_t,
            const unsigned char* __restrict__ lo_t,
            const float* __restrict__ scale, float* __restrict__ scores,
            float* __restrict__ bmax, int nq, int D, int n_docs, int per) {
  using namespace i8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sMax = reinterpret_cast<float*>(smem + kMaxOff);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int G = D / kBlock;
  const int g_begin = blockIdx.y * per, g_end = min(G, g_begin + per);
  if (g_begin >= g_end) return;  // uniform across the block
  const int u = ucount[tile];
  const int n_sl = max(1, (u + kSlice - 1) / kSlice);
  const int n_items = (g_end - g_begin) * kParts * n_sl;
  const int* tcols = cols + (size_t)tile * S * kSlice;
  const unsigned char* tqc = qc + (size_t)tile * S * kRows * kSlice;

  auto stage = [&](int b) { return smem + kABytes + b * kStage; };
  auto copy_a = [&](int s) {  // slice s of the compacted counts
    const unsigned char* src = tqc + (size_t)s * kRows * kSlice;
    constexpr int kPerRow = kSlice / 16;
    for (int c = tid; c < kRows * kPerRow; c += kThreads)
      cp_async16(smem + (c / kPerRow) * kLdA + (c % kPerRow) * 16,
                 src + (size_t)c * 16, 16);
  };
  auto copy_item = [&](int i) {  // item i's operands to stage i % 2
    const int s = i % n_sl, d0 = item_d0(i, g_begin, n_sl);
    unsigned char* raw = stage(i % 2);
    constexpr int kPerRow = kDocs / 16;  // 16-byte chunks
#pragma unroll 4
    for (int c = tid; c < 2 * kSlice * kPerRow; c += kThreads) {
      const int mat = c / (kSlice * kPerRow);
      const int row = (c / kPerRow) % kSlice, ch = c % kPerRow;
      const int col = __ldg(tcols + s * kSlice + row);
      cp_async16(raw + mat * kRawBytes + row * kDocs +
                     (ch ^ swz_raw(row)) * 16,
                 (mat ? lo_t : hi_t) + (size_t)max(col, 0) * D + d0 + ch * 16,
                 col >= 0 ? 16 : 0);
    }
    float* ss = reinterpret_cast<float*>(raw + 2 * kRawBytes);
    if (tid < 2 * kDocs / 4)
      cp_async16(ss + 4 * tid,
                 scale + (tid >= kDocs / 4 ? D : 0) + d0 +
                     4 * (tid % (kDocs / 4)),
                 16);
    cp_async_commit();
  };

  // The raw [k][doc] rows of stage b transposed into [doc][k]. A thread
  // takes 4 columns x 4 docs (one word of each of 4 rows) at a time; a
  // warp covers 8 doc words x 4 column quads.
  auto transpose = [&](int b) {
    const unsigned char* raw = stage(b);
    unsigned char* tt = smem + kTOff;
    const int xl = lane & 7, kql = lane >> 3;
#pragma unroll
    for (int mat = 0; mat < 2; ++mat) {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int blk = warp + 8 * it;
        const int x = (blk & 3) * 8 + xl, kq = (blk >> 2) * 4 + kql;
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * kq + i;
          w[i] = *reinterpret_cast<const unsigned*>(
              raw + mat * kRawBytes + k * kDocs +
              16 * ((x >> 2) ^ swz_raw(k)) + 4 * (x & 3));
        }
        const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
        const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
        const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
        const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
        const unsigned o[4] = {__byte_perm(t0, t1, 0x5410),
                               __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410),
                               __byte_perm(t2, t3, 0x7632)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * x + j;
          *reinterpret_cast<unsigned*>(
              tt + mat * kDocs * kSlice + r * kSlice +
              16 * ((kq >> 2) ^ swz_t(r)) + 4 * (kq & 3)) = o[j];
        }
      }
    }
  };

  int acc[2][2][kNi][4];
  float rmax[4];

  auto mma_slice = [&]() {
#pragma unroll
    for (int kk = 0; kk < kSlice / 32; ++kk) {
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], smem + (wm * 32 + mi * 16 + ((lane >> 3) & 1) * 8 +
                               (lane & 7)) * kLdA +
                           kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int mat = 0; mat < 2; ++mat) {
        unsigned bf[kNi][2];
#pragma unroll
        for (int nj = 0; nj < kNi / 2; ++nj) {
          unsigned r[4];
          const int row = wn * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7);
          ldsm_x4(r, smem + kTOff + (mat * kDocs + row) * kSlice +
                         16 * ((kk * 2 + ((lane >> 3) & 1)) ^ swz_t(row)));
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni) mma(acc[mat][mi][ni], a[mi], bf[ni]);
      }
    }
  };

  // Scores of one item from the accumulators: a lane holds docs 2t, 2t+1
  // of rows g and g + 8 per 16 x 8 tile; lane pairs swap halves so that
  // each stores 4 consecutive docs of one row.
  auto epilogue = [&](int b, int d0) {
    const float* ss = reinterpret_cast<const float*>(stage(b) + 2 * kRawBytes);
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      const int dl = wn * 32 + ni * 8 + 2 * t, d = d0 + dl;
      const float2 s0 = *reinterpret_cast<const float2*>(ss + dl);
      const float2 s1 = *reinterpret_cast<const float2*>(ss + kDocs + dl);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int* h = acc[0][mi][ni];
        const int* l = acc[1][mi][ni];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __fmaf_rn(__int2float_rn(h[e]), (e & 1) ? s0.y : s0.x,
                           __fmul_rn(__int2float_rn(l[e]),
                                     (e & 1) ? s1.y : s1.x));
        if (d < n_docs) {
          rmax[2 * mi] = fmaxf(rmax[2 * mi], v[0]);
          rmax[2 * mi + 1] = fmaxf(rmax[2 * mi + 1], v[2]);
        }
        if (d + 1 < n_docs) {
          rmax[2 * mi] = fmaxf(rmax[2 * mi], v[1]);
          rmax[2 * mi + 1] = fmaxf(rmax[2 * mi + 1], v[3]);
        }
        const bool odd = t & 1;
        const float ra = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
        const float rb = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
        const int r = r0 + wm * 32 + mi * 16 + g + (odd ? 8 : 0);
        if (r < nq)
          __stcs(reinterpret_cast<float4*>(scores + (size_t)r * D + d -
                                           (odd ? 2 : 0)),
                 odd ? make_float4(ra, rb, v[2], v[3])
                     : make_float4(v[0], v[1], ra, rb));
      }
    }
  };

  // A finished block's row maxima: written to sMax by one half of the
  // block, reduced across the 4 doc warps after the next barrier.
  auto write_bmax = [&](int gb) {
    const float* m = sMax + (gb & 1) * 4 * kRows;
    if (tid < kRows && r0 + tid < nq) {
      float x = m[tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) x = fmaxf(x, m[w * kRows + tid]);
      bmax[(size_t)(r0 + tid) * G + gb] = x;
    }
  };

  if (n_sl == 1) copy_a(0);  // one slice: its counts stay for the run
  copy_item(0);
  int pending = -1;  // a block whose maxima wait in sMax
  for (int i = 0; i < n_items; ++i) {
    const int b = i % 2, s = i % n_sl, h = (i / n_sl) % kParts;
    const int gb = g_begin + i / (kParts * n_sl);
    cp_async_wait_all();
    __syncthreads();  // item i's operands are in; item i - 1 is done
    if (pending >= 0) {
      write_bmax(pending);
      pending = -1;
    }
    if (n_sl > 1) {  // a wide union: this slice's counts, not prefetched
      copy_a(s);
      cp_async_wait_all();
      __syncthreads();
    }
    if (i + 1 < n_items) copy_item(i + 1);
    transpose(b);
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int mat = 0; mat < 2; ++mat)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mat][mi][ni][e] = 0;
      if (h == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rmax[e] = -INFINITY;
      }
    }
    mma_slice();
    if (s != n_sl - 1) continue;
    epilogue(b, item_d0(i, g_begin, n_sl));
    if (h != kParts - 1) continue;
    // Each row's maximum over the lane quad, then to sMax for the 4 doc
    // warps (a buffer per block parity).
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rmax[e] = fmaxf(rmax[e], __shfl_xor_sync(0xffffffffu, rmax[e], 1));
      rmax[e] = fmaxf(rmax[e], __shfl_xor_sync(0xffffffffu, rmax[e], 2));
    }
    if (t == 0) {
      float* m = sMax + (gb & 1) * 4 * kRows;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[wn * kRows + wm * 32 + (e >> 1) * 16 + (e & 1) * 8 + g] = rmax[e];
    }
    pending = gb;
  }
  __syncthreads();
  if (pending >= 0) write_bmax(pending);
}

// ---------------------------------------------------------------------------
// bf16 modes: CUDA cores.

// Shared-memory layout of a bf16 block, in bytes: A, the compacted counts
// of the current slice, [row][k] (bf16 bits); then per stage the raw U
// rows of each matrix, [k][doc], 256 bytes each (a warp reads 8 bytes a
// lane of one row, so no padding is needed). Two stages for the single
// matrix; one for the pair, whose two would not let two blocks share an
// SM: its next item's copy overlaps only the epilogue. 80 KB either way.
template <int MODE>
struct B16 {
  static constexpr int kMats = MODE == kSingle ? 1 : 2;
  static constexpr int kStages = MODE == kPair ? 1 : 2;
  static constexpr int kABytes = kRows * kSlice * 2;
  static constexpr int kRawBytes = kSlice * kDocs * 2;
  static constexpr int kStage = kMats * kRawBytes;
  static constexpr int kSmem = kABytes + kStages * kStage;
};

constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // 8

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
bf16_kernel(const unsigned short* __restrict__ qc,
            const int* __restrict__ cols, const int* __restrict__ ucount,
            int S, const unsigned short* __restrict__ hi_t,
            const unsigned short* __restrict__ lo_t,
            float* __restrict__ scores, float* __restrict__ bmax, int nq,
            int D, int n_docs, int per) {
  using L = B16<MODE>;
  constexpr int kM = L::kMats;
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned short* sA = reinterpret_cast<const unsigned short*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, r0 = tile * kRows;
  const int G = D / kBlock;
  const int g_begin = blockIdx.y * per, g_end = min(G, g_begin + per);
  if (g_begin >= g_end) return;  // uniform across the block
  const int u = ucount[tile];
  const int n_sl = max(1, (u + kSlice - 1) / kSlice);
  const int n_items = (g_end - g_begin) * kParts * n_sl;
  const int* tcols = cols + (size_t)tile * S * kSlice;
  const unsigned short* tqc = qc + (size_t)tile * S * kRows * kSlice;

  auto stage = [&](int b) { return smem + L::kABytes + b * L::kStage; };
  auto copy_a = [&](int s) {  // slice s of the compacted counts
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        tqc + (size_t)s * kRows * kSlice);
    for (int c = tid; c < L::kABytes / 16; c += kThreads)
      cp_async16(smem + c * 16, src + (size_t)c * 16, 16);
  };
  // Item i's impact rows to stage i % kStages; pad columns (id -1) are
  // not copied: no row's mask selects them.
  auto copy_item = [&](int i) {
    const int s = i % n_sl, d0 = item_d0(i, g_begin, n_sl);
    unsigned char* raw = stage(i % L::kStages);
    constexpr int kPerRow = kDocs * 2 / 16;  // 16-byte chunks
#pragma unroll 4
    for (int c = tid; c < kM * kSlice * kPerRow; c += kThreads) {
      const int mat = c / (kSlice * kPerRow);
      const int row = (c / kPerRow) % kSlice, ch = c % kPerRow;
      const int col = __ldg(tcols + s * kSlice + row);
      if (col >= 0)
        cp_async16(raw + mat * L::kRawBytes + row * kDocs * 2 + ch * 16,
                   (mat ? lo_t : hi_t) + (size_t)col * D + d0 + ch * 8, 16);
    }
    cp_async_commit();
  };

  // The warp's rows are warp * 8 .. warp * 8 + 7; lane l keeps the
  // nonzero mask of row l / 4 over the slice's columns 32 (l % 4) ..
  // 32 (l % 4) + 31.
  unsigned mask = 0;
  auto load_masks = [&]() {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int m = warp * kRowsPerWarp + e / 4;
      const unsigned bits = __ballot_sync(
          0xffffffffu, (sA[m * kSlice + (e % 4) * 32 + lane] & 0x7fffu) != 0);
      if (lane == e) mask = bits;
    }
  };

  float acc[kM][kRowsPerWarp][4];
  float rmax[kRowsPerWarp];

  // Each row's nonzero columns of the slice in ascending order: the
  // lane's 4 docs of that impact row times the count, one fmaf each.
  auto product = [&](int b) {
    const unsigned char* raw = stage(b) + lane * 8;
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const unsigned short* arow = sA + (warp * kRowsPerWarp + ri) * kSlice;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned bits = __shfl_sync(0xffffffffu, mask, ri * 4 + c);
        while (bits) {
          const int j = c * 32 + __ffs(bits) - 1;
          bits &= bits - 1;
          const float qv = __uint_as_float((unsigned)arow[j] << 16);
#pragma unroll
          for (int mat = 0; mat < kM; ++mat) {
            const uint2 w = *reinterpret_cast<const uint2*>(
                raw + mat * L::kRawBytes + j * kDocs * 2);
            float* a = acc[mat][ri];
            a[0] = __fmaf_rn(qv, bf16_lo(w.x), a[0]);
            a[1] = __fmaf_rn(qv, bf16_hi(w.x), a[1]);
            a[2] = __fmaf_rn(qv, bf16_lo(w.y), a[2]);
            a[3] = __fmaf_rn(qv, bf16_hi(w.y), a[3]);
          }
        }
      }
    }
  };

  auto epilogue = [&](int d0) {
    const int d = d0 + lane * 4;
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = MODE == kPair ? __fadd_rn(acc[0][ri][e], acc[kM - 1][ri][e])
                             : acc[0][ri][e];
        if (d + e < n_docs) rmax[ri] = fmaxf(rmax[ri], v[e]);
      }
      const int r = r0 + warp * kRowsPerWarp + ri;
      if (r < nq)
        __stcs(reinterpret_cast<float4*>(scores + (size_t)r * D + d),
               make_float4(v[0], v[1], v[2], v[3]));
    }
  };

  if (n_sl == 1) copy_a(0);  // one slice: its counts stay for the run
  copy_item(0);
  for (int i = 0; i < n_items; ++i) {
    const int b = i % L::kStages, s = i % n_sl, h = (i / n_sl) % kParts;
    const int gb = g_begin + i / (kParts * n_sl);
    cp_async_wait_all();
    __syncthreads();  // item i's operands are in; item i - 1 is done
    if (n_sl > 1) {   // a wide union: this slice's counts, not prefetched
      copy_a(s);
      cp_async_wait_all();
      __syncthreads();
    }
    if (i == 0 || n_sl > 1) load_masks();
    if (L::kStages == 2 && i + 1 < n_items) copy_item(i + 1);
    if (s == 0) {
#pragma unroll
      for (int mat = 0; mat < kM; ++mat)
#pragma unroll
        for (int ri = 0; ri < kRowsPerWarp; ++ri)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mat][ri][e] = 0.0f;
      if (h == 0) {
#pragma unroll
        for (int ri = 0; ri < kRowsPerWarp; ++ri) rmax[ri] = -INFINITY;
      }
    }
    product(b);
    if (L::kStages == 1) {  // the stage is free once every warp is done
      __syncthreads();
      if (i + 1 < n_items) copy_item(i + 1);
    }
    if (s != n_sl - 1) continue;
    epilogue(item_d0(i, g_begin, n_sl));
    if (h != kParts - 1) continue;
    // Each row's maximum over the warp's lanes; lane ri writes row ri's.
    float mine = -INFINITY;
#pragma unroll
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      float x = rmax[ri];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == ri) mine = x;
    }
    const int r = r0 + warp * kRowsPerWarp + lane;
    if (lane < kRowsPerWarp && r < nq) bmax[(size_t)r * G + gb] = mine;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MODE>
int launch(const float* q, const void* hi_t, const void* lo_t,
           const float* scale, float* scores, float* bmax, void* scratch,
           int nq, int K, int ldq, int D, int n_docs, cudaStream_t stream) {
  const int G = D / kBlock;
  if (nq <= 0 || G <= 0) return (int)cudaGetLastError();
  if (K <= 0 || K > kMaxWords * 32) return (int)cudaErrorInvalidValue;
  const int tiles = (nq + kRows - 1) / kRows;
  const int S = (K + kSlice - 1) / kSlice;
  const Scratch lay = scratch_layout(MODE, nq, K);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* cols = reinterpret_cast<int*>(base);
  int* ucount = reinterpret_cast<int*>(base + lay.ucount);
  void* qc = base + lay.qc;
  // Each block walks a run of kRun 256-doc blocks of one tile. The tile
  // index varies fastest, so the blocks in flight share their docs and
  // the impact rows they read come from L2; blocks on longer runs drift
  // apart and lose that (PERF.md section 6). Runs lengthen only where
  // they would pass the grid's 65,535 rows.
  const int per = std::min(G, std::max(kRun, (G + 65534) / 65535));
  const dim3 grid(tiles, (G + per - 1) / per);
  int e;
  if constexpr (MODE == kInt8) {
    compact_kernel<int8_t><<<tiles, kCompactThreads, 0, stream>>>(
        q, nq, K, ldq, S, cols, ucount, static_cast<int8_t*>(qc));
    if ((e = allow_smem(int8_kernel, i8::kSmem))) return e;
    int8_kernel<<<grid, kThreads, i8::kSmem, stream>>>(
        static_cast<const unsigned char*>(qc), cols, ucount, S,
        static_cast<const unsigned char*>(hi_t),
        static_cast<const unsigned char*>(lo_t), scale, scores, bmax, nq, D,
        n_docs, per);
  } else {
    compact_kernel<unsigned short><<<tiles, kCompactThreads, 0, stream>>>(
        q, nq, K, ldq, S, cols, ucount, static_cast<unsigned short*>(qc));
    if ((e = allow_smem(bf16_kernel<MODE>, B16<MODE>::kSmem))) return e;
    bf16_kernel<MODE><<<grid, kThreads, B16<MODE>::kSmem, stream>>>(
        static_cast<const unsigned short*>(qc), cols, ucount, S,
        static_cast<const unsigned short*>(hi_t),
        static_cast<const unsigned short*>(lo_t), scores, bmax, nq, D,
        n_docs, per);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the scratch bb25_impact_matmul_bmax takes for this mode and
// shape (laid out as scratch_layout says).
extern "C" long long bb25_impact_matmul_scratch_bytes(int mode, int nq,
                                                      int K) {
  return (long long)scratch_layout(mode, nq, K).bytes;
}

// mode: 0 int8 pair (scale is (2, D) float), 1 bf16 pair, 2 single bf16.
// q (nq, K) float32 counts with row stride ldq >= K; hi_t, lo_t the
// impact matrices column-major, (K, D) each; scores (nq, D); bmax
// (nq, D / 256); scratch of bb25_impact_matmul_scratch_bytes(mode, nq, K)
// bytes. D must be a multiple of 256, K in (0, 32768], n_docs in [0, D].
extern "C" int bb25_impact_matmul_bmax(const float* q, const void* hi_t,
                                       const void* lo_t, const float* scale,
                                       float* scores, float* bmax,
                                       void* scratch, int mode, int nq, int K,
                                       int ldq, int D, int n_docs,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kInt8:
      return launch<kInt8>(q, hi_t, lo_t, scale, scores, bmax, scratch, nq,
                           K, ldq, D, n_docs, s);
    case kPair:
      return launch<kPair>(q, hi_t, lo_t, scale, scores, bmax, scratch, nq,
                           K, ldq, D, n_docs, s);
    case kSingle:
      return launch<kSingle>(q, hi_t, lo_t, scale, scores, bmax, scratch, nq,
                             K, ldq, D, n_docs, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
