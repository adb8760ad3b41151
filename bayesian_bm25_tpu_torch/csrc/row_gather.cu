// K2 row_gather: out[i, c] = scores[trows[i], sid[i, c]], 0.0 for a
// sentinel id.
//
// Replaces bayesian_bm25_tpu/engine/pallas_gather.py (_row_gather_kernel,
// launched through _row_gather_call / row_gather).
//
// Ids outside [0, d_pad) (the merge's d_pad sentinel, or -1) and rows
// outside [0, nq) give 0.0. Values are copied, so the result is bit-exact
// for any input, -inf included. sid need not be sorted.
//
// The TPU kernel streamed whole rows through VMEM and selected with
// one-hot MXU products over a 3-way bf16 split, because the TPU has no
// fast indexed load; it was therefore limited to finite scores and
// D_pad <= 2^18. Hopper loads an indexed float directly, so the design is
// one thread per output element: the sid and out traffic is coalesced,
// and the merge sorts each row's ids, so neighbouring threads often share
// a 32-byte sector of the gather. There is no eligibility gate: masked
// (-inf) batches and any D_pad are served alike.
//
// Bound: bytes, at scattered addresses, and latency. Counted with each
// byte read once (sid, trows, the gathered floats, out), a tier-2 gather
// of the 1M-document path, sid (128, 8202) with 376k real ids over a
// (1024, 1001472) score matrix, moves 10 MB: 3 us at 3.35 TB/s. Each
// gathered float costs a whole 32-byte sector, and the 4.1 GB score
// matrix the matmul has just written is cold in the 50 MB L2, so the
// sector floor is one sector for each distinct (row, id >> 3) plus sid
// and out: 6 us there. chip_smoke.py reports both, and the same launch
// with every id a sentinel (sid read, out written, nothing gathered),
// which at the merge's shapes takes half or more of each call: a launch
// and two dependent round trips to device memory (sid, then the sector it
// names). A warp per segment of 32*U candidates with U gathers in flight
// a lane, L1-bypassing and streaming cache hints, and a (column block,
// row) grid without the per-element division each measured level with
// this kernel on an H100, cold, at those shapes (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_kernel(const float* __restrict__ scores,
                                  const int* __restrict__ sid,
                                  const int* __restrict__ trows,
                                  float* __restrict__ out, int nt, int cap,
                                  int d_pad, int nq) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)nt * cap) return;
  const int s = __ldg(sid + i);
  const int row = __ldg(trows + i / cap);
  const bool ok = (unsigned)s < (unsigned)d_pad && row >= 0 && row < nq;
  out[i] = ok ? __ldg(scores + (long long)row * d_pad + s) : 0.0f;
}

}  // namespace

extern "C" int bb25_row_gather(const float* scores, const int* sid,
                               const int* trows, float* out, int nt,
                               int cap, int d_pad, int nq, void* stream) {
  const long long n = (long long)nt * cap;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    row_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        scores, sid, trows, out, nt, cap, d_pad, nq);
  }
  return (int)cudaGetLastError();
}
