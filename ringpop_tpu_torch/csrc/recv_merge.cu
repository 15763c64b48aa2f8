// Receiver merge for the dense SWIM step, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/recv_merge_pallas.py (_kernel via
// _recv_merge_pallas_jit).  For each receiver r it writes the elementwise
// int32 max of the claim rows of every sender whose ping reached r, and 0
// where no ping did.  The wrapper (ops/recv_merge.py) keeps the flat prefix
// as torch ops, as the TPU kernel kept it outside pallas_call: senders are
// sorted by receiver, so receiver r's senders are the contiguous run
// order[starts[r] .. starts[r+1]).
//
// What bounds it: bytes.  It reads each delivered claim row once and writes
// the N x N int32 output once; at n = 10000 that is at most ~0.8 GB.
//
// Design: the TPU kernel walked sender positions in a sequential grid and
// kept the receiver's output block resident in VMEM between steps.  Blocks
// on Hopper run in no order, so here one block owns one (receiver, column
// tile) pair and folds the receiver's whole run in registers: each output
// element is written exactly once, with no atomics, so the result is exact
// and deterministic.  Each thread handles four adjacent columns with one
// 16-byte load per row (coalesced across the warp) when rows are 16-byte
// aligned (n % 4 == 0), and scalar loads with a masked tail otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec;  // columns per block

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
recv_merge_kernel(const int* __restrict__ order, const int* __restrict__ starts,
                  const int* __restrict__ claims, int* __restrict__ out, int n) {
  const int r = blockIdx.x;
  const int col = blockIdx.y * kTile + threadIdx.x * kVec;
  if (col >= n) return;
  const int lo = starts[r];
  const int hi = starts[r + 1];
  int* dst = out + (size_t)r * n + col;
  if ((n & 3) == 0) {  // rows 16-byte aligned, col a multiple of 4 < n
    int4 acc = make_int4(0, 0, 0, 0);
    if (lo < hi) {
      acc = __ldg(reinterpret_cast<const int4*>(claims + (size_t)order[lo] * n + col));
      for (int p = lo + 1; p < hi; ++p) {
        acc = max4(acc, __ldg(reinterpret_cast<const int4*>(
                             claims + (size_t)order[p] * n + col)));
      }
    }
    *reinterpret_cast<int4*>(dst) = acc;
    return;
  }
  const int width = min(kVec, n - col);
  int acc[kVec] = {0, 0, 0, 0};
  if (lo < hi) {
    const int* row = claims + (size_t)order[lo] * n + col;
    for (int k = 0; k < width; ++k) acc[k] = __ldg(row + k);
    for (int p = lo + 1; p < hi; ++p) {
      row = claims + (size_t)order[p] * n + col;
      for (int k = 0; k < width; ++k) acc[k] = max(acc[k], __ldg(row + k));
    }
  }
  for (int k = 0; k < width; ++k) dst[k] = acc[k];
}

}  // namespace

// order int32[n], starts int32[n + 1], claims int32[n, n] (row-major,
// contiguous), out int32[n, n].  Launches on `stream`; returns the CUDA
// error code of the launch.
extern "C" int rp_recv_merge(const void* order, const void* starts,
                             const void* claims, void* out, int n,
                             void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(n, (n + kTile - 1) / kTile);
  recv_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const int*>(starts),
      static_cast<const int*>(claims), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
