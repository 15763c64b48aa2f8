// Row-wise searchsorted for the delta SWIM backend, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/searchsorted_pallas.py (_kernel via
// row_searchsorted_pallas).  For each row n and query k it writes the count
// of table[n, c] < q[n, k] (side "left") or table[n, c] <= q[n, k] (side
// "right").  Every caller passes rows sorted ascending (SENTINEL-padded
// tables, sorted claim lists, suffix-min arrays), so the count is the
// insertion position, and a binary search finds it.
//
// What bounds it: bytes.  It must read each table row and query row once
// and write the positions once: (C + 2K) * 4 bytes per row.  A binary search
// does ceil(log2(C + 1)) compares per query, far below the card's integer
// rate at the main path's shapes.
//
// Design: the TPU kernel counted with a [rows, K, C] broadcast compare, a
// workaround for the TPU's lack of per-lane gathers; it does K * C compares
// per row.  Here one block owns one row: its threads copy the row's C int32
// into shared memory with coalesced loads (when C * 4 bytes fit in the 48 KB
// a block gets without opting in; larger rows are searched in global memory
// through the read-only cache), then each thread binary-searches its
// queries there.  Query loads and position stores are coalesced across the
// warp.  The side is a template parameter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmemLimit = 48 * 1024;

template <bool kRight>
__device__ __forceinline__ bool goes_left(int t, int q) {
  return kRight ? (t <= q) : (t < q);
}

template <bool kRight>
__global__ void __launch_bounds__(kThreads)
row_searchsorted_kernel(const int* __restrict__ table, const int* __restrict__ queries,
                        int* __restrict__ out, int c, int k, int staged) {
  extern __shared__ int srow[];
  const size_t row = blockIdx.x;
  const int* trow = table + row * (size_t)c;
  const int* src = trow;
  if (staged) {
    for (int i = threadIdx.x; i < c; i += blockDim.x) srow[i] = __ldg(trow + i);
    __syncthreads();
    src = srow;
  }
  const int* qrow = queries + row * (size_t)k;
  int* orow = out + row * (size_t)k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int q = __ldg(qrow + j);
    int lo = 0;
    int hi = c;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int t = staged ? src[mid] : __ldg(src + mid);
      if (goes_left<kRight>(t, q)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    orow[j] = lo;
  }
}

}  // namespace

// table int32[n, c] (rows sorted ascending), queries int32[n, k], out
// int32[n, k], all row-major and contiguous; right != 0 selects side
// "right".  Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int rp_row_searchsorted(const void* table, const void* queries, void* out,
                                   int n, int c, int k, int right, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const size_t row_bytes = (size_t)c * sizeof(int);
  const int staged = (c > 0 && row_bytes <= (size_t)kSmemLimit) ? 1 : 0;
  const size_t smem = staged ? row_bytes : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* q = static_cast<const int*>(queries);
  int* o = static_cast<int*>(out);
  if (right) {
    row_searchsorted_kernel<true><<<n, kThreads, smem, s>>>(t, q, o, c, k, staged);
  } else {
    row_searchsorted_kernel<false><<<n, kThreads, smem, s>>>(t, q, o, c, k, staged);
  }
  return static_cast<int>(cudaGetLastError());
}
