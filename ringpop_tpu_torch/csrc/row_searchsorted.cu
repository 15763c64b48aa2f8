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
// and write the positions once: (C + 2K) * 4 bytes per row, 100.7 MB (about
// 0.030 ms at 3.35 TB/s) at the delta path's main shape [65536, 256] x
// [65536, 64].  A binary search does ceil(log2(C + 1)) compares per query,
// far below the card's integer rate at the delta path's shapes.
//
// Design: the TPU kernel counted with a [rows, K, C] broadcast compare, a
// workaround for the TPU's lack of per-lane gathers.  A 128-thread block per
// row would leave half its threads idle at K = 64 and keep only 16 such
// blocks (~16 KB of rows) in flight per SM.  Here a group of lanes owns one
// row: a whole warp when K > 16, half a warp when K <= 16, a quarter when K
// <= 8, so that the queries keep the lanes busy; a 256-thread block holds 8,
// 16 or 32 rows.  The group copies its table row and query row into its own
// slice of shared memory with cp.async, keeping each row's 16-byte phase, so
// a row whose start is not 16-byte aligned (C not a multiple of 4) moves its
// head and tail words with 4-byte copies and its body with 16-byte copies,
// and then synchronises with a __syncwarp over its own lanes only.  At 32
// registers a thread, 64 warps are resident per SM, so ~80 KB of rows are in
// flight per SM at the main shape, enough to cover HBM latency.  Each lane
// takes queries gl, gl + G, ... (G the group's width), up to four at a time
// searched together (as many as K needs: K = 64 runs one pass of two), each a
// branchless binary search of a fixed ceil(log2(C + 1)) steps (lo += step
// where row[lo + step - 1] goes left), so lanes do not diverge.  Rows of at
// most 32 entries, and rows whose table and query rows do not fit the slice
// (C = 20000 in the tests), are searched in place in global memory through
// the read-only cache.  A persistent grid whose warps prefetch their next row
// with cp.async measured slower than this grid of one row per group.  The
// side, the staging and the group width are template parameters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueriesPerPass = 4;  // per lane, searched together
constexpr size_t kSmemLimit = 48 * 1024;
constexpr int kInPlaceCols = 32;  // rows this narrow are not staged

template <bool kRight>
__device__ __forceinline__ bool goes_left(int t, int q) {
  return kRight ? (t <= q) : (t < q);
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Word slots a staged run of `count` words takes: up to 3 words of phase in
// front so that the copy keeps the global address's 16-byte phase.
__host__ __device__ __forceinline__ int staged_words(int count) {
  return (count + 3 + 3) & ~3;
}

// The lanes of a group (lane gl of kGroup) copy src[0, count) into buf
// (16-byte aligned), at the word offset that matches src's 16-byte phase;
// returns that offset.
template <int kGroup>
__device__ __forceinline__ int stage_async(int* buf, const int* src, int count, int gl) {
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  int* dst = buf + phase;
  const int head = min((4 - phase) & 3, count);
  if (gl < head) cp_async4(dst + gl, src + gl);
  const int body = (count - head) >> 2;
  for (int v = gl; v < body; v += kGroup) cp_async16(dst + head + 4 * v, src + head + 4 * v);
  const int tail = head + 4 * body;
  if (gl < count - tail) cp_async4(dst + tail + gl, src + tail + gl);
  return phase;
}

// Branchless lower bound (side left) or upper bound (side right) of each
// of kPass queries in row[0, c), c >= 1: the largest lo with row[lo - 1]
// going left, found in a fixed floor(log2(c)) + 1 steps.
template <bool kRight, bool kStaged, int kPass>
__device__ __forceinline__ void search(const int* row, int c, const int (&q)[kPass],
                                       int (&lo)[kPass]) {
#pragma unroll
  for (int u = 0; u < kPass; ++u) lo[u] = 0;
  for (int step = 1 << (31 - __clz(c)); step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      const int nxt = lo[u] + step;
      const int at = min(nxt, c) - 1;
      const int t = kStaged ? row[at] : __ldg(row + at);
      lo[u] = (nxt <= c && goes_left<kRight>(t, q[u])) ? nxt : lo[u];
    }
  }
}

// Queries base + gl + kGroup u (u < kPass) of one row, searched together.
template <bool kRight, bool kStaged, int kGroup, int kPass>
__device__ __forceinline__ void search_pass(const int* row, const int* qrow, int* orow, int c,
                                            int k, int base, int gl) {
  int q[kPass];
  int lo[kPass];
#pragma unroll
  for (int u = 0; u < kPass; ++u) {
    const int j = min(base + gl + kGroup * u, k - 1);
    q[u] = kStaged ? qrow[j] : __ldg(qrow + j);
  }
  if (c > 0) {
    search<kRight, kStaged, kPass>(row, c, q, lo);
  } else {
#pragma unroll
    for (int u = 0; u < kPass; ++u) lo[u] = 0;
  }
#pragma unroll
  for (int u = 0; u < kPass; ++u) {
    const int j = base + gl + kGroup * u;
    if (j < k) orow[j] = lo[u];
  }
}

// Search the queries of one row and write their positions, up to
// kQueriesPerPass a lane at a time; the pass width is uniform over the
// group, so a row of K = 64 queries runs one pass of two per lane.
template <bool kRight, bool kStaged, int kGroup>
__device__ __forceinline__ void search_row(const int* row, const int* qrow, int* orow, int c,
                                           int k, int gl) {
  for (int base = 0; base < k; base += kGroup * kQueriesPerPass) {
    const int left = k - base;
    if (left > 3 * kGroup) {
      search_pass<kRight, kStaged, kGroup, 4>(row, qrow, orow, c, k, base, gl);
    } else if (left > 2 * kGroup) {
      search_pass<kRight, kStaged, kGroup, 3>(row, qrow, orow, c, k, base, gl);
    } else if (left > kGroup) {
      search_pass<kRight, kStaged, kGroup, 2>(row, qrow, orow, c, k, base, gl);
    } else {
      search_pass<kRight, kStaged, kGroup, 1>(row, qrow, orow, c, k, base, gl);
    }
  }
}

// A group of kGroup lanes owns one row: 32 / kGroup rows to a warp.
template <bool kRight, bool kStaged, int kGroup>
__global__ void __launch_bounds__(kThreads)
row_searchsorted_kernel(const int* __restrict__ table, const int* __restrict__ queries,
                        int* __restrict__ out, int n, int c, int k) {
  extern __shared__ __align__(16) int smem[];
  const int slot = threadIdx.x / kGroup;  // the group's row within the block
  const int gl = threadIdx.x % kGroup;
  const int row = blockIdx.x * (kThreads / kGroup) + slot;
  if (row >= n) return;
  const int* trow = table + (size_t)row * c;
  const int* qrow = queries + (size_t)row * k;
  if (kStaged) {
    const int tw = staged_words(c);
    int* buf = smem + slot * (tw + staged_words(k));
    const int tphase = stage_async<kGroup>(buf, trow, c, gl);
    const int qphase = stage_async<kGroup>(buf + tw, qrow, k, gl);
    cp_async_commit();
    cp_async_wait_all();
    const unsigned group = 0xFFFFFFFFu >> (32 - kGroup);
    __syncwarp(group << (threadIdx.x & 31 & ~(kGroup - 1)));
    trow = buf + tphase;
    qrow = buf + tw + qphase;
  }
  search_row<kRight, kStaged, kGroup>(trow, qrow, out + (size_t)row * k, c, k, gl);
}

template <bool kRight, bool kStaged, int kGroup>
int launch(const int* t, const int* q, int* o, int n, int c, int k, cudaStream_t s) {
  constexpr int rows = kThreads / kGroup;  // per block
  const size_t smem = kStaged ? (size_t)rows * (staged_words(c) + staged_words(k)) * sizeof(int)
                              : 0;
  const int blocks = (n + rows - 1) / rows;
  row_searchsorted_kernel<kRight, kStaged, kGroup><<<blocks, kThreads, smem, s>>>(t, q, o, n, c,
                                                                                  k);
  return static_cast<int>(cudaGetLastError());
}

// Staged when the block's rows fit its shared memory and are wider than
// kInPlaceCols: a row of at most four 32-byte sectors is searched in place,
// its few probes served by L1, sooner than a staging round trip.
template <bool kRight, int kGroup>
int launch_group(const int* t, const int* q, int* o, int n, int c, int k, cudaStream_t s) {
  const size_t staged =
      (size_t)(kThreads / kGroup) * (staged_words(c) + staged_words(k)) * sizeof(int);
  return staged <= kSmemLimit && c > kInPlaceCols
             ? launch<kRight, true, kGroup>(t, q, o, n, c, k, s)
             : launch<kRight, false, kGroup>(t, q, o, n, c, k, s);
}

// The group is as wide as K needs, up to a warp, so K = 16 queries run
// two rows to a warp and K = 8 four.
template <bool kRight>
int launch_side(const int* t, const int* q, int* o, int n, int c, int k, cudaStream_t s) {
  if (k <= 8) return launch_group<kRight, 8>(t, q, o, n, c, k, s);
  if (k <= 16) return launch_group<kRight, 16>(t, q, o, n, c, k, s);
  return launch_group<kRight, 32>(t, q, o, n, c, k, s);
}

}  // namespace

// table int32[n, c] (rows sorted ascending), queries int32[n, k], out
// int32[n, k], all row-major and contiguous; right != 0 selects side
// "right".  Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int rp_row_searchsorted(const void* table, const void* queries, void* out,
                                   int n, int c, int k, int right, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* q = static_cast<const int*>(queries);
  int* o = static_cast<int*>(out);
  return right ? launch_side<true>(t, q, o, n, c, k, s) : launch_side<false>(t, q, o, n, c, k, s);
}
