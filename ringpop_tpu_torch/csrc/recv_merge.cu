// Receiver merge for the dense SWIM step, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/recv_merge_pallas.py (_kernel via
// _recv_merge_pallas_jit).  For each receiver r it writes the elementwise
// int32 max of the claim rows of every sender whose ping reached r, and 0
// where no ping did, and counts r's inbound pings.
//
// What bounds it: bytes.  It reads each delivered claim row once and writes
// the N x N int32 output once: at n = 10000, ~0.79 GB (0.237 ms at
// 3.35 TB/s) at phase 3, where ~99% of senders deliver, and ~0.40 GB (the
// zeros, 0.119 ms) in a ping-req slot, where ~1% do.
//
// Two launches:
//
// 1. recv_merge_sort_kernel, one block of 1024 threads, is a counting sort
//    of the senders by receiver.  It reads t_safe (int64) and fwd_ok (bool)
//    as the caller holds them, counts senders per receiver in shared memory,
//    scans the counts into run starts, and scatters each delivering sender
//    to its receiver's run: order[starts[r] .. starts[r+1]) are r's senders,
//    inbound[r] their count, with one shared-memory atomic per delivering
//    sender in each pass (aggregating the lanes of a warp that share a
//    receiver with __match_any_sync was no faster at phase 3, where
//    receivers are spread).  The scatter's atomics leave the order within a
//    run to the hardware; the merge takes a max, which does not depend on
//    that order, so the output is exact and deterministic.  A pass counts
//    up to kSortKeys receivers (128 KB of shared memory, enough for the
//    dense step's n <= 32768 in one pass); beyond that, receivers are
//    sorted in passes of kSortKeys each over all senders.
//
// 2. recv_merge_kernel merges work units (receiver r, tile of kTileCols
//    columns), one 256-thread block each.  The TPU kernel walked sender
//    positions in a sequential grid and kept the receiver's block resident
//    in VMEM; here a unit folds its run in registers and writes each output
//    element once, with no atomics.  Each thread holds kVecs x kSenders
//    independent 16-byte loads in flight (two sender rows at a time), and
//    the several blocks each SM holds at once cover the three dependent
//    round trips (run bounds, sender index, claim row) in front of each
//    unit's rows.  A run of length n (all-to-one) spreads over n /
//    kTileCols blocks.  An empty run, most of a ping-req slot, writes its
//    zeros with 16-byte stores.  A persistent grid sized from the SM count
//    and occupancy, each block taking every gridDim-th unit and loading the
//    next unit's run bounds during the current merge, measured slower at
//    both shapes: its blocks hold their share of units whatever the runs'
//    lengths, while the hardware hands each free SM the next block.  Plain
//    ld.global.v4 through the read-only path is used rather than TMA bulk
//    copies: a claim row is read once into registers, folded and written,
//    so staging it in shared memory adds a round trip and gains no reuse.
//    Rows whose start is not 16-byte aligned (n % 4 != 0, or claims from an
//    unaligned view) take a masked scalar path over the same units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSortThreads = 1024;
constexpr int kSortUnroll = 8;      // senders a thread loads together
constexpr int kSortKeys = 32768;    // receivers one pass counts in shared memory
constexpr int kThreads = 256;
constexpr int kVecs = 2;            // 16-byte vectors a thread per claim row
constexpr int kSenders = 2;         // claim rows loaded together
constexpr int kTileCols = kThreads * 4 * kVecs;  // columns a work unit

// Receiver of sender s relative to the pass's first receiver k0, or -1
// when s is past the end, silent, or its receiver lies outside the pass.
// Both loads are issued before either is read, so a thread's senders cost
// one round trip to memory, not two.
__device__ __forceinline__ int pass_key(const long long* t_safe, const uint8_t* fwd_ok, int s,
                                        int n, int k0, int keys) {
  if (s >= n) return -1;
  const uint8_t ok = __ldg(fwd_ok + s);
  const long long t = __ldg(t_safe + s) - k0;
  return (ok && t >= 0 && t < keys) ? static_cast<int>(t) : -1;
}

// Inclusive scan of v over the 1024 threads of the block, and the block's
// total in `total`; `sums` holds 32 ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += o;
  }
  if (lane == 31) sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += o;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? sums[warp - 1] : 0;
  total = sums[31];
  __syncthreads();  // sums is reused by the next call
  return before + v;
}

__global__ void __launch_bounds__(kSortThreads)
recv_merge_sort_kernel(const long long* __restrict__ t_safe, const uint8_t* __restrict__ fwd_ok,
                       int* __restrict__ order, int* __restrict__ starts,
                       int* __restrict__ inbound, int n) {
  extern __shared__ int cnt[];  // counts, then cursors, of the pass's receivers
  __shared__ int sums[32];
  const int tid = threadIdx.x;
  int placed = 0;  // senders placed by earlier passes (the same in every thread)
  for (int k0 = 0; k0 < n; k0 += kSortKeys) {
    const int keys = min(kSortKeys, n - k0);
    for (int i = tid; i < keys; i += kSortThreads) cnt[i] = 0;
    __syncthreads();

    // 1. count senders per receiver
    for (int base = 0; base < n; base += kSortThreads * kSortUnroll) {
      int key[kSortUnroll];
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        key[u] = pass_key(t_safe, fwd_ok, base + u * kSortThreads + tid, n, k0, keys);
      }
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        if (key[u] >= 0) atomicAdd(&cnt[key[u]], 1);
      }
    }
    __syncthreads();

    // 2. exclusive scan of the counts into run starts; each thread scans
    // one contiguous chunk, the block scans the chunks' sums
    const int per = (keys + kSortThreads - 1) / kSortThreads;
    const int lo = min(tid * per, keys);
    const int hi = min(lo + per, keys);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += cnt[i];
    int total = 0;
    const int incl = block_scan(sum, sums, total);
    int run = placed + incl - sum;
    for (int i = lo; i < hi; ++i) {
      const int c = cnt[i];
      inbound[k0 + i] = c;
      starts[k0 + i] = run;
      cnt[i] = run;  // the receiver's cursor
      run += c;
    }
    placed += total;
    __syncthreads();

    // 3. scatter each delivering sender to its receiver's run
    for (int base = 0; base < n; base += kSortThreads * kSortUnroll) {
      int key[kSortUnroll];
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        key[u] = pass_key(t_safe, fwd_ok, base + u * kSortThreads + tid, n, k0, keys);
      }
#pragma unroll
      for (int u = 0; u < kSortUnroll; ++u) {
        if (key[u] >= 0) order[atomicAdd(&cnt[key[u]], 1)] = base + u * kSortThreads + tid;
      }
    }
    __syncthreads();  // before the next pass clears the counts
  }
  if (tid == 0) starts[n] = placed;
}

__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

// Unit (r, t) with 16-byte rows: thread x owns columns col0 + 4 * kThreads * k
// .. + 3 (k < kVecs), col0 = t * kTileCols + 4 * x; n % 4 == 0, so a vector
// lies wholly inside or wholly outside the row.
__device__ __forceinline__ void merge_unit_vec(const int* __restrict__ order,
                                               const int* __restrict__ claims,
                                               int* __restrict__ dst, int n, int t, int lo,
                                               int hi) {
  const int col0 = t * kTileCols + 4 * threadIdx.x;
  int4 acc[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) acc[k] = make_int4(0, 0, 0, 0);
  int p = lo;
  for (; p + kSenders <= hi; p += kSenders) {
    int4 v[kSenders][kVecs];
#pragma unroll
    for (int j = 0; j < kSenders; ++j) {
      const int* row = claims + (size_t)__ldg(order + p + j) * n;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const int col = col0 + 4 * kThreads * k;
        v[j][k] = col < n ? __ldg(reinterpret_cast<const int4*>(row + col)) : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int j = 0; j < kSenders; ++j) {
#pragma unroll
      for (int k = 0; k < kVecs; ++k) acc[k] = max4(acc[k], v[j][k]);
    }
  }
  for (; p < hi; ++p) {
    const int* row = claims + (size_t)__ldg(order + p) * n;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int col = col0 + 4 * kThreads * k;
      if (col < n) acc[k] = max4(acc[k], __ldg(reinterpret_cast<const int4*>(row + col)));
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int col = col0 + 4 * kThreads * k;
    if (col < n) *reinterpret_cast<int4*>(dst + col) = acc[k];
  }
}

// Unit (r, t) with rows of any alignment: thread x owns columns
// t * kTileCols + x + kThreads * k (k < 4 * kVecs), masked at n.
__device__ __forceinline__ void merge_unit_scalar(const int* __restrict__ order,
                                                  const int* __restrict__ claims,
                                                  int* __restrict__ dst, int n, int t, int lo,
                                                  int hi) {
  constexpr int kCols = 4 * kVecs;
  const int col0 = t * kTileCols + threadIdx.x;
  int acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0;
  for (int p = lo; p < hi; ++p) {
    const int* row = claims + (size_t)__ldg(order + p) * n;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = col0 + kThreads * k;
      if (col < n) acc[k] = max(acc[k], __ldg(row + col));
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int col = col0 + kThreads * k;
    if (col < n) dst[col] = acc[k];
  }
}

// One block a work unit: unit blockIdx.x is receiver blockIdx.x / tiles,
// column tile blockIdx.x % tiles.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
recv_merge_kernel(const int* __restrict__ order, const int* __restrict__ starts,
                  const int* __restrict__ claims, int* __restrict__ out, int n, int tiles) {
  const int r = blockIdx.x / tiles;
  const int t = blockIdx.x - r * tiles;
  const int lo = __ldg(starts + r);
  const int hi = __ldg(starts + r + 1);
  int* dst = out + (size_t)r * n;
  if (kVec) {
    merge_unit_vec(order, claims, dst, n, t, lo, hi);
  } else {
    merge_unit_scalar(order, claims, dst, n, t, lo, hi);
  }
}

template <bool kVec>
int launch_merge(const int* order, const int* starts, const int* claims, int* out, int n,
                 cudaStream_t s) {
  const int tiles = (n + kTileCols - 1) / kTileCols;
  recv_merge_kernel<kVec><<<n * tiles, kThreads, 0, s>>>(order, starts, claims, out, n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t_safe int64[n] (sender -> receiver), fwd_ok bool[n] (delivered), and
// outputs order int32[n] (delivering senders grouped by receiver; entries
// past starts[n] are not written), starts int32[n + 1] (run bounds) and
// inbound int32[n] (run lengths); all contiguous.  Launches on `stream`;
// returns the CUDA error code of the launch.
extern "C" int rp_recv_merge_sort(const void* t_safe, const void* fwd_ok, void* order,
                                  void* starts, void* inbound, int n, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)min(n, kSortKeys) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        recv_merge_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSortKeys * sizeof(int)));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  recv_merge_sort_kernel<<<1, kSortThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(t_safe), static_cast<const uint8_t*>(fwd_ok),
      static_cast<int*>(order), static_cast<int*>(starts), static_cast<int*>(inbound), n);
  return static_cast<int>(cudaGetLastError());
}

// order int32[n] and starts int32[n + 1] as rp_recv_merge_sort writes them,
// claims int32[n, n] (row-major, contiguous, any 4-byte alignment), out
// int32[n, n].  Launches on `stream`; returns the CUDA error code of the
// launch.
extern "C" int rp_recv_merge(const void* order, const void* starts, const void* claims,
                             void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(claims) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(order);
  const int* st = static_cast<const int*>(starts);
  const int* c = static_cast<const int*>(claims);
  int* d = static_cast<int*>(out);
  return vec ? launch_merge<true>(o, st, c, d, n, s) : launch_merge<false>(o, st, c, d, n, s);
}
