// Sorted-insert merge of the delta SWIM tables, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/delta_merge_pallas.py (_kernel via
// merge_insert_pallas).  Each viewer row holds a sorted table of C slots in
// four channels (subject and key int32, piggyback count and suspicion
// countdown int8, SENTINEL-padded) and a sorted, SENTINEL-padded insert list
// of ki (subject, key) pairs whose live subjects are absent from the table.
// The kernel writes the merged table: an inserted slot gets piggyback 0 and
// countdown sl_start when its key's status is `suspect` (else -1); a
// SENTINEL insert that lands in the table gets -1 in both.
//
// What bounds it: bytes.  It must read the four table channels (10 bytes a
// slot) and the insert list (8 bytes an entry) once and write the four
// output channels once: 370 MB, 0.110 ms at 3.35 TB/s, at the delta path's
// [65536, 256] with ki = 65.  The position arithmetic is a few short binary
// searches per row, far below the card's integer rate.
//
// Design: the TPU kernel had no gathers, so it computed each insert's merged
// position with a compare-reduce over the row and fetched the existing-side
// payload through one lane roll per possible shift distance (K + 1 passes).
// Here one warp owns one row, eight rows to a 256-thread block, and does the
// merge inversion in shared memory:
//   0. the warp copies its row's six inputs (2.5 KB of table and 520 B of
//      inserts at the main shape) into its own slice of shared memory with
//      16-byte cp.async, keeping each array's 16-byte phase: rows start
//      anywhere (an int32 row at 4 C bytes, an int8 row at C bytes, an
//      insert row at 4 ki bytes), so the words before the first and after
//      the last 16-byte boundary go by 4-byte cp.async, and the bytes of
//      an int8 row that is not 4-byte aligned one by one;
//   1. insert k's merged position pos[k] = #(table subjects < ins_subj[k]) +
//      k, by a binary search of the staged row (positions strictly increase
//      in k);
//   2. each lane merges runs of kRun adjacent output slots: one binary
//      search of pos gives e = #(inserts before the run's first slot j0),
//      then the lane walks forward: slot j is insert e when pos[e] == j
//      (and e advances), else existing slot j - e.  A warp's runs are
//      adjacent, so its stores are 16-byte (int32) and 4-byte (int8) writes
//      of contiguous 512- and 128-byte spans.
// So the row crosses device memory once in each direction in wide
// accesses, every search runs in shared memory, and the 48-64 warps an SM
// holds (one row each) keep ~150-200 KB of rows in flight, so one warp's
// searches overlap the others' loads; a persistent grid that prefetches its
// next row would only add that overlap within a warp.  Each
// output element is written exactly once, with no atomics.  A row whose
// staged slices do not fit the 48 KB a block gets without opting in (C =
// 5000 in the tests) is merged in place from global memory with the same
// code, pos in shared memory when the block's eight lists of ki ints fit,
// else in a global scratch row the wrapper allocates.  Every ki from 1
// upward and every C from 1 upward is handled by loops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr size_t kSmemLimit = 48 * 1024;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kRun = 4;  // adjacent output slots a lane merges in one walk

// Bytes a staged array of `bytes` takes: up to 15 bytes of phase in front,
// rounded to 16.
__host__ __device__ __forceinline__ size_t staged_bytes(size_t bytes) {
  return (bytes + 15 + 15) & ~size_t{15};
}

// A warp's shared-memory slice: subj, key, pb, sl, ins_subj, ins_key, pos.
__host__ __device__ __forceinline__ size_t slice_bytes(int c, int ki) {
  return 2 * staged_bytes(4 * (size_t)c) + 2 * staged_bytes((size_t)c) +
         2 * staged_bytes(4 * (size_t)ki) + ((4 * (size_t)ki + 15) & ~size_t{15});
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// The lanes of a warp copy src[0, bytes) into buf (16-byte aligned) at the
// offset that matches src's 16-byte phase, and return the copy's start:
// the body by 16-byte cp.async; the head and tail by 4-byte cp.async when
// src and bytes are multiples of 4 (every int32 row, and the int8 rows
// when C % 4 == 0), else byte by byte.
__device__ __forceinline__ const char* stage(char* buf, const char* src, int bytes, int lane) {
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  char* dst = buf + phase;
  const int head = min((16 - phase) & 15, bytes);
  const int body = (bytes - head) >> 4;
  const int tail = head + 16 * body;
  for (int v = lane; v < body; v += 32) cp_async16(dst + head + 16 * v, src + head + 16 * v);
  if (((phase | bytes) & 3) == 0) {
    if (4 * lane < head) cp_async4(dst + 4 * lane, src + 4 * lane);
    if (4 * lane < bytes - tail) cp_async4(dst + tail + 4 * lane, src + tail + 4 * lane);
  } else {
    if (lane < head) dst[lane] = src[lane];
    if (lane < bytes - tail) dst[tail + lane] = src[tail + lane];
  }
  return dst;
}

// Stages src[0, count) at buf as above and moves buf past its slot.
template <typename T>
__device__ __forceinline__ const T* stage_row(char*& buf, const T* src, int count, int lane) {
  const char* row =
      stage(buf, reinterpret_cast<const char*>(src), static_cast<int>(count * sizeof(T)), lane);
  buf += staged_bytes(count * sizeof(T));
  return reinterpret_cast<const T*>(row);
}

// Count of row[0, len) < q in a sorted row: the largest lo with row[lo - 1]
// < q, found in floor(log2(len)) + 1 steps.
__device__ __forceinline__ int lower_bound(const int* row, int len, int q) {
  int lo = 0;
  for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0; step >>= 1) {
    const int nxt = lo + step;
    if (nxt <= len && row[nxt - 1] < q) lo = nxt;
  }
  return lo;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ uint32_t pack4(const int8_t (&v)[kRun]) {
  return static_cast<uint8_t>(v[0]) | static_cast<uint32_t>(static_cast<uint8_t>(v[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(v[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(v[3])) << 24;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
merge_insert_kernel(const int* __restrict__ d_subj, const int* __restrict__ d_key,
                    const int8_t* __restrict__ d_pb, const int8_t* __restrict__ d_sl,
                    const int* __restrict__ ins_subj, const int* __restrict__ ins_key,
                    int* __restrict__ o_subj, int* __restrict__ o_key,
                    int8_t* __restrict__ o_pb, int8_t* __restrict__ o_sl,
                    int* __restrict__ scratch, int n, int c, int ki, int sl_start, int suspect,
                    int pos_in_smem) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;  // the kernel synchronises warps, never the block
  const size_t tb = (size_t)row * c;
  const size_t ib = (size_t)row * ki;
  const int* subj = d_subj + tb;
  const int* key = d_key + tb;
  const int8_t* pb = d_pb + tb;
  const int8_t* sl = d_sl + tb;
  const int* isubj = ins_subj + ib;
  const int* ikey = ins_key + ib;
  int* pos;
  if (kStaged) {
    char* buf = smem + warp * slice_bytes(c, ki);
    subj = stage_row(buf, subj, c, lane);
    key = stage_row(buf, key, c, lane);
    pb = stage_row(buf, pb, c, lane);
    sl = stage_row(buf, sl, c, lane);
    isubj = stage_row(buf, isubj, ki, lane);
    ikey = stage_row(buf, ikey, ki, lane);
    pos = reinterpret_cast<int*>(buf);
    cp_async_wait_all();
    __syncwarp();
  } else {
    pos = pos_in_smem ? reinterpret_cast<int*>(smem) + (size_t)warp * ki : scratch + ib;
  }

  // 1. merged position of every insert
  for (int k = lane; k < ki; k += 32) pos[k] = lower_bound(subj, c, isubj[k]) + k;
  __syncwarp();

  // 2. runs of kRun adjacent output slots, walked forward from the count of
  // inserts before each run
  int* os = o_subj + tb;
  int* ok = o_key + tb;
  int8_t* op = o_pb + tb;
  int8_t* ol = o_sl + tb;
  for (int j0 = kRun * lane; j0 < c; j0 += 32 * kRun) {
    int e = lower_bound(pos, ki, j0);
    int vs[kRun] = {};
    int vk[kRun] = {};
    int8_t vp[kRun] = {};
    int8_t vl[kRun] = {};
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int j = j0 + i;
      if (j >= c) break;
      if (e < ki && pos[e] == j) {
        vs[i] = isubj[e];
        vk[i] = ikey[e];
        const bool live = vs[i] < kSentinel;
        vp[i] = live ? 0 : -1;
        vl[i] = (live && (vk[i] & 7) == suspect) ? static_cast<int8_t>(sl_start) : -1;
        ++e;
      } else {
        const int x = j - e;  // e <= j, so x is in [0, c)
        vs[i] = subj[x];
        vk[i] = key[x];
        vp[i] = pb[x];
        vl[i] = sl[x];
      }
    }
    if (j0 + kRun <= c && aligned(os + j0, 16) && aligned(ok + j0, 16)) {
      *reinterpret_cast<int4*>(os + j0) = make_int4(vs[0], vs[1], vs[2], vs[3]);
      *reinterpret_cast<int4*>(ok + j0) = make_int4(vk[0], vk[1], vk[2], vk[3]);
    } else {
      for (int i = 0; i < kRun && j0 + i < c; ++i) {
        os[j0 + i] = vs[i];
        ok[j0 + i] = vk[i];
      }
    }
    if (j0 + kRun <= c && aligned(op + j0, 4) && aligned(ol + j0, 4)) {
      *reinterpret_cast<uint32_t*>(op + j0) = pack4(vp);
      *reinterpret_cast<uint32_t*>(ol + j0) = pack4(vl);
    } else {
      for (int i = 0; i < kRun && j0 + i < c; ++i) {
        op[j0 + i] = vp[i];
        ol[j0 + i] = vl[i];
      }
    }
  }
}

bool pos_fits_smem(int ki) { return (size_t)kWarps * ki * sizeof(int) <= kSmemLimit; }

}  // namespace

// 1 when rp_merge_insert needs a global scratch buffer for insert width ki.
extern "C" int rp_merge_insert_needs_scratch(int ki) { return pos_fits_smem(ki) ? 0 : 1; }

// Tables int32/int32/int8/int8 [n, c], insert lists int32 [n, ki], outputs
// like the tables, scratch int32 [n, ki] (used only when
// rp_merge_insert_needs_scratch(ki); may be null otherwise); all row-major
// and contiguous.  Launches on `stream`; returns the CUDA error code of the
// launch.
extern "C" int rp_merge_insert(const void* d_subj, const void* d_key, const void* d_pb,
                               const void* d_sl, const void* ins_subj, const void* ins_key,
                               void* o_subj, void* o_key, void* o_pb, void* o_sl,
                               void* scratch, int n, int c, int ki, int sl_start,
                               int suspect, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (ki <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t staged = kWarps * slice_bytes(c, ki);
  const bool stage_rows = staged <= kSmemLimit;
  const int pos_in_smem = !stage_rows && pos_fits_smem(ki) ? 1 : 0;
  if (!stage_rows && !pos_in_smem && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = stage_rows ? staged : pos_in_smem ? (size_t)kWarps * ki * sizeof(int) : 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RP_MERGE_INSERT_ARGS                                                              \
  static_cast<const int*>(d_subj), static_cast<const int*>(d_key),                        \
      static_cast<const int8_t*>(d_pb), static_cast<const int8_t*>(d_sl),                 \
      static_cast<const int*>(ins_subj), static_cast<const int*>(ins_key),                \
      static_cast<int*>(o_subj), static_cast<int*>(o_key), static_cast<int8_t*>(o_pb),    \
      static_cast<int8_t*>(o_sl), static_cast<int*>(scratch), n, c, ki, sl_start, suspect, \
      pos_in_smem
  if (stage_rows) {
    merge_insert_kernel<true><<<blocks, kThreads, smem, s>>>(RP_MERGE_INSERT_ARGS);
  } else {
    merge_insert_kernel<false><<<blocks, kThreads, smem, s>>>(RP_MERGE_INSERT_ARGS);
  }
#undef RP_MERGE_INSERT_ARGS
  return static_cast<int>(cudaGetLastError());
}
