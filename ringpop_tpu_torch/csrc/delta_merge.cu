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
// output channels once; the position arithmetic is a few binary searches
// per slot.
//
// Design: the TPU kernel had no gathers, so it computed each insert's merged
// position with a compare-reduce over the row and fetched the existing-side
// payload through one lane roll per possible shift distance (K + 1 passes).
// A CUDA thread can index memory directly, so one block owns one row and
// does the merge inversion:
//   1. insert k's merged position pos[k] = #(table subjects < ins_subj[k]) + k,
//      by binary search of the row (positions are strictly increasing in k);
//   2. for output slot j, e = #(pos < j), by binary search of pos: the slot
//      is insert e when pos[e] == j, else existing slot j - e.
// Each output element is written exactly once, with no atomics.  pos lives
// in shared memory when ki * 4 bytes fit in the 48 KB a block gets without
// opting in, else in a global scratch row the wrapper allocates.  Every ki
// from 1 upward and every C from 1 upward is handled by loops, nothing is
// unrolled over ki.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;
constexpr int kSentinel = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
merge_insert_kernel(const int* __restrict__ d_subj, const int* __restrict__ d_key,
                    const int8_t* __restrict__ d_pb, const int8_t* __restrict__ d_sl,
                    const int* __restrict__ ins_subj, const int* __restrict__ ins_key,
                    int* __restrict__ o_subj, int* __restrict__ o_key,
                    int8_t* __restrict__ o_pb, int8_t* __restrict__ o_sl,
                    int* __restrict__ scratch, int c, int ki, int sl_start, int suspect,
                    int pos_in_smem) {
  extern __shared__ int spos[];
  const size_t row = blockIdx.x;
  const size_t tbase = row * (size_t)c;
  const size_t ibase = row * (size_t)ki;
  const int* srow = d_subj + tbase;
  int* pos = pos_in_smem ? spos : scratch + ibase;

  // 1. merged position of every insert
  for (int k = threadIdx.x; k < ki; k += blockDim.x) {
    const int q = __ldg(ins_subj + ibase + k);
    int lo = 0;
    int hi = c;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(srow + mid) < q) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos[k] = lo + k;
  }
  __syncthreads();

  // 2. invert the merge per output slot
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    int lo = 0;
    int hi = ki;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (pos[mid] < j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int e = lo;  // inserts landing before slot j
    int subj;
    int key;
    int8_t pb;
    int8_t sl;
    if (e < ki && pos[e] == j) {
      subj = __ldg(ins_subj + ibase + e);
      key = __ldg(ins_key + ibase + e);
      const bool live = subj < kSentinel;
      pb = live ? 0 : -1;
      sl = (live && (key & 7) == suspect) ? static_cast<int8_t>(sl_start) : -1;
    } else {
      const size_t x = tbase + (j - e);  // e <= j, so j - e is in [0, c)
      subj = __ldg(d_subj + x);
      key = __ldg(d_key + x);
      pb = d_pb[x];
      sl = d_sl[x];
    }
    o_subj[tbase + j] = subj;
    o_key[tbase + j] = key;
    o_pb[tbase + j] = pb;
    o_sl[tbase + j] = sl;
  }
}

int merge_insert_pos_in_smem(int ki) {
  return (size_t)ki * sizeof(int) <= (size_t)kSmemLimit ? 1 : 0;
}

}  // namespace

// 1 when rp_merge_insert needs a global scratch buffer for insert width ki.
extern "C" int rp_merge_insert_needs_scratch(int ki) {
  return merge_insert_pos_in_smem(ki) ? 0 : 1;
}

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
  const int pos_in_smem = merge_insert_pos_in_smem(ki);
  if (!pos_in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pos_in_smem ? (size_t)ki * sizeof(int) : 0;
  merge_insert_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d_subj), static_cast<const int*>(d_key),
      static_cast<const int8_t*>(d_pb), static_cast<const int8_t*>(d_sl),
      static_cast<const int*>(ins_subj), static_cast<const int*>(ins_key),
      static_cast<int*>(o_subj), static_cast<int*>(o_key), static_cast<int8_t*>(o_pb),
      static_cast<int8_t*>(o_sl), static_cast<int*>(scratch), c, ki, sl_start, suspect,
      pos_in_smem);
  return static_cast<int>(cudaGetLastError());
}
