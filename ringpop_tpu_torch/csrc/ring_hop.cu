// One rightward ring hop of the sharded gossip plane, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/gossip_remote_copy.py (_hop_kernel
// via _hop_pallas_2d / _hop_pallas_one / _hop).  There each of D chips
// started one remote DMA of its int32 [r, c] block (padded to the (8, 128)
// tile) into its right neighbour's buffer, after a barrier semaphore, and
// waited on paired send/recv semaphores.  Here the D shards of the ring
// live on one card as one contiguous stack [D, block_bytes], and one launch
// computes out[(i + 1) mod D] = in[i] for every shard i.
//
// What bounds it: bytes.  Each block is read once and written once,
// 2 * D * block_bytes in all; at the dense ring path's view plane (D = 4
// blocks of [2500, 10000] int32) that is 0.8 GB, about 0.24 ms at 3.35 TB/s.
// It does no arithmetic.
//
// Design: a grid over (tiles, D).  Block (x, i) copies tiles of shard i's
// block into shard i + 1's slot with a grid-stride loop, so each shard's
// copy spreads over many SMs.  Each thread moves 16 bytes a step (int4)
// when the block size and both base pointers are 16-byte multiples, else
// 4 bytes, else 1 byte: the width is picked per launch from what the
// stack allows, so a bool plane of odd size takes the byte path.  No
// dtype is widened (the TPU path widened every dtype to int32 first), so
// a bool plane moves a quarter of an int32 plane's bytes.  There is no
// padding: offsets are computed from the block size and the tail is
// masked by the loop bound.
//
// Ordering: the wrapper (ops/gossip_remote_copy.py) writes each hop into a
// fresh output stack on the current stream, never into its input, which on
// one card gives the ordering the barrier semaphore gave on the TPU.
// Deferred to a machine with several cards: the peer write into another
// card's buffer (peer access or symmetric-memory pointers) with an event
// each way in place of the barrier and the semaphores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxTilesPerShard = 2048;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_hop_kernel(const T* __restrict__ in, T* __restrict__ out, long long block_elems, int d) {
  const int src = blockIdx.y;
  const int dst = (src + 1 == d) ? 0 : src + 1;
  const T* s = in + (size_t)src * block_elems;
  T* o = out + (size_t)dst * block_elems;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < block_elems;
       i += stride) {
    o[i] = s[i];
  }
}

template <typename T>
int launch(const void* in, void* out, long long block_bytes, int d, cudaStream_t stream) {
  const long long elems = block_bytes / (long long)sizeof(T);
  long long tiles = (elems + kThreads - 1) / kThreads;
  if (tiles > kMaxTilesPerShard) tiles = kMaxTilesPerShard;
  const dim3 grid((unsigned)tiles, (unsigned)d);
  ring_hop_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), elems, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in, out: contiguous stacks of d blocks of block_bytes each (distinct
// buffers).  Launches on `stream`; returns the CUDA error code of the launch
// (cudaErrorInvalidValue for more shards than a grid's y dimension holds).
extern "C" int rp_ring_hop(const void* in, void* out, long long block_bytes, int d,
                           void* stream) {
  if (d <= 0 || block_bytes <= 0) return 0;
  if (d > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  if (block_bytes % 16 == 0 && align % 16 == 0) return launch<int4>(in, out, block_bytes, d, st);
  if (block_bytes % 4 == 0 && align % 4 == 0) return launch<int>(in, out, block_bytes, d, st);
  return launch<unsigned char>(in, out, block_bytes, d, st);
}
