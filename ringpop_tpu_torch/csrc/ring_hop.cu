// One rightward ring hop of the sharded gossip plane, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/gossip_remote_copy.py (_hop_kernel
// via _hop_pallas_2d / _hop_pallas_one / _hop).  There each of D chips
// started one remote DMA of its int32 [r, c] block (padded to the (8, 128)
// tile) into its right neighbour's buffer, after a barrier semaphore, and
// waited on paired send/recv semaphores.  Two entry points here:
//
// rp_ring_hop: the D shards of the ring live on one card in one process as
// one contiguous stack [D, block_bytes], and one launch computes
// out[(i + 1) mod D] = in[i] for every shard i.
//
// rp_peer_hop: one process per shard (ops/peer_hop.py).  A rank writes its
// own block(s) straight into its right neighbour's receive buffer through a
// pointer that cudaIpcOpenMemHandle mapped into this process: the remote
// DMA of the TPU kernel.  Up to kMaxSegs tensors of one hop go in one
// launch, each at its own offset of the receive buffer.  The helpers below
// allocate the receive buffers (cudaMalloc, so that a handle names exactly
// the buffer and not a segment of a caching allocator), export their
// handles and open the neighbour's.  Ordering is the caller's: after the
// launch it synchronises its stream and meets the other ranks at a host
// barrier, in place of the barrier and send/recv semaphores, and two
// receive slots used in turn keep a write off a slot its receiver still
// reads.  No kernel waits on a flag written by another process (D
// contexts on one card are time-sliced, and such a wait can hang).
//
// What bounds both: bytes.  Each block is read once and written once; at
// the dense ring path's view plane (blocks of [2500, 10000] int32) that is
// 2 * 100 MB a block, about 0.06 ms a block at 3.35 TB/s.  No arithmetic.
//
// Design: a grid over (tiles, blocks).  Block (x, i) copies tiles of shard
// (or segment) i with a grid-stride loop, so each copy spreads over many
// SMs.  Each thread moves 16 bytes a step (int4) when the size and both
// base pointers are 16-byte multiples, else 4 bytes, else 1 byte: the
// width is picked per copy from what it allows, so a bool plane of odd size
// takes the byte path.  No dtype is widened (the TPU path widened every
// dtype to int32 first), so a bool plane moves a quarter of an int32
// plane's bytes.  There is no padding: the tail is masked by the loop
// bound.
//
// Across cards the same peer write goes over NVLink (the mapping opens
// with cudaIpcMemLazyEnablePeerAccess); interprocess events in place of the
// host barriers are deferred to that machine.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

namespace {

constexpr int kMaxSegs = 8;

struct Segs {
  const void* src[kMaxSegs];
  long long off[kMaxSegs];    // byte offset of each segment in the destination buffer
  long long bytes[kMaxSegs];
  int width[kMaxSegs];        // 16, 4 or 1 bytes a step
};

template <typename T>
__device__ __forceinline__ void copy_tiles(const void* src, void* dst, long long bytes) {
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(dst);
  const long long elems = bytes / (long long)sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < elems; i += stride) {
    o[i] = s[i];
  }
}

__global__ void __launch_bounds__(kThreads)
peer_hop_kernel(Segs segs, unsigned char* __restrict__ dst) {
  const int k = blockIdx.y;
  void* o = dst + segs.off[k];
  switch (segs.width[k]) {
    case 16: copy_tiles<int4>(segs.src[k], o, segs.bytes[k]); break;
    case 4: copy_tiles<int>(segs.src[k], o, segs.bytes[k]); break;
    default: copy_tiles<unsigned char>(segs.src[k], o, segs.bytes[k]); break;
  }
}

int width_of(const void* src, const void* dst, long long bytes) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  if (bytes % 16 == 0 && align % 16 == 0) return 16;
  if (bytes % 4 == 0 && align % 4 == 0) return 4;
  return 1;
}

}  // namespace

// Copy nseg local buffers src[k] (bytes[k] each) to dst + off[k], where dst
// is the neighbour's receive buffer as mapped by rp_ipc_open.  One launch on
// `stream`; returns its CUDA error code (cudaErrorInvalidValue for more
// than kMaxSegs segments).
extern "C" int rp_peer_hop(int nseg, const void* const* src, const long long* off,
                           const long long* bytes, void* dst, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > kMaxSegs) return static_cast<int>(cudaErrorInvalidValue);
  Segs segs = {};
  long long most = 0;
  unsigned char* base = static_cast<unsigned char*>(dst);
  for (int k = 0; k < nseg; ++k) {
    segs.src[k] = src[k];
    segs.off[k] = off[k];
    segs.bytes[k] = bytes[k];
    segs.width[k] = width_of(src[k], base + off[k], bytes[k]);
    const long long elems = bytes[k] / segs.width[k];
    if (elems > most) most = elems;
  }
  if (most == 0) return 0;
  long long tiles = (most + kThreads - 1) / kThreads;
  if (tiles > kMaxTilesPerShard) tiles = kMaxTilesPerShard;
  const dim3 grid((unsigned)tiles, (unsigned)nseg);
  peer_hop_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(segs, base);
  return static_cast<int>(cudaGetLastError());
}

// A receive buffer of `bytes` on card `device`, from cudaMalloc.
extern "C" int rp_ipc_alloc(int device, long long bytes, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, (size_t)bytes);
  return static_cast<int>(err);
}

extern "C" int rp_ipc_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

// The interprocess handle of a buffer from rp_ipc_alloc, as
// CUDA_IPC_HANDLE_SIZE (64) bytes written to `handle`.
extern "C" int rp_ipc_handle(int device, void* ptr, unsigned char* handle) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Map another process's buffer into this one, on card `device`.
extern "C" int rp_ipc_open(int device, const unsigned char* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(err);
}

extern "C" int rp_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

extern "C" int rp_ipc_handle_size() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }
