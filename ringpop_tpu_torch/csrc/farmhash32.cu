// FarmHash32 (farmhashmk Fingerprint32) of byte rows, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/farmhash_pallas.py (_kernel via
// farmhash32_batch_pallas).  Row r of bufs (row r starts at r * stride, any
// stride) is hashed over its first lens[r] bytes, through all four length
// arms (0-4, 5-12, 13-24, >24) in one kernel; bit-identical to the host
// FarmHash in ops/farmhash.py.
//
// What bounds it: the per-row dependency chain of the >24-byte arm.  Each
// 20-byte block updates (h, g, f) from the previous block's values, so a
// row of ~300 KB (a membership checksum string at n = 10000) is ~15000
// dependent steps of about 7 dependent integer operations; that chain, not
// the bytes, sets the least time (about 0.21 ms for the dense path's
// chunk at the card's top clock, against 0.016 ms to read its 56 MB once).
//
// Design: the chain of one row cannot be split, so the kernel makes each
// row's serial walk run at the speed of its chain and spreads rows over the
// card.  (One thread per row would put a 186-row chunk on two SMs, each
// thread waiting on dependent byte loads, a warp's load touching 32 rows ~300
// KB apart.)  One warp owns one row, four rows to a 128-thread block, so a
// 186-row chunk spreads over 47 SMs.  The row streams through the warp's
// shared memory in tiles of 128 blocks (2560 bytes): the warp copies each
// tile with 16-byte cp.async copies from the 16-byte-aligned address at or
// below its start (rows start at any byte), double-buffered, so tile t + 1 is
// in flight while tile t is hashed.  All 32 lanes then premix the tile: they
// assemble the five little-endian words of each block with funnel shifts (the
// row's byte phase is the same for every tile) and compute the data-only half
// of each mur, rotr(x * c1, 17) * c2, and the constant addends, into
// per-block records.  Lane 0 then walks the tile doing only the
// chain-dependent part (the adds, the xor, rotr(., 19), . * 5 + addend, and
// the f += g; g += f coupling), unrolled by 8 so that its record loads run
// ahead of the chain.  Lane 0 also reads the head words (the last 20 bytes),
// hashes rows of at most 24 bytes, and does the final mix. The TPU kernel
// laid rows out as word planes with masked reductions because the TPU has no
// cheap gathers; it walked every row in lockstep at the longest row's length.
//
// A second entry point, rp_farmhash32_short, serves batches whose rows are
// all at most 24 bytes (replica names and keys of the hash ring): no chain,
// so the bytes bound it (about 37 bytes a row with the int64 output).  The
// warp kernel would give each such row a warp that uses one lane and
// reserves its shared-memory tiles, so about 20 rows fit on an SM at once.
// The short kernel runs one thread per row and reserves no shared memory:
// consecutive threads hash consecutive rows, so a warp's byte loads fall in
// one contiguous span of about 32 rows (800 bytes at 25-byte rows) that
// the L1 serves after its first touch of each line.  It writes each hash
// zero-extended to int64, the type the wrapper returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kMagic = 0xE6546B64u;
constexpr int kWarps = 4;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBlocks = 128;  // 20-byte blocks per tile
constexpr int kTileBytes = 20 * kTileBlocks;
// 16-byte chunks a tile can touch from its aligned-down start, plus one
// so that the word after the tile's last word can be read
constexpr int kRawChunks = (kTileBytes + 15 + 15) / 16 + 1;

// One warp's shared memory: two raw tiles and the premixed records of one.
struct alignas(16) WarpTiles {
  uint4 raw[2][kRawChunks];
  uint4 pa[kTileBlocks];  // a, A(d), magic + e, b
  uint4 pb[kTileBlocks];  // A(c), magic + a, c, A(b + e * c1)
  uint32_t pc[kTileBlocks];  // magic + d
};

__device__ __forceinline__ uint32_t rotr(uint32_t v, int s) {
  return __funnelshift_r(v, v, s);
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the data-only half of mur
__device__ __forceinline__ uint32_t premur(uint32_t a) { return rotr(a * kC1, 17) * kC2; }

__device__ __forceinline__ uint32_t mur(uint32_t a, uint32_t h) {
  return rotr(h ^ premur(a), 19) * 5u + kMagic;
}

__device__ __forceinline__ uint32_t fetch32(const uint8_t* __restrict__ p) {
  return (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + 1) << 8) | ((uint32_t)__ldg(p + 2) << 16) |
         ((uint32_t)__ldg(p + 3) << 24);
}

__device__ uint32_t hash_0_to_4(const uint8_t* s, uint32_t n) {
  uint32_t b = 0, c = 9;
  for (uint32_t i = 0; i < n; ++i) {
    const int8_t v = static_cast<int8_t>(__ldg(s + i));  // signed char semantics
    b = b * kC1 + static_cast<uint32_t>(static_cast<int32_t>(v));
    c ^= b;
  }
  return fmix(mur(b, mur(n, c)));
}

__device__ uint32_t hash_5_to_12(const uint8_t* s, uint32_t n) {
  const uint32_t a = n + fetch32(s);
  const uint32_t b = n * 5u + fetch32(s + n - 4);
  const uint32_t c = 9u + fetch32(s + ((n >> 1) & 4));
  const uint32_t d = n * 5u;
  return fmix(mur(c, mur(b, mur(a, d))));
}

__device__ uint32_t hash_13_to_24(const uint8_t* s, uint32_t n) {
  uint32_t a = fetch32(s + (n >> 1) - 4);
  const uint32_t b = fetch32(s + 4);
  const uint32_t c = fetch32(s + n - 8);
  const uint32_t d = fetch32(s + (n >> 1));
  const uint32_t e = fetch32(s);
  const uint32_t f = fetch32(s + n - 4);
  uint32_t h = d * kC1 + n;
  a = rotr(a, 12) + f;
  h = mur(c, h) + a;
  a = rotr(a, 3) + c;
  h = mur(e, h) + a;
  a = rotr(a + f, 12) + d;
  h = mur(b, h) + a;
  return fmix(h);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The warp starts copying `bytes` bytes at `src` into `raw` as whole
// 16-byte chunks from the aligned address at or below src; src's byte
// phase (src & 15) is then its offset in raw.  Every chunk holds a byte of
// the row, so no copy leaves the row's 16-byte-aligned span.
__device__ __forceinline__ void stage_tile(uint4* raw, const uint8_t* src, int bytes, int lane) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(src);
  const uint4* from = reinterpret_cast<const uint4*>(start & ~static_cast<uintptr_t>(15));
  const int chunks = static_cast<int>(((start & 15) + bytes + 15) >> 4);
  for (int v = lane; v < chunks; v += 32) cp_async16(raw + v, from + v);
}

// All lanes: the records of the tile's `blocks` blocks, whose bytes sit
// at byte `phase` of raw.
__device__ __forceinline__ void premix_tile(WarpTiles& w, const uint4* raw, int phase,
                                            int blocks, int lane) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(raw) + (phase >> 2);
  const int shift = (phase & 3) * 8;
  for (int i = lane; i < blocks; i += 32) {
    const uint32_t* p = words + 5 * i;
    uint32_t v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = p[k];
    const uint32_t a = __funnelshift_r(v[0], v[1], shift);
    const uint32_t b = __funnelshift_r(v[1], v[2], shift);
    const uint32_t c = __funnelshift_r(v[2], v[3], shift);
    const uint32_t d = __funnelshift_r(v[3], v[4], shift);
    const uint32_t e = __funnelshift_r(v[4], v[5], shift);
    w.pa[i] = make_uint4(a, premur(d), kMagic + e, b);
    w.pb[i] = make_uint4(premur(c), kMagic + a, c, premur(b + e * kC1));
    w.pc[i] = kMagic + d;
  }
}

// Lane 0: the chain-dependent half of `blocks` blocks.
__device__ __forceinline__ void walk_tile(const WarpTiles& w, int blocks, uint32_t& h,
                                          uint32_t& g, uint32_t& f) {
#pragma unroll 8
  for (int i = 0; i < blocks; ++i) {
    const uint4 x = w.pa[i];
    const uint4 y = w.pb[i];
    const uint32_t z = w.pc[i];
    h = rotr((h + x.x) ^ x.y, 19) * 5u + x.z;
    const uint32_t g1 = rotr((g + x.w) ^ y.x, 19) * 5u + y.y;
    const uint32_t f1 = rotr((f + y.z) ^ y.w, 19) * 5u + z;
    f = f1 + g1;
    g = g1 + f;
  }
}

__global__ void __launch_bounds__(kThreads)
farmhash32_kernel(const uint8_t* __restrict__ bufs, const int* __restrict__ lens,
                  uint32_t* __restrict__ out, int rows, int64_t stride) {
  __shared__ WarpTiles tiles[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  const uint8_t* s = bufs + (int64_t)r * stride;
  const uint32_t n = static_cast<uint32_t>(__ldg(lens + r));
  if (n <= 24) {
    if (lane == 0) {
      out[r] = n <= 4 ? hash_0_to_4(s, n) : n <= 12 ? hash_5_to_12(s, n) : hash_13_to_24(s, n);
    }
    return;
  }

  WarpTiles& w = tiles[warp];
  const int blocks = static_cast<int>((n - 1) / 20);  // the walk covers bytes [0, 20 * blocks)
  const int ntiles = (blocks + kTileBlocks - 1) / kTileBlocks;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(s) & 15);
  stage_tile(w.raw[0], s, 20 * min(blocks, kTileBlocks), lane);
  cp_async_commit();

  uint32_t h = n, g = kC1 * n, f = g;
  if (lane == 0) {  // the head words, while tile 0 is in flight
    h = rotr(h ^ premur(fetch32(s + n - 4)), 19) * 5u + kMagic;
    h = rotr(h ^ premur(fetch32(s + n - 16)), 19) * 5u + kMagic;
    g = rotr(g ^ premur(fetch32(s + n - 8)), 19) * 5u + kMagic;
    g = rotr(g ^ premur(fetch32(s + n - 12)), 19) * 5u + kMagic;
    f = rotr(f + premur(fetch32(s + n - 20)), 19) + 113u;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int done = t * kTileBlocks;
    if (t + 1 < ntiles) {
      const int next = min(blocks - done - kTileBlocks, kTileBlocks);
      stage_tile(w.raw[(t + 1) & 1], s + (size_t)20 * (done + kTileBlocks), 20 * next, lane);
    }
    cp_async_commit();
    cp_async_wait_prior();  // tile t has landed
    __syncwarp();
    const int nb = min(blocks - done, kTileBlocks);
    premix_tile(w, w.raw[t & 1], phase, nb, lane);
    __syncwarp();
    if (lane == 0) walk_tile(w, nb, h, g, f);
    __syncwarp();  // the records and tile t's buffer are free again
  }
  if (lane == 0) {
    g = rotr(g, 11) * kC1;
    g = rotr(g, 17) * kC1;
    f = rotr(f, 11) * kC1;
    f = rotr(f, 17) * kC1;
    h = rotr(h + g, 19);
    h = h * 5u + kMagic;
    h = rotr(h, 17) * kC1;
    h = rotr(h + f, 19);
    h = h * 5u + kMagic;
    h = rotr(h, 17) * kC1;
    out[r] = h;
  }
}

constexpr int kShortThreads = 256;

// One thread per row of at most 24 bytes: the three short arms.
__global__ void __launch_bounds__(kShortThreads)
farmhash32_short_kernel(const uint8_t* __restrict__ bufs, const int* __restrict__ lens,
                        long long* __restrict__ out, int rows, int64_t stride) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kShortThreads + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* s = bufs + r * stride;
  const uint32_t n = static_cast<uint32_t>(__ldg(lens + r));
  const uint32_t h =
      n <= 4 ? hash_0_to_4(s, n) : n <= 12 ? hash_5_to_12(s, n) : hash_13_to_24(s, n);
  out[r] = static_cast<long long>(h);
}

}  // namespace

// bufs uint8 rows, row r at bufs + r * stride (stride >= 0, any value),
// lens int32[rows] with 0 <= lens[r] <= the row's width, out uint32[rows].
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int rp_farmhash32(const void* bufs, const void* lens, void* out,
                             int rows, long long stride, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarps - 1) / kWarps;
  farmhash32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bufs), static_cast<const int*>(lens),
      static_cast<uint32_t*>(out), rows, static_cast<int64_t>(stride));
  return static_cast<int>(cudaGetLastError());
}

// bufs, lens and stride as above, every lens[r] <= 24; out int64[rows]
// holding each row's uint32 hash.  One thread per row, 256 to a block, no
// shared memory.
extern "C" int rp_farmhash32_short(const void* bufs, const void* lens, void* out,
                                   int rows, long long stride, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kShortThreads - 1) / kShortThreads;
  farmhash32_short_kernel<<<blocks, kShortThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bufs), static_cast<const int*>(lens),
      static_cast<long long*>(out), rows, static_cast<int64_t>(stride));
  return static_cast<int>(cudaGetLastError());
}

// 20-byte blocks per shared-memory tile, for the wrapper to check against
// the tile size its callers and tests are written for.
extern "C" int rp_farmhash32_tile_blocks() { return kTileBlocks; }
