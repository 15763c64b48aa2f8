// FarmHash32 (farmhashmk Fingerprint32) of byte rows, on Hopper (sm_90a).
//
// Replaces the TPU kernel ringpop_tpu/ops/farmhash_pallas.py (_kernel via
// farmhash32_batch_pallas).  Row r of bufs[B, L] is hashed over its first
// lens[r] bytes, through all four length arms (0-4, 5-12, 13-24, >24) in
// one kernel; bit-identical to the host FarmHash in ops/farmhash.py.
//
// What bounds it: reading the bytes once (bytes), and, for long rows, the
// per-row dependency chain of the >24-byte arm: each 20-byte block updates
// (h, g, f) from the previous block's values, so a row of ~340 KB (a
// membership checksum string at n = 10000) is ~17000 dependent steps.
//
// Design: one thread per row, reading the row's bytes directly.  The TPU
// kernel laid rows out as word planes with masked reductions because the
// TPU has no cheap gathers; a CUDA thread simply loads the bytes it needs,
// and rows run in parallel across threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotr(uint32_t v, int s) {
  return s == 0 ? v : (v >> s) | (v << (32 - s));
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mur(uint32_t a, uint32_t h) {
  a *= kC1;
  a = rotr(a, 17);
  a *= kC2;
  h ^= a;
  h = rotr(h, 19);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fetch32(const uint8_t* __restrict__ p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

__device__ uint32_t hash_0_to_4(const uint8_t* s, uint32_t n) {
  uint32_t b = 0, c = 9;
  for (uint32_t i = 0; i < n; ++i) {
    const int8_t v = static_cast<int8_t>(s[i]);  // signed char semantics
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

__device__ uint32_t hash_long(const uint8_t* s, uint32_t n) {
  uint32_t h = n, g = kC1 * n, f = g;
  const uint32_t a0 = rotr(fetch32(s + n - 4) * kC1, 17) * kC2;
  const uint32_t a1 = rotr(fetch32(s + n - 8) * kC1, 17) * kC2;
  const uint32_t a2 = rotr(fetch32(s + n - 16) * kC1, 17) * kC2;
  const uint32_t a3 = rotr(fetch32(s + n - 12) * kC1, 17) * kC2;
  const uint32_t a4 = rotr(fetch32(s + n - 20) * kC1, 17) * kC2;
  h ^= a0;
  h = rotr(h, 19);
  h = h * 5u + 0xE6546B64u;
  h ^= a2;
  h = rotr(h, 19);
  h = h * 5u + 0xE6546B64u;
  g ^= a1;
  g = rotr(g, 19);
  g = g * 5u + 0xE6546B64u;
  g ^= a3;
  g = rotr(g, 19);
  g = g * 5u + 0xE6546B64u;
  f += a4;
  f = rotr(f, 19) + 113u;
  const uint32_t iters = (n - 1) / 20;
  for (uint32_t i = 0; i < iters; ++i) {
    const uint8_t* p = s + 20u * i;
    const uint32_t a = fetch32(p);
    const uint32_t b = fetch32(p + 4);
    const uint32_t c = fetch32(p + 8);
    const uint32_t d = fetch32(p + 12);
    const uint32_t e = fetch32(p + 16);
    h += a;
    g += b;
    f += c;
    h = mur(d, h) + e;
    g = mur(c, g) + a;
    f = mur(b + e * kC1, f) + d;
    f += g;
    g += f;
  }
  g = rotr(g, 11) * kC1;
  g = rotr(g, 17) * kC1;
  f = rotr(f, 11) * kC1;
  f = rotr(f, 17) * kC1;
  h = rotr(h + g, 19);
  h = h * 5u + 0xE6546B64u;
  h = rotr(h, 17) * kC1;
  h = rotr(h + f, 19);
  h = h * 5u + 0xE6546B64u;
  h = rotr(h, 17) * kC1;
  return h;
}

__global__ void __launch_bounds__(kThreads)
farmhash32_kernel(const uint8_t* __restrict__ bufs, const int* __restrict__ lens,
                  uint32_t* __restrict__ out, int rows, int64_t stride) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* s = bufs + (size_t)r * stride;
  const uint32_t n = static_cast<uint32_t>(lens[r]);
  uint32_t h;
  if (n <= 4) {
    h = hash_0_to_4(s, n);
  } else if (n <= 12) {
    h = hash_5_to_12(s, n);
  } else if (n <= 24) {
    h = hash_13_to_24(s, n);
  } else {
    h = hash_long(s, n);
  }
  out[r] = h;
}

}  // namespace

// bufs uint8[rows, stride] (row-major), lens int32[rows] with
// 0 <= lens[r] <= stride, out uint32[rows].  Launches on `stream`;
// returns the CUDA error code of the launch.
extern "C" int rp_farmhash32(const void* bufs, const void* lens, void* out,
                             int rows, long long stride, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  farmhash32_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bufs), static_cast<const int*>(lens),
      static_cast<uint32_t*>(out), rows, static_cast<int64_t>(stride));
  return static_cast<int>(cudaGetLastError());
}
