// The exact straw2 draw shared by the straw2 kernels (straw2.cu) and the
// approx-filter root (straw2_filter.cu): rjenkins hash32_3, crush_ln as
// 2^48 - ln in u64, and the u64 quotient whose least value is the straw2
// winner (see straw2.cu for the derivation), taken by multiplying with the
// weight's magic pair (straw2_qm: no 64-bit divide).  The group of lanes
// that shares one (x, r) merges its winners with merge_least.  hash32_2 is
// the is_out hash that the consume kernel (straw2.cu) computes itself.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kHashSeed = 1315423911u;
constexpr int32_t kItemNone = 0x7FFFFFFF;
constexpr int kLnEntries = 129 + 129 + 256;   // RH | LH | LL
constexpr int kNoPos = 0x7FFFFFFF;            // no candidate: loses every tie
// the magic shift of a zero weight (quotient 2^64-1) and of weight 1
// (quotient P), as ops/straw2_cuda.magic_tables writes them
constexpr int kShiftZero = -1;
constexpr int kShiftOne = 64;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

// crush_hash32_2 (hash.c:38-50): the is_out hash of the consume kernel
__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

// crush_hash32_3 (hash.c:52-66)
__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^48 - crush_ln(u) for a 16-bit u (mapper.c:248-290)
__device__ __forceinline__ uint64_t ln_p48(uint32_t u, const uint64_t* tab) {
  uint32_t x = u + 1u;
  int64_t iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x & 0x1FFFFu) - 16;   // 16 - bit length
    x <<= bits;
    iexpon = 15 - bits;
  }
  const uint32_t k = (((x >> 8) << 1) - 256u) >> 1;
  const uint64_t rh = tab[k];
  const uint64_t lh = tab[129 + k];
  const uint32_t idx2 = (uint32_t)(((uint64_t)x * rh) >> 48) & 0xFFu;
  const uint64_t ll = tab[258 + idx2];
  const int64_t ln = (iexpon << 44) + (int64_t)((lh + ll) >> 4);
  return (uint64_t)((1ll << 48) - ln);
}

// the straw2 quotient of one item by magic division: floor(P / w) ==
// __umul64hi(P, m) >> s for every P <= 2^48, with (m, s) from
// straw2_cuda.magic_tables; 2^64-1 for a zero weight
__device__ __forceinline__ uint64_t straw2_qm(uint32_t x, int32_t id, uint32_t r,
                                              uint64_t m, int s,
                                              const uint64_t* tab) {
  if (s == kShiftZero) return ~0ull;
  const uint32_t u = hash32_3(x, (uint32_t)id, r) & 0xFFFFu;
  const uint64_t p = ln_p48(u, tab);
  return s == kShiftOne ? p : __umul64hi(p, m) >> s;
}

// the lexicographic least (q, pos) over the `width` lanes of a group
// (width a power of two, the group aligned within its warp): every lane
// of the group ends with it.  Positions differ, so this is the first
// minimum by quotient, the tie rule of bucket_straw2_choose.
__device__ __forceinline__ void merge_least(uint64_t& q, int& pos, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const uint64_t oq = __shfl_xor_sync(kFullMask, q, off);
    const int op = __shfl_xor_sync(kFullMask, pos, off);
    if (oq < q || (oq == q && op < pos)) {
      q = oq;
      pos = op;
    }
  }
}

__device__ __forceinline__ void load_ln(uint64_t* s_tab, const uint64_t* ln_tab) {
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_tab[i] = ln_tab[i];
}

int blocks_for(int64_t work) { return (int)((work + kThreads - 1) / kThreads); }

}  // namespace
