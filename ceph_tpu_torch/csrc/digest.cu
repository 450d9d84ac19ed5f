// The deep-scrub integrity digest (ops/checksum_kernel.py): scrub_digest.
//
// It replaces the JAX package's jitted digest,
// ceph_tpu/ops/checksum_kernel.py:286 _jit_digest (reached through
// scrub_digest_batched), which XLA ran as a jax.lax.scan of W/4 sequential
// steps: one slicing-by-4 crc32 step and one 4-lane GF(2^8) Horner step a
// 4-byte word.  It computes exactly that function of (S, W) zero-padded
// rows, the per-row unpad matrices `mats` (S, 32) and lane multipliers
// `invp` (S, 4): out[i] = (zlib crc32 of row[:L_i], packed GF digest).
//
// Bound: bytes.  The function needs each row only up to its length, plus
// 132 bytes of operands and 4 of length a row, and writes 8 bytes a row.
// With no lengths it reads all S*W bytes: (32, 2^22) at 3.35 TB/s takes at
// least 40 us; with half the rows under 64 bytes (a scrub chunk: each
// object's data row and its omap row) 20 us.  Given `lens`, the kernel
// reads a lane's chunks (16 bytes) only below L_i, except the first chunk
// of each warp's first item, loaded before its length is known: 512 bytes
// a warp whatever the length (at most 132 x 32 warps x 512 B = 2.1 MB a
// launch).  Rows under 512 bytes are read whole.
// Against that, about 1.25 shared-memory table lookups and 5.5 integer
// instructions a byte, which stay under the SM's shared-memory and issue
// rates only if the lookups are nearly free of bank conflicts.
//
// The scan is a chain, but both digests are linear across a split
// (checksum_kernel.py's module note), so the chain is cut:
//
// * A warp item is 32 * run bytes of a row (run a power of two from 16 to
//   1,024, picked by the wrapper so that one wave of lanes covers the
//   batch: digest_cuda.run_bytes).  Every load of the warp reads 512
//   contiguous bytes straight into registers, lane l the 16-byte chunks
//   l, l + 32, l + 64, ... of the item, the next chunk loaded while this
//   one is digested (across items too); no shared-memory staging.  A
//   lane digests its chunks from a zero register and zero GF lanes as the
//   item with every other lane's chunks zeroed: after a chunk's last word
//   the crc register crosses the other lanes' 31 chunks (496 bytes) in the
//   same lookups, through slicing tables of Z^(4 + 496) instead of Z^4,
//   and before a chunk each GF lane is multiplied by alpha^124 (one lookup
//   a byte).  The first version gave each lane 64 contiguous bytes from a
//   tile staged in shared memory; the A/B of this design's first form,
//   each lane's run contiguous in memory (warp loads 32 sectors apart),
//   found the loads alone at 40% of the memory's rate (PERF.md).
// * Lookups without bank conflicts: the tables sit in shared memory
//   kCopies times (16: 144 KiB), entry (k, v) of copy c at
//   word ((k << 8 | v) * kCopies + c), and lane l reads copy l % kCopies,
//   so only lanes l and l + 16 can meet in a bank.  One block of 1,024
//   threads an SM, dynamic shared memory above 48 KB.  The GF lanes step
//   by shifts and masks.
// * Joins in registers: the 32 lanes' registers join by a 5-level
//   __shfl_down_sync tree, no barrier.  At level k the left lanes' last
//   chunks end 16 * 2^k bytes before the right lanes', so the left crc
//   register crosses Z^(16 * 2^k) by four byte-sliced lookups into that
//   level's 4 x 256 table (zbytes), each GF lane alpha^(4 * 2^k).
// * The split: scrub_digest_plan picks run for a batch and the card and
//   names the scratch it needs; the launcher checks the same split.
// * One kernel for every width, persistent blocks: gridDim = the SMs'
//   slots, and warp w of block b walks the items b + gridDim * (w + 32 i),
//   so consecutive items land on different SMs.  A warp loads the next
//   item's first chunks as soon as it has digested this item's, before
//   this item's joins.  A row of W = 32 * run bytes is one item, finished
//   by its warp.  A wider row has W / (32 run) items: each moves its span
//   across the rest of the padded row (d items: one distributed
//   application of Z^(32 run 2^i) for each set bit i of d, a lane a column
//   and a 5-step __shfl_xor_sync sum; alpha^(d * 8 run) on the GF lanes)
//   and leaves it in `scratch`; a second launch, digest_join_kernel (a
//   name without "scrub_digest", so that a trace counts one
//   scrub_digest_kernel a call), XORs each such row's spans (a row's
//   digest is the XOR of its items' shifted spans) and finishes it, a
//   warp a row.  The A/B's one-launch
//   form, where each item XORed its span into the row's accumulator with
//   atomicXor and the item that counted in last (atomicAdd after a
//   __threadfence) finished the row, was slower at every shape: each item
//   waited on the fence and the count.  Rows under 512 bytes are a lane's
//   each, read whole, and finished by it.
// * Zero tails skipped by length: a chunk at or past L_i is not read (its
//   zeros are digested; only a warp's first chunk is loaded before L_i is
//   known), and an item past L_i is not walked at all; the
//   joins and shifts carry every span across the zeros behind it, so for
//   zero-padded rows the result is bit for bit the whole-row digest.
// * A row's finish: XOR in Z^W * 0xFFFFFFFF (the initial register's part),
//   apply the row's mats (Z^-(W-L): strips the padding), XOR 0xFFFFFFFF,
//   and multiply each lane by its invp (a warp a row: a lane a column of
//   mats, GF products by shifts and masks, no dependent table loads).
//
// ab_kernels.py --kernels scrub_digest times this kernel against another
// checkout's and against its design variants (DIGEST_VARIANTS there: this
// file with a few lines replaced, built alone: fewer table copies, the
// loads alone, the stages alone); what won and what lost is in PERF.md.
//
// tests/test_torch_digest_host.py compiles this file with g++ behind a
// header that defines the CUDA names it uses as host code (a std::thread
// per CUDA thread, barriers for __syncthreads and each warp's shuffles,
// DIGEST_SHARED_TABLES for the dynamic shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int lg2(int v) { return v > 1 ? 1 + lg2(v >> 1) : 0; }

constexpr int kThreads = 1024;              // threads of a block
constexpr int kLanes = 32;
constexpr int kCopies = 16;                 // copies of the lookup tables
constexpr int kLgCopies = lg2(kCopies);
constexpr int kTreeLevels = 5;              // log2(kLanes)
constexpr int kMaxLevels = 20;              // log2(2^22 / 16) = 18 at most
constexpr int kMinRun = 16, kMaxRun = 1024;
constexpr int kPickMin = 64;                // the least run the plan picks
constexpr int kChunk = 16;                  // bytes a lane loads at once
constexpr int kInterleaved = kLanes * kChunk;  // rows from here on
constexpr unsigned kFull = 0xffffffffu;
static_assert((1 << kLgCopies) == kCopies, "kCopies: a power of two");

struct Tables {
  // [0]: the slicing-by-4 crc tables, Z^4 of each byte of a word; [1]: the
  // same for Z^(4 + 496), a chunk's last word with the 31 chunks of the
  // other lanes behind it.  Entry (k, v), copy c at ((k << 8 | v) << lg) | c
  uint32_t crc[2][4 * 256 * kCopies];
  uint32_t gm[256 * kCopies];       // alpha^124 * b, in each byte of a word
  uint32_t zb[kTreeLevels][4][256];  // tree level k: Z^(16 * 2^k), by byte
  uint32_t zc[kMaxLevels][32];      // level k: the columns of Z^(run 2^k)
  uint8_t exp[512];                 // alpha^i, periodic past 255
  uint8_t log[256];                 // log[0] unused
};
static_assert(sizeof(Tables) <= 227 * 1024, "a block's shared memory");

}  // namespace

#ifndef DIGEST_SHARED_TABLES
// the block's tables, in dynamic shared memory (above 48 KB)
#define DIGEST_SHARED_TABLES(name)                                  \
  extern __shared__ __align__(16) unsigned char name##_bytes[];    \
  Tables& name = *reinterpret_cast<Tables*>(name##_bytes)
#endif

namespace {

// each thread loads its entries first and stores them after, so that the
// block waits for one round of loads; the copies of entry e are stored
// rotated by e, so that a warp's 32 stores hit 32 banks
__device__ __forceinline__ void load_tables(Tables& t, const uint32_t* crc,
                                            const uint32_t* gaps,
                                            const uint8_t* gexp,
                                            const uint8_t* glog,
                                            const uint32_t* zcols,
                                            const uint32_t* zbytes,
                                            int levels) {
  constexpr int kPer = (4 * 256 + kThreads - 1) / kThreads;
  constexpr int kZb = (kTreeLevels * 1024 + kThreads - 1) / kThreads;
  uint32_t e[kPer], eg[kPer], m = 0, z[kZb];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    e[k] = i < 1024 ? crc[i] : 0u;
    eg[k] = i < 1024 ? gaps[i] : 0u;
  }
  if (threadIdx.x < 256) m = gaps[1024 + threadIdx.x];
#pragma unroll
  for (int k = 0; k < kZb; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    z[k] = i < kTreeLevels * 1024 ? zbytes[i] : 0u;
  }
  for (int i = threadIdx.x; i < levels * 32; i += blockDim.x)
    t.zc[i >> 5][i & 31] = zcols[i];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) t.exp[i] = gexp[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) t.log[i] = glog[i];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < 1024) {
      for (int c = 0; c < kCopies; ++c) {
        const int at = (i << kLgCopies) | ((c + i) & (kCopies - 1));
        t.crc[0][at] = e[k];
        t.crc[1][at] = eg[k];
      }
    }
  }
  if (threadIdx.x < 256) {
    for (int c = 0; c < kCopies; ++c)
      t.gm[(threadIdx.x << kLgCopies) |
           ((c + threadIdx.x) & (kCopies - 1))] = m;
  }
#pragma unroll
  for (int k = 0; k < kZb; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < kTreeLevels * 1024) (&t.zb[0][0][0])[i] = z[k];
  }
}

// one 4-byte word through the crc tables `tab` (this lane's copy: Z^4, or
// Z^(4 + 496) for a chunk's last word)
__device__ __forceinline__ uint32_t crc_word(const uint32_t* tab,
                                             uint32_t crc, uint32_t w) {
  const uint32_t x = crc ^ w;
  return tab[(3 << 8 | (x & 0xffu)) << kLgCopies] ^
         tab[(2 << 8 | ((x >> 8) & 0xffu)) << kLgCopies] ^
         tab[(1 << 8 | ((x >> 16) & 0xffu)) << kLgCopies] ^
         tab[(x >> 24) << kLgCopies];
}

// one word of the 4 GF lanes (lane l takes byte l; alpha * d is a shift and
// a conditional 0x1d)
__device__ __forceinline__ uint32_t gf_word(uint32_t g, uint32_t w) {
  const uint32_t hi = (g >> 7) & 0x01010101u;
  return ((g << 1) & 0xfefefefeu) ^ (hi * 0x1du) ^ w;
}

// each GF lane times alpha^124 (this lane's copy of gm): the other lanes'
// 31 chunks, 124 words, since this lane's last chunk
__device__ __forceinline__ uint32_t gf_gap(const uint32_t* gm, uint32_t g) {
  return (gm[(g & 0xffu) << kLgCopies] & 0xffu) |
         (gm[((g >> 8) & 0xffu) << kLgCopies] & 0xff00u) |
         (gm[((g >> 16) & 0xffu) << kLgCopies] & 0xff0000u) |
         (gm[(g >> 24) << kLgCopies] & 0xff000000u);
}

// one 16-byte chunk of a row, read once through the read-only path
__device__ __forceinline__ uint4 ld_chunk(const uint4* p) { return __ldg(p); }

// chunk k of this lane's interleaved stream: first, the GF lanes cross the
// other lanes' chunks since this lane's last one; after the last word, the
// crc register crosses them too (tg), unless this is the lane's last chunk
__device__ __forceinline__ void chunk_step(const uint32_t* tc,
                                           const uint32_t* tg,
                                           const uint32_t* gm,
                                           const uint4& v, bool first,
                                           bool last, uint32_t& crc,
                                           uint32_t& g) {
  if (!first) g = gf_gap(gm, g);
  crc = crc_word(tc, crc, v.x);
  g = gf_word(g, v.x);
  crc = crc_word(tc, crc, v.y);
  g = gf_word(g, v.y);
  crc = crc_word(tc, crc, v.z);
  g = gf_word(g, v.z);
  crc = crc_word(last ? tc : tg, crc, v.w);
  g = gf_word(g, v.w);
}

// chunk k of a warp item for this lane, at q + 32 k (uint4s), or zeros from
// nv on (past the row's length: not read)
__device__ __forceinline__ uint4 chunk_at(const uint4* q, int k, int nv) {
  const uint4 zero = {0u, 0u, 0u, 0u};
  return k < nv ? ld_chunk(q + kLanes * k) : zero;
}

// this lane's n chunks of a warp item, at q, q + 32, q + 64, ... (uint4s):
// each load of the warp reads 512 contiguous bytes.  next holds chunk 0,
// loaded by the caller; chunks from nv on are zeros.  The digest from zero
// of the item with every other lane's chunks zeroed, up to the end of this
// lane's last chunk.
__device__ __forceinline__ void digest_lane(const uint32_t* tc,
                                            const uint32_t* tg,
                                            const uint32_t* gm,
                                            const uint4* q, int n, int nv,
                                            uint4& next, uint32_t& crc,
                                            uint32_t& g) {
  crc = 0;
  g = 0;
  for (int k = 0; k < n; ++k) {
    const uint4 cur = next;
    next = chunk_at(q, k + 1, nv);
    chunk_step(tc, tg, gm, cur, k == 0, k == n - 1, crc, g);
  }
}

// a whole row of W < kInterleaved bytes at p, by one lane, from zero
__device__ __forceinline__ void digest_row(const uint32_t* tc,
                                           const uint8_t* p, int W,
                                           uint32_t& crc, uint32_t& g) {
  crc = 0;
  g = 0;
  if (W >= kChunk) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int i = 0; i < W / kChunk; ++i) {
      const uint4 v = ld_chunk(q + i);
      crc = crc_word(tc, crc, v.x);
      g = gf_word(g, v.x);
      crc = crc_word(tc, crc, v.y);
      g = gf_word(g, v.y);
      crc = crc_word(tc, crc, v.z);
      g = gf_word(g, v.z);
      crc = crc_word(tc, crc, v.w);
      g = gf_word(g, v.w);
    }
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    for (int i = 0; i < W / 4; ++i) {
      const uint32_t x = __ldg(w + i);
      crc = crc_word(tc, crc, x);
      g = gf_word(g, x);
    }
  }
}

// the crc register c moved across 16 * 2^k zero bytes (tree level k)
__device__ __forceinline__ uint32_t zshift(const Tables& t, int k,
                                           uint32_t c) {
  return t.zb[k][0][c & 0xffu] ^ t.zb[k][1][(c >> 8) & 0xffu] ^
         t.zb[k][2][(c >> 16) & 0xffu] ^ t.zb[k][3][c >> 24];
}

// each packed lane of g times alpha^e (e = its log, 0 <= e < 255)
__device__ __forceinline__ uint32_t gf_scale4(const Tables& t, uint32_t g,
                                              int e) {
  uint32_t out = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const uint32_t b = (g >> (8 * l)) & 0xffu;
    if (b) out |= (uint32_t)t.exp[t.log[b] + e] << (8 * l);
  }
  return out;
}

// a row's finish by one thread
__device__ __forceinline__ void finish_row(const Tables& t, int row,
                                           uint32_t crc, uint32_t g,
                                           uint32_t init,
                                           const uint32_t* mats,
                                           const uint8_t* invp,
                                           uint32_t* out) {
  const uint32_t* m = mats + (size_t)row * 32;
  crc ^= init;
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r ^= m[i] & (0u - ((crc >> i) & 1u));
  uint32_t gf = 0;
  for (int l = 0; l < 4; ++l) {
    const uint32_t b = (g >> (8 * l)) & 0xffu;
    const uint32_t p = invp[(size_t)row * 4 + l];
    if (b && p) gf |= (uint32_t)t.exp[t.log[b] + t.log[p]] << (8 * l);
  }
  out[(size_t)row * 2] = r ^ 0xffffffffu;
  out[(size_t)row * 2 + 1] = gf;
}

// a * b in GF(2^8) (polynomial 0x11d), by shifts and masks
__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r ^= a & (0u - ((b >> i) & 1u));
    a = (a << 1) ^ (0x11du & (0u - ((a >> 7) & 1u)));
  }
  return r;
}

// a row's finish by a whole warp: lane i holds column i of the row's mats
// in m and, below 4, the row's invp byte for GF lane i in p
__device__ __forceinline__ void finish_row_warp(int row, uint32_t crc,
                                                uint32_t g, uint32_t init,
                                                uint32_t m, uint32_t p,
                                                int lane, uint32_t* out) {
  crc ^= init;
  uint32_t r = m & (0u - ((crc >> lane) & 1u));
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) r ^= __shfl_xor_sync(kFull, r, o);
  uint32_t gf =
      lane < 4 ? gf_mul((g >> (8 * lane)) & 0xffu, p) << (8 * lane) : 0u;
  gf |= __shfl_xor_sync(kFull, gf, 1);
  gf |= __shfl_xor_sync(kFull, gf, 2);
  if (lane == 0) {
    out[(size_t)row * 2] = r ^ 0xffffffffu;
    out[(size_t)row * 2 + 1] = gf;
  }
}

// the bytes of row that hold data: lens[row] clamped to 0 .. W (all of it
// without lens)
__device__ __forceinline__ int row_len(const int* lens, int row, int W) {
  if (lens == nullptr) return W;
  const int L = lens[row];
  return L < 0 ? 0 : (L > W ? W : L);
}

// after an item's lanes are digested: join the lanes (c, g) and finish the
// row (W = 32 run) or leave the item's span, moved to the row's end, for
// the join launch (a wide row)
__device__ __forceinline__ void item_tail(const Tables& t, int row, int j,
                                          int lg_ipr, int span, bool wide,
                                          uint32_t c, uint32_t g,
                                          uint32_t init,
                                          const uint32_t* mats,
                                          const uint8_t* invp,
                                          uint32_t* scratch, uint32_t* out,
                                          int lane) {
  // join the lanes: level k moves the left lanes' registers across the
  // 16 * 2^k bytes by which the right lanes' last chunks end later
  for (int k = 0; k < kTreeLevels; ++k) {
    const uint32_t c2 = __shfl_down_sync(kFull, c, 1 << k);
    const uint32_t g2 = __shfl_down_sync(kFull, g, 1 << k);
    if ((lane & ((2 << k) - 1)) == 0) {
      c = zshift(t, k, c) ^ c2;
      g = gf_scale4(t, g, (4 << k) % 255) ^ g2;
    }
  }
  if (!wide) {
    finish_row_warp(row, __shfl_sync(kFull, c, 0), __shfl_sync(kFull, g, 0),
                    init, mats[(size_t)row * 32 + lane],
                    lane < 4 ? invp[(size_t)row * 4 + lane] : 0u, lane, out);
    return;
  }
  // move the item's span across the d items behind it: Z^(d span), a lane
  // a column of each factor, summed over the warp
  const int d = (1 << lg_ipr) - 1 - j;
  uint32_t v = __shfl_sync(kFull, c, 0);
  for (int i = 0; (d >> i) != 0; ++i) {
    if ((d >> i) & 1) {
      uint32_t x = t.zc[kTreeLevels + i][lane] & (0u - ((v >> lane) & 1u));
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        x ^= __shfl_xor_sync(kFull, x, o);
      v = x;
    }
  }
  if (lane == 0)
    reinterpret_cast<uint2*>(scratch)[((size_t)row << lg_ipr) + j] =
        make_uint2(v, gf_scale4(t, g, (int)(((long long)d * (span >> 2)) %
                                            255)));
}

__global__ void __launch_bounds__(kThreads, 1)
    scrub_digest_kernel(const uint8_t* data, const int* lens,
                        const uint32_t* mats, const uint8_t* invp,
                        const uint32_t* crc, const uint32_t* gaps,
                        const uint8_t* gexp, const uint8_t* glog,
                        const uint32_t* zcols, const uint32_t* zbytes,
                        int levels, uint32_t init, int S, int W, int run,
                        uint32_t* scratch, uint32_t* out) {
  DIGEST_SHARED_TABLES(t);
  const int lane = threadIdx.x & (kLanes - 1);
  int lg_run = 0, lg_w = 0;             // W and run are powers of two
  while ((1 << lg_run) < run) ++lg_run;
  while ((1 << lg_w) < W) ++lg_w;
  const bool narrow = W < kInterleaved;  // a lane a row
  const int lg_span = lg_run + kTreeLevels;  // bytes of a warp item
  const int span = 1 << lg_span;
  const bool wide = !narrow && lg_w > lg_span;  // a row over several items
  const int lg_ipr = wide ? lg_w - lg_span : 0;  // items a row
  const long long items = narrow ? ((long long)S + kLanes - 1) / kLanes
                                 : (long long)S << lg_ipr;
  const long long stride = (long long)(blockDim.x / kLanes) * gridDim.x;
  // item it: this lane's row, the item's index j in its row, and the row's
  // length
  auto locate = [&](long long it, int& row, int& j, int& L) {
    if (narrow) {
      row = (int)it * kLanes + lane;
      j = 0;
    } else {
      row = (int)(it >> lg_ipr);
      j = (int)(it & ((1 << lg_ipr) - 1));
    }
    L = it < items && row < S ? row_len(lens, row, W) : 0;
  };
  const int n = run / kChunk;           // chunks a lane an item
  // this lane's chunks of item (row, j) that hold data (lane + 32 k below
  // the row's length), and where they start
  auto chunks = [&](int row, int j, int L, const uint4*& q, int& nv) {
    const int base = j << lg_span;
    q = reinterpret_cast<const uint4*>(data + (size_t)row * W + base) + lane;
    const int rem = (L - base + kChunk - 1) / kChunk;
    nv = rem > lane ? (rem - lane + kLanes - 1) / kLanes : 0;
    nv = nv < n ? nv : n;
  };
  // an item's first chunk, loaded before the item is digested
  uint4 next;
  auto prefetch = [&](long long it, int row, int j, int L, bool blind) {
    const uint4* q = nullptr;
    int nv = 0;
    if (!narrow && it < items) chunks(row, j, L, q, nv);
    if (blind && q != nullptr) nv = 1;   // read whatever the length
    next = chunk_at(q, 0, nv);
  };
  long long it = (long long)(threadIdx.x / kLanes) * gridDim.x + blockIdx.x;
  int row, j, L;
  locate(it, row, j, L);
  // the first item's first chunk, loaded without waiting for its length
  // (past it the row holds zeros), and with the tables
  prefetch(it, row, j, L, true);
  load_tables(t, crc, gaps, gexp, glog, zcols, zbytes, levels);
  __syncthreads();
  const uint32_t* tc = t.crc[0] + (lane & (kCopies - 1));
  const uint32_t* tg = t.crc[1] + (lane & (kCopies - 1));
  const uint32_t* gm = t.gm + (lane & (kCopies - 1));
  for (; it < items; it += stride) {
    // the next item: its length loaded now, its first chunks as soon as
    // this item's are digested
    int nrow, nj, nL;
    locate(it + stride, nrow, nj, nL);
    uint32_t c = 0, g = 0;
    if (narrow) {
      if (row < S) {
        digest_row(tc, data + (size_t)row * W, W, c, g);
        finish_row(t, row, c, g, init, mats, invp, out);
      }
    } else if (j > 0 && (j << lg_span) >= L) {
      // the whole item is zeros: its span is zero
      prefetch(it + stride, nrow, nj, nL, false);
      if (lane == 0)
        reinterpret_cast<uint2*>(scratch)[((size_t)row << lg_ipr) + j] =
            make_uint2(0u, 0u);
    } else {
      const uint4* q;
      int nv;
      chunks(row, j, L, q, nv);
      digest_lane(tc, tg, gm, q, n, nv, next, c, g);
      prefetch(it + stride, nrow, nj, nL, false);
      item_tail(t, row, j, lg_ipr, span, wide, c, g, init, mats, invp,
                scratch, out, lane);
    }
    row = nrow;
    j = nj;
    L = nL;
  }
}

// rows over several warp items: item j of row r left its span, moved to
// the row's end, in part[r * ipr + j] (zero for an item past the row's
// length); a warp a row XORs them and finishes the row
__global__ void __launch_bounds__(256)
    digest_join_kernel(const uint2* part, const uint32_t* mats,
                       const uint8_t* invp, uint32_t init, int S, int ipr,
                       uint32_t* out) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int row = (int)(blockIdx.x * (blockDim.x / kLanes) +
                        threadIdx.x / kLanes);
  if (row >= S) return;
  const uint32_t m = mats[(size_t)row * 32 + lane];
  const uint32_t p = lane < 4 ? invp[(size_t)row * 4 + lane] : 0u;
  uint32_t c = 0, g = 0;
  for (int j = lane; j < ipr; j += kLanes) {
    const uint2 v = part[(size_t)row * ipr + j];
    c ^= v.x;
    g ^= v.y;
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    c ^= __shfl_xor_sync(kFull, c, o);
    g ^= __shfl_xor_sync(kFull, g, o);
  }
  finish_row_warp(row, c, g, init, m, p, lane, out);
}

constexpr int kMaxDevices = 64;
std::atomic<int> grid_slots[kMaxDevices];  // blocks that fill a device

// the blocks resident at once on the current device (0 on an error)
int device_slots() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  int slots = grid_slots[dev].load();
  if (slots > 0) return slots;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(scrub_digest_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Tables)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scrub_digest_kernel, kThreads, sizeof(Tables)) !=
          cudaSuccess)
    return 0;
  slots = sms * (per_sm > 0 ? per_sm : 1);
  grid_slots[dev].store(slots);
  return slots;
}

// the split of an (S, W) batch, W a power of two from 8 to 2^22.  run: the
// bytes a lane digests in a warp item (32 * run bytes of a row); W itself
// below kInterleaved (a lane a row).  0 on entry picks it for a card of
// `slots` blocks: twice the power of two that spreads the padded bytes over
// one wave of lanes (longer runs pay each item's joins over more bytes; the
// A/B found the doubled run faster at every shape), within kPickMin ..
// kMaxRun, and a row of up to two such items is one item.  spans: the uint2
// spans the scratch must hold (rows over several items), else 0.  False if
// the run does not split W.
bool split(long long S, int W, int slots, int& run, long long& spans) {
  spans = 0;
  if (W < 8 || W > (1 << 22) || (W & (W - 1))) return false;
  if (W < kInterleaved) {
    if (run == 0) run = W;
    return run == W;
  }
  if (run == 0) {
    const long long per_lane = S * W / ((long long)slots * kThreads);
    run = kPickMin;
    while (run < kMaxRun && run <= per_lane) run *= 2;
    if (W / kLanes <= 2 * run && W / kLanes <= kMaxRun) run = W / kLanes;
  }
  if (run < kMinRun || run > kMaxRun || (run & (run - 1)) ||
      kLanes * run > W)
    return false;
  if (W > kLanes * run) spans = S * (W / (kLanes * run));
  return true;
}

}  // namespace

// data (S, W) uint8 (16-byte aligned), zero past each row's length; lens
// (S,) int32 or null (every row W bytes); mats (S, 32) u32, invp (S, 4) u8;
// crc (4, 256) u32; gaps (1280,) u32, the Z^(4 + 496) slicing tables then
// alpha^124 * b in each byte; gexp (512,) u8, glog (256,) u8; zcols
// (levels, 32) u32, the columns of Z^(run 2^k) for levels = log2(W / run);
// zbytes (5, 4, 256) u32, Z^(16 2^k) by byte; init = Z^W * 0xFFFFFFFF.  W a
// power of two from 8 to 2^22.  Below 512, run = W and levels = 0 (a lane a
// row); from 512 on, run a power of two from 16 to 1,024 with 32 * run <= W
// (a warp item of 32 * run bytes).  scratch: the (spans, 2) u32 that
// scrub_digest_plan names for (S, W, run), null if none; with spans, the
// join launch follows.  out (S, 2) u32.
extern "C" int scrub_digest_launch(const void* data, const void* lens,
                                   const void* mats, const void* invp,
                                   const void* crc, const void* gaps,
                                   const void* gexp, const void* glog,
                                   const void* zcols, const void* zbytes,
                                   int levels, unsigned init, int S, int W,
                                   int run, void* scratch, void* out,
                                   void* stream) {
  if (S <= 0) return 0;
  long long spans = 0;
  const bool narrow = W < kInterleaved;
  if (run <= 0 || !split(S, W, 0, run, spans) ||
      levels != (narrow ? 0 : lg2(W / run)) || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const bool wide = spans > 0;
  if (wide && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int slots = device_slots();
  if (slots <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long items = narrow ? ((long long)S + kLanes - 1) / kLanes
                                 : (long long)S * (W / (kLanes * run));
  const int blocks = (int)(items < slots ? items : slots);
  cudaStream_t st = (cudaStream_t)stream;
  scrub_digest_kernel<<<blocks, kThreads, sizeof(Tables), st>>>(
      (const uint8_t*)data, (const int*)lens, (const uint32_t*)mats,
      (const uint8_t*)invp, (const uint32_t*)crc, (const uint32_t*)gaps,
      (const uint8_t*)gexp, (const uint8_t*)glog, (const uint32_t*)zcols,
      (const uint32_t*)zbytes, levels, init, S, W, run, (uint32_t*)scratch,
      (uint32_t*)out);
  if (wide) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const uint2* part = (const uint2*)scratch;
    const uint32_t* m = (const uint32_t*)mats;
    const uint8_t* ip = (const uint8_t*)invp;
    const int ipr = W / (kLanes * run);
    uint32_t* o = (uint32_t*)out;
    digest_join_kernel<<<(S + 7) / 8, 256, 0, st>>>(part, m, ip, init, S,
                                                   ipr, o);
  }
  return (int)cudaGetLastError();
}

// the split of an (S, W) batch on the current device: *run 0 picks the run
// (see split), any other is checked; *spans receives the uint2 spans the
// launcher's scratch must hold (0: no scratch)
extern "C" int scrub_digest_plan(int S, int W, int* run, long long* spans) {
  const int slots = *run == 0 ? device_slots() : 1;
  if (slots <= 0) return (int)cudaErrorInvalidConfiguration;
  if (S < 0 || !split(S, W, slots, *run, *spans))
    return (int)cudaErrorInvalidValue;
  return 0;
}
