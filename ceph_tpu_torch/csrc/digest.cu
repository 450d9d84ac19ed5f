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
// Bound: bytes.  The function reads each of the S*W row bytes once (the
// operands add 132 bytes a row) and writes 8 bytes a row, so at
// 3.35 TB/s a (32, 2^22) batch takes at least 40 us.  The table lookups
// come to one shared-memory access per byte (the four 1 KiB crc tables;
// the GF lanes step with shifts and masks), which stays under the SM's
// shared-memory rate.
//
// The scan is a chain, but both digests are linear across a split, so
// the chain is cut (checksum_kernel.py's module note):
//
// * Each thread digests one segment of kSeg = 64 bytes from a zero
//   register and zero lanes.  A block stages a 16 KiB tile of the batch
//   into shared memory first, consecutive threads on consecutive 16-byte
//   chunks, and each thread then reads its segment from the tile; the
//   chunks are swizzled (chunk r of segment i at r ^ ((i >> 1) & 3)) so
//   that eight threads reading 16 bytes each hit 32 different banks.
// * A tree over the block joins neighbouring spans: level j takes the left
//   span's crc register across the right span's s*2^j bytes with the 32
//   columns of Z^(s*2^j), and each GF lane across its s/4*2^j steps with
//   alpha^(s/4*2^j), then XORs in the right span (shift_operands).
// * Rows up to a tile (W <= 16 KiB) finish in the block that staged them
//   (scrub_digest_rows_kernel: a tile holds 16 KiB / W whole rows).
//   Wider rows take several blocks: each walks `tpb` consecutive tiles of
//   its row, folding each tile into a running span at level 8 (one tile),
//   and writes one partial; partials_join_kernel joins a row's partials by
//   the same tree and finishes the row.  Rows below 64 bytes are one
//   segment (scrub_digest_small_kernel, a thread a row).
// * A row's finish: XOR in Z^W * 0xFFFFFFFF (the initial register's part),
//   apply the row's mats (Z^-(W-L): strips the padding), XOR 0xFFFFFFFF,
//   and multiply each lane by its invp.
//
// Every block loads the tables (crc 4 KiB, GF exp/log 768 B, the level
// operands) into shared memory once; at the wide rows' 4 tiles a block
// that is 7 KiB against 64 KiB of data.  No cp.async, no persistent
// blocks: a simple right kernel first.
//
// Each launch runs one scrub_digest_* kernel (wide rows add
// partials_join_kernel), so a trace counts the launches by that name.
// Block-level code uses only __syncthreads and shared memory, so
// tests/test_torch_digest_host.py runs this namespace on the host, a
// std::thread per CUDA thread and a barrier for __syncthreads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads of a block
constexpr int kSeg = 64;                    // bytes a thread digests
constexpr int kChunks = kSeg / 16;          // 16-byte chunks a segment
constexpr int kTile = kThreads * kSeg;      // bytes a block stages at once
constexpr int kTileLevel = 8;               // log2(kThreads): a tile's level
constexpr int kMaxLevels = 20;              // log2(2^22 / kSeg) = 16 used

struct Tables {
  uint32_t crc[4][256];
  uint8_t exp[512];       // alpha^i, periodic past 255
  uint8_t log[256];       // log[0] unused
  uint32_t zcol[kMaxLevels][32];
  uint8_t alog[kMaxLevels];  // log of alpha^(s/4 * 2^j)
};

__device__ __forceinline__ void load_tables(Tables& t, const uint32_t* crc,
                                            const uint8_t* gexp,
                                            const uint8_t* glog,
                                            const uint32_t* zcols,
                                            const uint8_t* alpha,
                                            int levels) {
  for (int i = threadIdx.x; i < 1024; i += kThreads)
    t.crc[i >> 8][i & 255] = crc[i];
  for (int i = threadIdx.x; i < 512; i += kThreads) t.exp[i] = gexp[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) t.log[i] = glog[i];
  for (int i = threadIdx.x; i < levels * 32; i += kThreads)
    t.zcol[i >> 5][i & 31] = zcols[i];
  for (int i = threadIdx.x; i < levels; i += kThreads)
    t.alog[i] = glog[alpha[i]];
  __syncthreads();
}

// one 4-byte word: a slicing-by-4 crc step and a step of the 4 GF lanes
// (lane l takes byte l; alpha * d is a shift and a conditional 0x1d)
__device__ __forceinline__ void step(const Tables& t, uint32_t w,
                                     uint32_t& crc, uint32_t& g) {
  const uint32_t x = crc ^ w;
  crc = t.crc[3][x & 0xffu] ^ t.crc[2][(x >> 8) & 0xffu] ^
        t.crc[1][(x >> 16) & 0xffu] ^ t.crc[0][x >> 24];
  const uint32_t hi = (g >> 7) & 0x01010101u;
  g = ((g << 1) & 0xfefefefeu) ^ (hi * 0x1du) ^ w;
}

// a GF(2) matrix of 32 columns applied to v
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols,
                                              uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) r ^= cols[i] & (0u - ((v >> i) & 1u));
  return r;
}

// each packed lane of g times the field element whose log is lc
__device__ __forceinline__ uint32_t gf_scale4(const Tables& t, uint32_t g,
                                              int lc) {
  uint32_t out = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const uint32_t b = (g >> (8 * l)) & 0xffu;
    if (b) out |= (uint32_t)t.exp[t.log[b] + lc] << (8 * l);
  }
  return out;
}

// (crc, g) of a span followed by (crc2, g2) of a span of level j
__device__ __forceinline__ void join(const Tables& t, int j, uint32_t& crc,
                                     uint32_t& g, uint32_t crc2,
                                     uint32_t g2) {
  crc = gf2_apply(t.zcol[j], crc) ^ crc2;
  g = gf_scale4(t, g, t.alog[j]) ^ g2;
}

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

__device__ __forceinline__ int swizzle(int i, int r) {
  return i * kChunks + (r ^ ((i >> 1) & 3));
}

// nchunks 16-byte chunks from src into the tile, consecutive threads on
// consecutive chunks
__device__ __forceinline__ void stage_tile(uint4* tile, const uint8_t* src,
                                           int nchunks) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int q = threadIdx.x; q < nchunks; q += kThreads)
    tile[swizzle(q / kChunks, q % kChunks)] = s[q];
}

__device__ __forceinline__ void digest_segment(const Tables& t,
                                               const uint4* tile, int i,
                                               uint32_t& crc, uint32_t& g) {
  crc = 0;
  g = 0;
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const uint4 v = tile[swizzle(i, r)];
    step(t, v.x, crc, g);
    step(t, v.y, crc, g);
    step(t, v.z, crc, g);
    step(t, v.w, crc, g);
  }
}

// join the block's spans in aligned groups of `group` (a power of two up
// to kThreads); span i of a group ends in rc[i], rg[i] of its first thread
__device__ __forceinline__ void tree(const Tables& t, uint32_t* rc,
                                     uint32_t* rg, int group, int level0) {
  const int i = threadIdx.x;
  for (int j = 0; (1 << j) < group; ++j) {
    const int stride = 1 << j;
    if ((i & (2 * stride - 1)) == 0) {
      uint32_t c = rc[i], g = rg[i];
      join(t, level0 + j, c, g, rc[i + stride], rg[i + stride]);
      rc[i] = c;
      rg[i] = g;
    }
    __syncthreads();
  }
}

// W < kSeg: a thread a row
__global__ void __launch_bounds__(kThreads)
    scrub_digest_small_kernel(const uint8_t* data, const uint32_t* mats,
                        const uint8_t* invp, const uint32_t* crc,
                        const uint8_t* gexp, const uint8_t* glog,
                        uint32_t init, int S, int W, uint32_t* out) {
  __shared__ Tables t;
  load_tables(t, crc, gexp, glog, nullptr, nullptr, 0);
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row < S) {
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(data + (size_t)row * W);
    uint32_t c = 0, g = 0;
    for (int k = 0; k < W / 4; ++k) step(t, p[k], c, g);
    finish_row(t, row, c, g, init, mats, invp, out);
  }
}

// kSeg <= W <= kTile: a block a tile of whole rows
__global__ void __launch_bounds__(kThreads)
    scrub_digest_rows_kernel(const uint8_t* data, const uint32_t* mats,
                       const uint8_t* invp, const uint32_t* crc,
                       const uint8_t* gexp, const uint8_t* glog,
                       const uint32_t* zcols, const uint8_t* alpha,
                       int levels, uint32_t init, int S, int W,
                       uint32_t* out) {
  __shared__ Tables t;
  __shared__ uint4 tile[kThreads * kChunks];
  __shared__ uint32_t rc[kThreads], rg[kThreads];
  load_tables(t, crc, gexp, glog, zcols, alpha, levels);
  const size_t total = (size_t)S * W;
  const size_t base = (size_t)blockIdx.x * kTile;
  const int nbytes = (int)(total - base < (size_t)kTile ? total - base
                                                         : (size_t)kTile);
  stage_tile(tile, data + base, nbytes / 16);
  __syncthreads();
  const int i = threadIdx.x;
  uint32_t c = 0, g = 0;
  if (i * kSeg < nbytes) digest_segment(t, tile, i, c, g);
  rc[i] = c;
  rg[i] = g;
  __syncthreads();
  const int group = W / kSeg;
  tree(t, rc, rg, group, 0);
  // a tile holds kTile / W whole rows (W divides kTile): the row index
  // in 32 bits, no 64-bit divide
  if ((i & (group - 1)) == 0 && i * kSeg < nbytes)
    finish_row(t, blockIdx.x * (kTile / W) + i * kSeg / W, rc[i], rg[i],
               init, mats, invp, out);
}

// W > kTile: a block `tpb` consecutive tiles of one row, one partial out
__global__ void __launch_bounds__(kThreads)
    scrub_digest_tiles_kernel(const uint8_t* data, const uint32_t* crc,
                        const uint8_t* gexp, const uint8_t* glog,
                        const uint32_t* zcols, const uint8_t* alpha,
                        int levels, int W, int tpb, uint32_t* part) {
  __shared__ Tables t;
  __shared__ uint4 tile[kThreads * kChunks];
  __shared__ uint32_t rc[kThreads], rg[kThreads];
  load_tables(t, crc, gexp, glog, zcols, alpha, levels);
  const int bpr = W / kTile / tpb;
  const int row = blockIdx.x / bpr;
  const int b = blockIdx.x % bpr;
  const uint8_t* src = data + (size_t)row * W + (size_t)b * tpb * kTile;
  uint32_t acc_c = 0, acc_g = 0;  // thread 0's running span
  for (int k = 0; k < tpb; ++k) {
    stage_tile(tile, src + (size_t)k * kTile, kThreads * kChunks);
    __syncthreads();
    uint32_t c, g;
    digest_segment(t, tile, threadIdx.x, c, g);
    rc[threadIdx.x] = c;
    rg[threadIdx.x] = g;
    __syncthreads();
    tree(t, rc, rg, kThreads, 0);
    if (threadIdx.x == 0) {
      if (k == 0) {
        acc_c = rc[0];
        acc_g = rg[0];
      } else {
        join(t, kTileLevel, acc_c, acc_g, rc[0], rg[0]);
      }
    }
    __syncthreads();  // the next tile overwrites tile, rc and rg
  }
  if (threadIdx.x == 0) {
    part[(size_t)blockIdx.x * 2] = acc_c;
    part[(size_t)blockIdx.x * 2 + 1] = acc_g;
  }
}

// a block a row: join the row's bpr partials (spans of level level0)
__global__ void __launch_bounds__(kThreads)
    partials_join_kernel(const uint32_t* part, int bpr, int level0,
                       const uint32_t* mats, const uint8_t* invp,
                       const uint32_t* crc, const uint8_t* gexp,
                       const uint8_t* glog, const uint32_t* zcols,
                       const uint8_t* alpha, int levels, uint32_t init,
                       uint32_t* out) {
  __shared__ Tables t;
  __shared__ uint32_t rc[kThreads], rg[kThreads];
  load_tables(t, crc, gexp, glog, zcols, alpha, levels);
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  const size_t p = ((size_t)row * bpr + i) * 2;
  rc[i] = i < bpr ? part[p] : 0u;
  rg[i] = i < bpr ? part[p + 1] : 0u;
  __syncthreads();
  tree(t, rc, rg, bpr, level0);
  if (i == 0) finish_row(t, row, rc[0], rg[0], init, mats, invp, out);
}

}  // namespace

// data (S, W) uint8 (16-byte aligned), mats (S, 32) u32, invp (S, 4) u8,
// crc (4, 256) u32, gexp (512,) u8, glog (256,) u8, zcols (levels, 32) u32,
// alpha (levels,) u8, init = Z^W * 0xFFFFFFFF; W a power of two from 8 to
// 2^22.  W > kTile: tpb tiles a block, part (S * W / kTile / tpb, 2) u32
// scratch.  out (S, 2) u32.
extern "C" int scrub_digest_launch(const void* data, const void* mats,
                                   const void* invp, const void* crc,
                                   const void* gexp, const void* glog,
                                   const void* zcols, const void* alpha,
                                   int levels, unsigned init, int S, int W,
                                   int tpb, void* part, void* out,
                                   void* stream) {
  if (S <= 0) return 0;
  if (levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* d = (const uint8_t*)data;
  const uint32_t* m = (const uint32_t*)mats;
  const uint8_t* ip = (const uint8_t*)invp;
  const uint32_t* c = (const uint32_t*)crc;
  const uint8_t* ge = (const uint8_t*)gexp;
  const uint8_t* gl = (const uint8_t*)glog;
  const uint32_t* z = (const uint32_t*)zcols;
  const uint8_t* a = (const uint8_t*)alpha;
  uint32_t* o = (uint32_t*)out;
  if (W < kSeg) {
    const int blocks = (S + kThreads - 1) / kThreads;
    scrub_digest_small_kernel<<<blocks, kThreads, 0, st>>>(
        d, m, ip, c, ge, gl, init, S, W, o);
  } else if (W <= kTile) {
    const size_t total = (size_t)S * W;
    const int blocks = (int)((total + kTile - 1) / kTile);
    scrub_digest_rows_kernel<<<blocks, kThreads, 0, st>>>(
        d, m, ip, c, ge, gl, z, a, levels, init, S, W, o);
  } else {
    const int bpr = W / kTile / tpb;
    if (tpb < 1 || bpr < 1 || bpr > kThreads || bpr * tpb * kTile != W)
      return (int)cudaErrorInvalidValue;
    int lg_tpb = 0;
    while ((1 << lg_tpb) < tpb) ++lg_tpb;
    scrub_digest_tiles_kernel<<<S * bpr, kThreads, 0, st>>>(
        d, c, ge, gl, z, a, levels, W, tpb, (uint32_t*)part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    partials_join_kernel<<<S, kThreads, 0, st>>>(
        (const uint32_t*)part, bpr, kTileLevel + lg_tpb, m, ip, c, ge, gl,
        z, a, levels, init, o);
  }
  return (int)cudaGetLastError();
}
