// The fused placement tail (ops/placement_kernel.py): pg_finish_ladder, and
// the per-OSD word table it reads, pg_osd_words.
//
// pg_finish_ladder replaces the JAX package's jitted ladder,
// ceph_tpu/ops/placement_kernel.py:67 _ladder_impl (reached through
// _ladder_jit and run_ladder), which XLA ran as a chain of sorts, gathers and
// selects over (N, W) tables.  It computes exactly ladder_ref
// (placement_kernel.py), step for step: the raw CRUSH row (W cells), then
// pg_upmap_items (P pairs, in order), pg_upmap, the up/state filter, the
// primary-affinity coin flip (hash32_2 of straw2_common.cuh) and the pg_temp
// / primary_temp overrides, into the packed row
// [up (W) | acting (W) | up_len | up_primary | acting_len | acting_primary].
//
// Bound: bytes.  Each pool runs at its own width W (the mapping service no
// longer pads a replicated pool to the EC pool's width), and the function
// needs 4W + 8P + 12 bytes of a row's operands (the raw row, the pairs,
// up_len, temp_len, ptemp; raw_len on erasure pools only) and writes
// 8W + 16: 96 bytes a row at W = 3, P = 4.  The pg_upmap and pg_temp rows
// and the pps seed are read only by the rows that have one or need the coin
// flip.  Against that, a few hundred integer operations a row.
//
// What set the pace of the first version (one thread a row, each thread
// loading its row's cells straight from device memory, three per-OSD
// vectors with weight as int64): ab_kernels.py's A/B (ab_ladder.cu; the
// numbers are in PERF.md) timed it beside copies of the same bytes.  At W = 12 a copy at its
// row addresses took as long as it (lanes 48 bytes apart), a copy by tiles
// a third of that: the addressing set its pace.  At W = 3 neither did much;
// the time went to finishing rows with too few warps in flight.  So:
//
// * Row tiles through shared memory.  A block owns a tile of kTileRows
//   consecutive rows, whose dense operands are contiguous byte ranges; they
//   come in with cp.async.cg, consecutive threads on consecutive 16-byte
//   chunks, as they lie (past L1, which keeps the word table).  Each thread
//   finishes its row from shared memory into packed rows of an odd word
//   stride (threads writing one column hit 32 different banks), and the
//   tile's packed rows leave as one contiguous, coalesced store.  The
//   pg_upmap and pg_temp rows stay direct reads, only where up_len > 0 or
//   temp_len > 0.  A block takes one tile and no more: small blocks keep
//   many warps on an SM, and the A/B found a persistent grid no faster and
//   a prefetch of the next tiles (2-4 stages) slower, for the shared memory
//   it takes from other blocks.  The launch asks for a shared-memory
//   carveout that leaves L1 room for the word table (words_carveout): with
//   all 228 KB given to tiles, the table's gathers missed L1.
// * The per-OSD vectors as one word per OSD (osd_word): affinity clamped to
//   0 .. 0x10000 (an exact rewrite: a member below 0 never wins the coin
//   flip, as at 0, and one above 0x10000 always wins, as at 0x10000), exists,
//   up and in (weight != 0, so an int64 weight above 32 bits still reads as
//   in).  pg_osd_words packs them once an epoch and the words are read
//   through __ldg.  A copy of the table in each block's shared memory was
//   slower in every arrangement the A/B tried (it costs the blocks that
//   hide the row finish's latency), so there is none.
//
// The row finish itself keeps the first version's design: a row's cells sit
// in registers, one template instance per width bucket WB (4, 8, 16, 32)
// covers every W <= WB, every loop over cells is unrolled to WB with a
// `c < w` guard (no cell array indexed by a run-time value), a stable
// compaction takes the j-th kept cell for each output j (O(WB^2) selects),
// and P is a run-time loop.  Two steps are new: a pad pair (a target
// outside the map) is skipped, and up to WB = 8 each member's affinity
// comes from the word its up filter read (6% at W = 3 in the A/B).  finish_row and osd_word are plain functions of
// a row's values, so the host build of tests/test_torch_ladder_host.py and
// tests/test_torch_placement_host.py calls them as they are.
//
// Per-OSD reads clamp the id to 0 .. m_osd - 1 (as the reference's gather
// does) and mask the result with the range test: an id outside the map
// reads as default affinity and neither exists, up nor in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "straw2_common.cuh"

namespace {

constexpr int32_t kNoOsd = -1;
constexpr int32_t kMaxAffinity = 0x10000;
constexpr int32_t kOsdExists = 1;
constexpr int32_t kOsdUp = 2;

// one OSD's word: affinity (clamped) in bits 0-16, then exists, up and in
constexpr uint32_t kWordAffinity = 0x1FFFFu;
constexpr uint32_t kWordExists = 1u << 17;
constexpr uint32_t kWordUp = 1u << 18;
constexpr uint32_t kWordIn = 1u << 19;
// the word an id outside 0 .. m_osd - 1 reads as
constexpr uint32_t kWordNone = (uint32_t)kMaxAffinity;

__device__ __forceinline__ uint32_t osd_word(int32_t state, long long weight, int32_t affinity) {
  const int32_t a = affinity < 0 ? 0 : (affinity > kMaxAffinity ? kMaxAffinity : affinity);
  return (uint32_t)a | ((state & kOsdExists) ? kWordExists : 0u) |
         ((state & kOsdUp) ? kWordUp : 0u) | (weight != 0 ? kWordIn : 0u);
}

// The epoch's words, read through the read-only cache
struct OsdWords {
  const uint32_t* w;
  int m;

  __device__ __forceinline__ uint32_t operator()(int32_t o) const {
    const uint32_t v = __ldg(&w[o < 0 ? 0 : (o >= m ? m - 1 : o)]);
    return (o >= 0 && o < m) ? v : kWordNone;
  }
};

__device__ __forceinline__ bool exists_in(uint32_t word) {
  return (word & (kWordExists | kWordIn)) == (kWordExists | kWordIn);
}

__device__ __forceinline__ bool exists_up(uint32_t word) {
  return (word & (kWordExists | kWordUp)) == (kWordExists | kWordUp);
}

// k / d for 0 <= k < 2^26 and 1 <= d <= 2^15, with magic = 2^32 / d + 1
// (div_magic, on the host): exact, since k * (magic * d - 2^32) < 2^32
inline uint32_t div_magic(uint32_t d) {
  return d <= 1 ? 0u : (uint32_t)((1ull << 32) / d + 1);
}

__device__ __forceinline__ uint32_t div_small(uint32_t k, uint32_t d, uint32_t magic) {
  return d == 1 ? k : __umulhi(k, magic);
}

// out[j] = the j-th cell c < w of row with keep[c], then `fill`; returns the
// kept count
template <int WB>
__device__ __forceinline__ int compact(const int32_t (&row)[WB], const bool (&keep)[WB],
                                       int w, int32_t fill, int32_t (&out)[WB]) {
  int count = 0;
#pragma unroll
  for (int c = 0; c < WB; ++c) count += (c < w && keep[c]) ? 1 : 0;
#pragma unroll
  for (int j = 0; j < WB; ++j) {
    int32_t v = fill;
    int seen = 0;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      if (c < w && keep[c]) {
        if (seen == j) v = row[c];
        ++seen;
      }
    }
    out[j] = j < count ? v : fill;
  }
  return count;
}

// One PG row, finished into its packed row `out` (2w + 4 cells).  `raw`
// holds the row's w raw cells and `items` its P pairs (frm, to); raw_len is
// read on erasure pools only.  The pg_upmap row `up_row` is read only when
// ul > 0, the pg_temp row `temp_row` only when tl > 0 and the seed *pps
// only when a member's affinity is not the default.
template <int WB, class Words>
__device__ __forceinline__ void finish_row(const int32_t* raw, int raw_len, const int32_t* items,
                                           int P, int ul, const int32_t* up_row, int tl,
                                           const int32_t* temp_row, int32_t pt,
                                           const uint32_t* pps, int w, bool erasure,
                                           const Words& word, int32_t* out) {
  // -- the base row: replicated rows compact their NONE holes first
  int32_t cell[WB];
  bool keep[WB];
#pragma unroll
  for (int c = 0; c < WB; ++c) {
    cell[c] = c < w ? raw[c] : kItemNone;
    keep[c] = cell[c] != kItemNone;
  }
  int32_t row[WB];
  int base_len;
  if (erasure) {
#pragma unroll
    for (int c = 0; c < WB; ++c) row[c] = cell[c];
    base_len = raw_len;
  } else {
    base_len = compact<WB>(cell, keep, w, kItemNone, row);
  }

  // -- pg_upmap_items: each pair sees the previous pair's rewrite; the
  // scans cover the active length only (a NONE frm never matches a pad)
  for (int p = 0; p < P; ++p) {
    const int32_t frm = items[2 * p];
    const int32_t to = items[2 * p + 1];
    if (to < 0) continue;   // a pad pair: a target outside the map never applies
    bool has = false, to_in = false;
    int first = 0;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      if (c < w && c < base_len) {
        if (row[c] == frm && !has) {
          has = true;
          first = c;
        }
        to_in |= row[c] == to;
      }
    }
    if (has && !to_in && exists_in(word(to))) {
#pragma unroll
      for (int c = 0; c < WB; ++c)
        if (c == first) row[c] = to;
    }
  }

  // -- pg_upmap: wholesale when present and every entry exists and is in
  int row_len = base_len;
  if (ul > 0) {
    bool allok = true;
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      cell[c] = c < w ? __ldg(&up_row[c]) : kItemNone;
      if (c < w && c < ul && !exists_in(word(cell[c]))) allok = false;
    }
    if (allok) {
#pragma unroll
      for (int c = 0; c < WB; ++c) row[c] = cell[c];
      row_len = ul;
    }
  }

  // -- raw -> up: drop nonexistent and down osds.  Up to WB = 8 each
  // member's affinity comes from the word read here, kept (and compacted)
  // beside it; wider rows read it again (a second WB^2 compaction costs
  // them more registers than the reads)
  constexpr bool kKeepAff = WB <= 8;
  int32_t up[WB], aff[WB], row_aff[WB];
  int up_n;
#pragma unroll
  for (int c = 0; c < WB; ++c) {
    const uint32_t wd = c < row_len && row[c] != kItemNone ? word(row[c]) : 0u;
    keep[c] = exists_up(wd);
    row_aff[c] = (int32_t)(wd & kWordAffinity);
  }
  if (erasure) {
#pragma unroll
    for (int c = 0; c < WB; ++c) {
      up[c] = keep[c] ? row[c] : kNoOsd;
      aff[c] = keep[c] ? row_aff[c] : kMaxAffinity;
    }
    up_n = row_len;
  } else {
    up_n = compact<WB>(row, keep, w, kNoOsd, up);
    if (kKeepAff) compact<WB>(row_aff, keep, w, kMaxAffinity, aff);
  }
  if (!kKeepAff && !erasure) {
#pragma unroll
    for (int c = 0; c < WB; ++c)
      aff[c] = (c < w && up[c] != kNoOsd) ? (int32_t)(word(up[c]) & kWordAffinity) : kMaxAffinity;
  }
  int32_t up_primary = kNoOsd;
#pragma unroll
  for (int c = WB - 1; c >= 0; --c)
    if (c < w && up[c] != kNoOsd) up_primary = up[c];

  // -- primary affinity: skipped when every member has default affinity;
  // else the first member that wins its coin flip, or the positional one
  bool default_all = true;
#pragma unroll
  for (int c = 0; c < WB; ++c)
    if (aff[c] != kMaxAffinity) default_all = false;
  int32_t prim = up_primary;
  if (!default_all) {
    const uint32_t seed = __ldg(pps);
#pragma unroll
    for (int c = WB - 1; c >= 0; --c) {
      if (c < w && up[c] != kNoOsd) {
        const int32_t h = (int32_t)(hash32_2(seed, (uint32_t)up[c]) >> 16);
        if (aff[c] == kMaxAffinity || h < aff[c]) prim = up[c];
      }
    }
  }

  // -- temps: pg_temp replaces acting; primary_temp wins over both
  int32_t act[WB];
#pragma unroll
  for (int c = 0; c < WB; ++c) act[c] = tl > 0 && c < w ? __ldg(&temp_row[c]) : up[c];
  const int act_n = tl > 0 ? tl : up_n;
  int32_t act_first = kNoOsd;
  bool same = act_n == up_n;
#pragma unroll
  for (int c = WB - 1; c >= 0; --c) {
    if (c < w) {
      if (act[c] != kNoOsd) act_first = act[c];
      same &= act[c] == up[c];
    }
  }
  const int32_t act_primary = pt != kNoOsd ? pt : (same ? prim : act_first);

#pragma unroll
  for (int c = 0; c < WB; ++c) {
    if (c < w) {
      out[c] = up[c];
      out[w + c] = act[c];
    }
  }
  out[2 * w] = up_n;
  out[2 * w + 1] = prim;
  out[2 * w + 2] = act_n;
  out[2 * w + 3] = act_primary;
}

}  // namespace

namespace {

// rows a tile at most (a block's threads, one row each); the launcher
// halves it where a tile of wide rows would not fit in shared memory
constexpr int kTileRows = 128;
constexpr int kSmemBytesMax = 232448;   // 227 KB, a block's most
// an SM's 256 KB hold L1 and shared memory; shared memory takes up to
// kSmemSmKb of them, in the steps the carveout (a percentage of it) picks
constexpr int kSmemSmKb = 228;
// L1 kept beside the word table for everything else it caches
constexpr int kL1SlackKb = 32;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16 bytes, past L1 (the operands stream; L1 keeps the word table)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// copy n words src[0..n) as they lie, consecutive threads on consecutive
// 16-byte chunks (src and dst 16-byte aligned), the tail word by word
__device__ __forceinline__ void stage_contig(int32_t* dst, const int32_t* src, int n) {
  const int n4 = n >> 2;
  for (int k = threadIdx.x; k < n4; k += blockDim.x) cp_async16(dst + 4 * k, src + 4 * k);
  for (int k = 4 * n4 + threadIdx.x; k < n; k += blockDim.x) cp_async4(dst + k, src + k);
}

// A tile's shared memory, in 32-bit words: the raw rows (w words each), the
// pairs (2P), up_len, temp_len, ptemp and raw_len (rows words each), then
// the packed rows at an odd stride `so` (threads writing one column of
// consecutive rows touch 32 different banks).  m_out divides a word index
// of the tile's packed rows by 2w + 4 (div_small).
struct Tile {
  int rows, so;
  uint32_t m_out;

  Tile(int rows_, int w) : rows(rows_), so((2 * w + 4) | 1), m_out(div_magic(2 * w + 4)) {}

  static size_t bytes(int rows, int w, int P) {
    return 4 * (size_t)rows * (w + 2 * P + 4 + ((2 * w + 4) | 1));
  }
};

template <int WB>
__global__ void __launch_bounds__(kTileRows) pg_finish_ladder_kernel(
    const int32_t* __restrict__ raw, const uint32_t* __restrict__ pps,
    const int32_t* __restrict__ raw_len, const int32_t* __restrict__ up_rows,
    const int32_t* __restrict__ up_len, const int32_t* __restrict__ items,
    const int32_t* __restrict__ temp_rows, const int32_t* __restrict__ temp_len,
    const int32_t* __restrict__ ptemp, const uint32_t* __restrict__ words, int m_osd, int n,
    int w, int P, int erasure, Tile tile, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int T = tile.rows;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * T;
  const int rows = min(T, n - row0);
  int32_t* const s_raw = smem;
  int32_t* const s_items = s_raw + T * w;
  int32_t* const s_vec = s_items + T * 2 * P;
  int32_t* const s_out = s_vec + 4 * T;

  // the tile's dense operands, each one contiguous range
  stage_contig(s_raw, raw + (int64_t)row0 * w, rows * w);
  stage_contig(s_items, items + (int64_t)row0 * 2 * P, rows * 2 * P);
  stage_contig(s_vec, up_len + row0, rows);
  stage_contig(s_vec + T, temp_len + row0, rows);
  stage_contig(s_vec + 2 * T, ptemp + row0, rows);
  if (erasure) stage_contig(s_vec + 3 * T, raw_len + row0, rows);
  cp_async_wait_all();
  __syncthreads();

  if (tid < rows) {
    const int64_t i = row0 + tid;
    finish_row<WB>(s_raw + tid * w, erasure ? s_vec[3 * T + tid] : 0, s_items + tid * 2 * P, P,
                   s_vec[tid], up_rows + i * w, s_vec[T + tid], temp_rows + i * w,
                   s_vec[2 * T + tid], pps + i, w, erasure != 0, OsdWords{words, m_osd},
                   s_out + tid * tile.so);
  }
  __syncthreads();

  // the tile's packed rows leave as one contiguous range
  const int d_out = 2 * w + 4;
  int32_t* o = out + (int64_t)row0 * d_out;
  for (int k = tid; k < rows * d_out; k += blockDim.x) {
    const int r = (int)div_small((uint32_t)k, (uint32_t)d_out, tile.m_out);
    o[k] = s_out[r * tile.so + (k - r * d_out)];
  }
}

__global__ void pg_osd_words_kernel(const int32_t* __restrict__ state,
                                    const long long* __restrict__ weight,
                                    const int32_t* __restrict__ affinity, int m,
                                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) out[i] = osd_word(state[i], weight[i], affinity[i]);
}

// The shared-memory carveout (percent of kSmemSmKb) that leaves L1 room
// for the word table, so that its gathers hit L1; the default (-1)
// where the table cannot fit beside one tile
inline int words_carveout(int m_osd, size_t tile_bytes) {
  const int table_kb = (int)(((size_t)m_osd * 4 + 1023) / 1024);
  const int tile_kb = (int)((tile_bytes + 1023) / 1024) + 1;
  const int smem_kb = kSmemSmKb - table_kb - kL1SlackKb;
  return smem_kb < tile_kb ? -1 : (smem_kb * 100) / kSmemSmKb;
}

// one launch of the width bucket's instance: a block a tile of the largest
// row count up to kTileRows whose tile fits in shared memory, the carveout
// leaving L1 to the word table
template <int WB>
int launch_ladder(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
                  const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
                  const int32_t* temp_rows, const int32_t* temp_len, const int32_t* ptemp,
                  const uint32_t* words, int m_osd, int n, int w, int P, int erasure,
                  int32_t* out, cudaStream_t s) {
  const auto kernel = pg_finish_ladder_kernel<WB>;
  int rows = kTileRows;
  while (Tile::bytes(rows, w, P) > (size_t)kSmemBytesMax && rows > 32) rows /= 2;
  const size_t smem = Tile::bytes(rows, w, P);
  if (smem > (size_t)kSmemBytesMax) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             words_carveout(m_osd, smem));
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + rows - 1) / rows, rows, smem, s>>>(raw, pps, raw_len, up_rows, up_len, items,
                                                   temp_rows, temp_len, ptemp, words, m_osd, n,
                                                   w, P, erasure, Tile(rows, w), out);
  return (int)cudaGetLastError();
}

}  // namespace (kernels)

// state, weight, affinity, m_osd, out, stream
extern "C" int pg_osd_words_launch(const void* state, const void* weight, const void* affinity,
                                   int m_osd, void* out, void* stream) {
  if (m_osd <= 0) return 0;
  pg_osd_words_kernel<<<blocks_for(m_osd), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)state, (const long long*)weight, (const int32_t*)affinity, m_osd,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

// raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp,
// words, m_osd, n, w, P, erasure, out, stream
extern "C" int pg_finish_ladder_launch(const void* raw, const void* pps, const void* raw_len,
                                       const void* up_rows, const void* up_len, const void* items,
                                       const void* temp_rows, const void* temp_len,
                                       const void* ptemp, const void* words, int m_osd, int n,
                                       int w, int P, int erasure, void* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > 32 || m_osd < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const auto* a_raw = (const int32_t*)raw;
  const auto* a_pps = (const uint32_t*)pps;
  const auto* a_rl = (const int32_t*)raw_len;
  const auto* a_ur = (const int32_t*)up_rows;
  const auto* a_ul = (const int32_t*)up_len;
  const auto* a_it = (const int32_t*)items;
  const auto* a_tr = (const int32_t*)temp_rows;
  const auto* a_tl = (const int32_t*)temp_len;
  const auto* a_pt = (const int32_t*)ptemp;
  const auto* a_w = (const uint32_t*)words;
  auto* a_out = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= 4)
    return launch_ladder<4>(a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, a_w, m_osd, n,
                            w, P, erasure, a_out, s);
  if (w <= 8)
    return launch_ladder<8>(a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, a_w, m_osd, n,
                            w, P, erasure, a_out, s);
  if (w <= 16)
    return launch_ladder<16>(a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, a_w, m_osd,
                             n, w, P, erasure, a_out, s);
  return launch_ladder<32>(a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, a_w, m_osd, n,
                           w, P, erasure, a_out, s);
}
