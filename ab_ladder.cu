// ab_ladder.cu — the design variants of pg_finish_ladder that ab_kernels.py
// times against the kernel of ceph_tpu_torch/csrc/placement.cu (built by
// ab_kernels.ladder_variants into ceph_tpu_torch/_build/, never part of the
// package's library).  Each isolates one suspect of the first version's pace:
//
//   pr8_ladder_launch   the first version (one thread a row, the row's
//                       cells straight from device memory, three per-OSD
//                       vectors with weight as int64), as it was committed
//   copy_ladder_launch  no row finish: loads the operands the first version
//                       loads and stores packed rows, with tiles = 0 one
//                       thread a row at the first version's addresses, with
//                       tiles = 1 a block's tile of rows loaded with
//                       consecutive threads on consecutive words into
//                       shared memory and stored the same way
//   pr8_words_launch    the first version with the per-OSD reads taken from
//                       a word table in shared memory (a persistent grid,
//                       the table copied once a block)
//   tile_variant_launch the designs tried for placement.cu's kernel: its row
//                       finish (included from placement.cu) over row tiles
//                       in shared memory, at a chosen word reader (a table
//                       in shared memory a block, or __ldg), stage count
//                       (1: no prefetch; 2-4: the next tiles' loads fly
//                       while a tile is finished), staging (16 bytes a copy
//                       as the operands lie, or 4 bytes a copy restrided to
//                       odd row strides), grid (persistent: as many blocks
//                       as fit at once, each walking tiles; or a block a
//                       tile), rows a tile and least blocks an SM asked of
//                       the compiler; not built with -DAB_FIRST_ONLY
//   this_carveout_launch placement.cu's kernel, built in this file, at a
//                       given shared-memory carveout (a percentage of the
//                       SM's 228 KB; -1: the default) in place of
//                       the one words_carveout picks to leave L1 room for
//                       the word table
//
// The copies write a row's values combined (xor) so that no load is dead.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "placement.cu"

namespace ab {

constexpr int32_t kNoOsd = -1;
constexpr int32_t kMaxAffinity = 0x10000;
constexpr int32_t kOsdExists = 1;
constexpr int32_t kOsdUp = 2;
constexpr int kTile = 128;

struct OsdVectors {
  const int32_t* state;
  const long long* weight;
  const int32_t* affinity;
  int m;

  __device__ __forceinline__ bool in_range(int32_t o) const { return o >= 0 && o < m; }
  __device__ __forceinline__ int clamp(int32_t o) const {
    return o < 0 ? 0 : (o >= m ? m - 1 : o);
  }
  __device__ __forceinline__ bool exists(int32_t o) const {
    return in_range(o) && (__ldg(&state[clamp(o)]) & kOsdExists) != 0;
  }
  __device__ __forceinline__ bool is_up(int32_t o) const {
    return in_range(o) && (__ldg(&state[clamp(o)]) & kOsdUp) != 0;
  }
  __device__ __forceinline__ bool not_out(int32_t o) const {
    return in_range(o) && __ldg(&weight[clamp(o)]) != 0;
  }
  __device__ __forceinline__ int32_t aff(int32_t o) const {
    return in_range(o) ? __ldg(&affinity[clamp(o)]) : kMaxAffinity;
  }
};

// placement.cu's word (affinity in bits 0-16, exists 17, up 18, in 19),
// read from shared memory
struct SmemWords {
  const uint32_t* w;
  int m;

  __device__ __forceinline__ uint32_t word(int32_t o) const {
    const uint32_t v = w[o < 0 ? 0 : (o >= m ? m - 1 : o)];
    return (o >= 0 && o < m) ? v : (uint32_t)kMaxAffinity;
  }
  __device__ __forceinline__ bool exists(int32_t o) const { return word(o) & (1u << 17); }
  __device__ __forceinline__ bool is_up(int32_t o) const { return word(o) & (1u << 18); }
  __device__ __forceinline__ bool not_out(int32_t o) const { return word(o) & (1u << 19); }
  __device__ __forceinline__ int32_t aff(int32_t o) const { return word(o) & 0x1FFFFu; }
};

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

// the first version's row, verbatim but for the per-OSD reader
template <int WB, class Osd>
__device__ __forceinline__ void pr8_row(
    int i, const int32_t* __restrict__ raw, const uint32_t* __restrict__ pps,
    const int32_t* __restrict__ raw_len, const int32_t* __restrict__ up_rows,
    const int32_t* __restrict__ up_len, const int32_t* __restrict__ items,
    const int32_t* __restrict__ temp_rows, const int32_t* __restrict__ temp_len,
    const int32_t* __restrict__ ptemp, const Osd& osd, int w, int P, int erasure,
    int32_t* __restrict__ out) {
  const int64_t rw = (int64_t)i * w;
  int32_t cell[WB];
  bool keep[WB];
#pragma unroll
  for (int c = 0; c < WB; ++c) {
    cell[c] = c < w ? __ldg(&raw[rw + c]) : kItemNone;
    keep[c] = cell[c] != kItemNone;
  }
  int32_t row[WB];
  int base_len;
  if (erasure) {
#pragma unroll
    for (int c = 0; c < WB; ++c) row[c] = cell[c];
    base_len = __ldg(&raw_len[i]);
  } else {
    base_len = compact<WB>(cell, keep, w, kItemNone, row);
  }
  const int32_t* pr = items + (int64_t)i * P * 2;
  for (int p = 0; p < P; ++p) {
    const int32_t frm = __ldg(&pr[2 * p]);
    const int32_t to = __ldg(&pr[2 * p + 1]);
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
    if (has && !to_in && osd.exists(to) && osd.not_out(to)) {
#pragma unroll
      for (int c = 0; c < WB; ++c)
        if (c == first) row[c] = to;
    }
  }
  const int ul = __ldg(&up_len[i]);
  bool allok = ul > 0;
#pragma unroll
  for (int c = 0; c < WB; ++c) {
    cell[c] = c < w ? __ldg(&up_rows[rw + c]) : kItemNone;
    if (c < w && c < ul && !(osd.exists(cell[c]) && osd.not_out(cell[c]))) allok = false;
  }
  int row_len = base_len;
  if (allok) {
#pragma unroll
    for (int c = 0; c < WB; ++c) row[c] = cell[c];
    row_len = ul;
  }
  int32_t up[WB];
  int up_n;
#pragma unroll
  for (int c = 0; c < WB; ++c)
    keep[c] = c < row_len && row[c] != kItemNone && osd.exists(row[c]) && osd.is_up(row[c]);
  if (erasure) {
#pragma unroll
    for (int c = 0; c < WB; ++c) up[c] = keep[c] ? row[c] : kNoOsd;
    up_n = row_len;
  } else {
    up_n = compact<WB>(row, keep, w, kNoOsd, up);
  }
  int32_t up_primary = kNoOsd;
#pragma unroll
  for (int c = WB - 1; c >= 0; --c)
    if (c < w && up[c] != kNoOsd) up_primary = up[c];
  bool default_all = true;
#pragma unroll
  for (int c = 0; c < WB; ++c)
    if (c < w && up[c] != kNoOsd && osd.aff(up[c]) != kMaxAffinity) default_all = false;
  int32_t prim = up_primary;
  if (!default_all) {
    const uint32_t seed = __ldg(&pps[i]);
#pragma unroll
    for (int c = WB - 1; c >= 0; --c) {
      if (c < w && up[c] != kNoOsd) {
        const int32_t a = osd.aff(up[c]);
        const int32_t h = (int32_t)(hash32_2(seed, (uint32_t)up[c]) >> 16);
        if (a == kMaxAffinity || h < a) prim = up[c];
      }
    }
  }
  const int tl = __ldg(&temp_len[i]);
  int32_t act[WB];
#pragma unroll
  for (int c = 0; c < WB; ++c) act[c] = tl > 0 && c < w ? __ldg(&temp_rows[rw + c]) : up[c];
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
  const int32_t pt = __ldg(&ptemp[i]);
  const int32_t act_primary = pt != kNoOsd ? pt : (same ? prim : act_first);
  int32_t* o = out + (int64_t)i * (2 * w + 4);
#pragma unroll
  for (int c = 0; c < WB; ++c) {
    if (c < w) {
      o[c] = up[c];
      o[w + c] = act[c];
    }
  }
  o[2 * w] = up_n;
  o[2 * w + 1] = prim;
  o[2 * w + 2] = act_n;
  o[2 * w + 3] = act_primary;
}

template <int WB>
__global__ void pr8_kernel(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
                           const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
                           const int32_t* temp_rows, const int32_t* temp_len,
                           const int32_t* ptemp, OsdVectors osd, int n, int w, int P,
                           int erasure, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  pr8_row<WB>(i, raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, osd, w,
              P, erasure, out);
}

template <int WB>
__global__ void pr8_words_kernel(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
                                 const int32_t* up_rows, const int32_t* up_len,
                                 const int32_t* items, const int32_t* temp_rows,
                                 const int32_t* temp_len, const int32_t* ptemp,
                                 const uint32_t* words, int m, int n, int w, int P, int erasure,
                                 int32_t* out) {
  extern __shared__ uint32_t s_words[];
  for (int k = threadIdx.x; k < m; k += blockDim.x) s_words[k] = __ldg(&words[k]);
  __syncthreads();
  const SmemWords osd{s_words, m};
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    pr8_row<WB>(i, raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, osd,
                w, P, erasure, out);
}

// what the first version loads, one thread a row, into packed rows
__global__ void copy_rows_kernel(const int32_t* __restrict__ raw,
                                 const int32_t* __restrict__ up_rows,
                                 const int32_t* __restrict__ up_len,
                                 const int32_t* __restrict__ items,
                                 const int32_t* __restrict__ temp_rows,
                                 const int32_t* __restrict__ temp_len,
                                 const int32_t* __restrict__ ptemp, int n, int w, int P,
                                 int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t rw = (int64_t)i * w;
  const int tl = __ldg(&temp_len[i]);
  int32_t x = 0;
  for (int k = 0; k < 2 * P; ++k) x ^= __ldg(&items[(int64_t)i * 2 * P + k]);
  int32_t* o = out + (int64_t)i * (2 * w + 4);
  for (int c = 0; c < w; ++c) {
    o[c] = __ldg(&raw[rw + c]) ^ __ldg(&up_rows[rw + c]);
    o[w + c] = tl > 0 ? __ldg(&temp_rows[rw + c]) : x;
  }
  o[2 * w] = __ldg(&up_len[i]);
  o[2 * w + 1] = tl;
  o[2 * w + 2] = __ldg(&ptemp[i]);
  o[2 * w + 3] = x;
}

// the same loads and stores, a tile of kTile rows through shared memory
// with consecutive threads on consecutive words (odd row strides)
__global__ void copy_tiles_kernel(const int32_t* __restrict__ raw,
                                  const int32_t* __restrict__ up_rows,
                                  const int32_t* __restrict__ up_len,
                                  const int32_t* __restrict__ items,
                                  const int32_t* __restrict__ temp_rows,
                                  const int32_t* __restrict__ temp_len,
                                  const int32_t* __restrict__ ptemp, int n, int w, int P,
                                  int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  const int sw = w | 1, si = (2 * P) | 1, d = 2 * w + 4, so = d | 1;
  int32_t* s_raw = sm;
  int32_t* s_up = s_raw + kTile * sw;
  int32_t* s_it = s_up + kTile * sw;
  int32_t* s_out = s_it + kTile * si;
  const int row0 = blockIdx.x * kTile;
  const int rows = min(kTile, n - row0);
  const int tid = threadIdx.x;
  for (int k = tid; k < rows * w; k += blockDim.x) {
    const int r = k / w, c = k - r * w;
    s_raw[r * sw + c] = __ldg(&raw[(int64_t)row0 * w + k]);
    s_up[r * sw + c] = __ldg(&up_rows[(int64_t)row0 * w + k]);
  }
  for (int k = tid; k < rows * 2 * P; k += blockDim.x) {
    const int r = k / (2 * P), c = k - r * 2 * P;
    s_it[r * si + c] = __ldg(&items[(int64_t)row0 * 2 * P + k]);
  }
  __syncthreads();
  if (tid < rows) {
    const int i = row0 + tid;
    const int tl = __ldg(&temp_len[i]);
    int32_t x = 0;
    for (int k = 0; k < 2 * P; ++k) x ^= s_it[tid * si + k];
    int32_t* o = s_out + tid * so;
    for (int c = 0; c < w; ++c) {
      o[c] = s_raw[tid * sw + c] ^ s_up[tid * sw + c];
      o[w + c] = tl > 0 ? __ldg(&temp_rows[(int64_t)i * w + c]) : x;
    }
    o[2 * w] = __ldg(&up_len[i]);
    o[2 * w + 1] = tl;
    o[2 * w + 2] = __ldg(&ptemp[i]);
    o[2 * w + 3] = x;
  }
  __syncthreads();
  for (int k = tid; k < rows * d; k += blockDim.x) {
    const int r = k / d;
    out[(int64_t)row0 * d + k] = s_out[r * so + (k - r * d)];
  }
}

template <class F>
int by_width(int w, F&& f) {
  if (w <= 4) return f(std::integral_constant<int, 4>{});
  if (w <= 8) return f(std::integral_constant<int, 8>{});
  if (w <= 16) return f(std::integral_constant<int, 16>{});
  return f(std::integral_constant<int, 32>{});
}

}  // namespace ab

using namespace ab;

extern "C" int pr8_ladder_launch(const void* raw, const void* pps, const void* raw_len,
                                 const void* up_rows, const void* up_len, const void* items,
                                 const void* temp_rows, const void* temp_len, const void* ptemp,
                                 const void* state, const void* weight, const void* affinity,
                                 int m_osd, int n, int w, int P, int erasure, void* out,
                                 void* stream) {
  if (n <= 0) return 0;
  const OsdVectors osd{(const int32_t*)state, (const long long*)weight,
                       (const int32_t*)affinity, m_osd};
  cudaStream_t s = (cudaStream_t)stream;
  return by_width(w, [&](auto wb) {
    pr8_kernel<decltype(wb)::value><<<blocks_for(n), kThreads, 0, s>>>(
        (const int32_t*)raw, (const uint32_t*)pps, (const int32_t*)raw_len,
        (const int32_t*)up_rows, (const int32_t*)up_len, (const int32_t*)items,
        (const int32_t*)temp_rows, (const int32_t*)temp_len, (const int32_t*)ptemp, osd, n, w, P,
        erasure, (int32_t*)out);
    return (int)cudaGetLastError();
  });
}

extern "C" int pr8_words_launch(const void* raw, const void* pps, const void* raw_len,
                                const void* up_rows, const void* up_len, const void* items,
                                const void* temp_rows, const void* temp_len, const void* ptemp,
                                const void* words, int m_osd, int n, int w, int P, int erasure,
                                void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = 4 * m_osd;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return by_width(w, [&](auto wb) {
    const auto kernel = pr8_words_kernel<decltype(wb)::value>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    const int blocks = min(blocks_for(n), sms * (per_sm > 0 ? per_sm : 1));
    kernel<<<blocks, kThreads, smem, s>>>(
        (const int32_t*)raw, (const uint32_t*)pps, (const int32_t*)raw_len,
        (const int32_t*)up_rows, (const int32_t*)up_len, (const int32_t*)items,
        (const int32_t*)temp_rows, (const int32_t*)temp_len, (const int32_t*)ptemp,
        (const uint32_t*)words, m_osd, n, w, P, erasure, (int32_t*)out);
    return (int)cudaGetLastError();
  });
}

// raw, up_rows, up_len, items, temp_rows, temp_len, ptemp, n, w, P, out,
// tiles (0: one thread a row, 1: tiles through shared memory), stream
extern "C" int copy_ladder_launch(const void* raw, const void* up_rows, const void* up_len,
                                  const void* items, const void* temp_rows, const void* temp_len,
                                  const void* ptemp, int n, int w, int P, void* out, int tiles,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* a_raw = (const int32_t*)raw;
  const auto* a_ur = (const int32_t*)up_rows;
  const auto* a_ul = (const int32_t*)up_len;
  const auto* a_it = (const int32_t*)items;
  const auto* a_tr = (const int32_t*)temp_rows;
  const auto* a_tl = (const int32_t*)temp_len;
  const auto* a_pt = (const int32_t*)ptemp;
  if (!tiles) {
    copy_rows_kernel<<<blocks_for(n), kThreads, 0, s>>>(a_raw, a_ur, a_ul, a_it, a_tr, a_tl, a_pt,
                                                       n, w, P, (int32_t*)out);
    return (int)cudaGetLastError();
  }
  const int smem = 4 * kTile * (2 * (w | 1) + ((2 * P) | 1) + ((2 * w + 4) | 1));
  cudaError_t err = cudaFuncSetAttribute(copy_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  copy_tiles_kernel<<<(n + kTile - 1) / kTile, kTile, smem, s>>>(a_raw, a_ur, a_ul, a_it, a_tr,
                                                                 a_tl, a_pt, n, w, P,
                                                                 (int32_t*)out);
  return (int)cudaGetLastError();
}

#ifndef AB_FIRST_ONLY
namespace ab {

constexpr int kVSmemBytesMax = 232448;

// placement.cu's word, from the block's table in shared memory (kLdg
// false) or through __ldg
template <bool kLdg>
struct VWords {
  const uint32_t* w;
  int m;

  __device__ __forceinline__ uint32_t operator()(int32_t o) const {
    const int c = o < 0 ? 0 : (o >= m ? m - 1 : o);
    const uint32_t v = kLdg ? __ldg(&w[c]) : w[c];
    return (o >= 0 && o < m) ? v : (uint32_t)kMaxAffinity;
  }
};

struct VLayout {
  int rows, sw, si, so, words, stage, stages;
  uint32_t m_raw, m_items, m_out;

  VLayout(int rows_, int w, int P, int m_words, int stages_, bool nat)
      : rows(rows_), sw(nat ? w : w | 1), si(nat ? 2 * P : (2 * P) | 1), so((2 * w + 4) | 1),
        words((m_words + 3) & ~3), stage((rows_ * (sw + si + 4) + 3) & ~3), stages(stages_),
        m_raw(div_magic(w)), m_items(div_magic(2 * P)), m_out(div_magic(2 * w + 4)) {}

  size_t bytes() const {
    return 4 * ((size_t)words + (size_t)stages * stage + (size_t)rows * so);
  }
};

template <int N>
__device__ __forceinline__ void v_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void v_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void v_rows(int32_t* dst, const int32_t* src, int n, int d, int s,
                                       uint32_t magic) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = (int)div_small((uint32_t)k, (uint32_t)d, magic);
    cp_async4(dst + r * s + (k - r * d), src + k);
  }
}

template <int WB, bool kLdg, int S, bool kNat, int T, int MINB>
__global__ void __launch_bounds__(T, MINB) v_kernel(
    const int32_t* __restrict__ raw, const uint32_t* __restrict__ pps,
    const int32_t* __restrict__ raw_len, const int32_t* __restrict__ up_rows,
    const int32_t* __restrict__ up_len, const int32_t* __restrict__ items,
    const int32_t* __restrict__ temp_rows, const int32_t* __restrict__ temp_len,
    const int32_t* __restrict__ ptemp, const uint32_t* __restrict__ words, int m_osd, int n,
    int w, int P, int erasure, VLayout lay, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];
  const int tid = threadIdx.x;
  const int tiles = (n + T - 1) / T;
  const int d_out = 2 * w + 4;
  int32_t* const stage0 = smem + lay.words;
  int32_t* const s_out = stage0 + S * lay.stage;

  auto load = [&](int st, int t) {
    int32_t* dst = stage0 + st * lay.stage;
    const int row0 = t * T;
    const int rows = min(T, n - row0);
    int32_t* vec = dst + T * (lay.sw + lay.si);
    if (kNat) {
      stage_contig(dst, raw + (int64_t)row0 * w, rows * w);
      stage_contig(dst + T * w, items + (int64_t)row0 * 2 * P, rows * 2 * P);
      stage_contig(vec, up_len + row0, rows);
      stage_contig(vec + T, temp_len + row0, rows);
      stage_contig(vec + 2 * T, ptemp + row0, rows);
      if (erasure) stage_contig(vec + 3 * T, raw_len + row0, rows);
      return;
    }
    v_rows(dst, raw + (int64_t)row0 * w, rows * w, w, lay.sw, lay.m_raw);
    v_rows(dst + T * lay.sw, items + (int64_t)row0 * 2 * P, rows * 2 * P, 2 * P, lay.si,
           lay.m_items);
    for (int k = tid; k < rows; k += blockDim.x) {
      cp_async4(vec + k, up_len + row0 + k);
      cp_async4(vec + T + k, temp_len + row0 + k);
      cp_async4(vec + 2 * T + k, ptemp + row0 + k);
      if (erasure) cp_async4(vec + 3 * T + k, raw_len + row0 + k);
    }
  };

  if (!kLdg)
    for (int k = tid; k < m_osd; k += blockDim.x) cp_async4(smem + k, words + k);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    const int t = blockIdx.x + s * gridDim.x;
    if (t < tiles) load(s, t);
    v_commit();
  }
  const VWords<kLdg> word{kLdg ? words : (const uint32_t*)smem, m_osd};
  int st = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tn = t + (S - 1) * gridDim.x;
    if (tn < tiles) load(st == 0 ? S - 1 : st - 1, tn);
    v_commit();
    v_wait<S - 1>();
    __syncthreads();
    const int32_t* cur = stage0 + st * lay.stage;
    const int row0 = t * T;
    const int rows = min(T, n - row0);
    if (tid < rows) {
      const int64_t i = row0 + tid;
      const int32_t* vec = cur + T * (lay.sw + lay.si);
      finish_row<WB>(cur + tid * lay.sw, erasure ? vec[3 * T + tid] : 0,
                     cur + T * lay.sw + tid * lay.si, P, vec[tid], up_rows + i * w, vec[T + tid],
                     temp_rows + i * w, vec[2 * T + tid], pps + i, w, erasure != 0, word,
                     s_out + tid * lay.so);
    }
    __syncthreads();
    int32_t* o = out + (int64_t)row0 * d_out;
    for (int k = tid; k < rows * d_out; k += blockDim.x) {
      const int r = (int)div_small((uint32_t)k, (uint32_t)d_out, lay.m_out);
      o[k] = s_out[r * lay.so + (k - r * d_out)];
    }
    st = st == S - 1 ? 0 : st + 1;
  }
  v_wait<0>();
}

template <int WB, bool kLdg, int S, bool kNat, int T, int MINB>
int v_launch(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
             const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
             const int32_t* temp_rows, const int32_t* temp_len, const int32_t* ptemp,
             const uint32_t* words, int m_osd, int n, int w, int P, int erasure, int32_t* out,
             cudaStream_t s, bool persistent) {
  const auto kernel = v_kernel<WB, kLdg, S, kNat, T, MINB>;
  const VLayout lay(T, w, P, kLdg ? 0 : m_osd, S, kNat);
  if (lay.bytes() > (size_t)kVSmemBytesMax) return (int)cudaErrorInvalidValue;
  const int smem = (int)lay.bytes();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + T - 1) / T;
  int blocks = tiles;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
    blocks = min(tiles, sms * (per_sm > 0 ? per_sm : 1));
  }
  kernel<<<blocks, T, smem, s>>>(raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len,
                                 ptemp, words, m_osd, n, w, P, erasure, lay, out);
  return (int)cudaGetLastError();
}

template <bool kLdg, int S, bool kNat, int T, int MINB>
int v_width(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
            const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
            const int32_t* temp_rows, const int32_t* temp_len, const int32_t* ptemp,
            const uint32_t* words, int m_osd, int n, int w, int P, int erasure, int32_t* out,
            cudaStream_t s, bool persistent) {
  if (w <= 4)
    return v_launch<4, kLdg, S, kNat, T, MINB>(raw, pps, raw_len, up_rows, up_len, items,
                                               temp_rows, temp_len, ptemp, words, m_osd, n, w, P,
                                               erasure, out, s, persistent);
  if (w <= 8)
    return v_launch<8, kLdg, S, kNat, T, MINB>(raw, pps, raw_len, up_rows, up_len, items,
                                               temp_rows, temp_len, ptemp, words, m_osd, n, w, P,
                                               erasure, out, s, persistent);
  if (w <= 16)
    return v_launch<16, kLdg, S, kNat, T, MINB>(raw, pps, raw_len, up_rows, up_len, items,
                                                temp_rows, temp_len, ptemp, words, m_osd, n, w,
                                                P, erasure, out, s, persistent);
  return v_launch<32, kLdg, S, kNat, T, MINB>(raw, pps, raw_len, up_rows, up_len, items,
                                              temp_rows, temp_len, ptemp, words, m_osd, n, w, P,
                                              erasure, out, s, persistent);
}

}  // namespace ab

// placement.cu's operands, then the variant: ldg (0: a table in shared
// memory a block), stages, nat (1: 16 bytes a copy as the operands lie; 0:
// restrided, stages 2-4 only), persistent, rows a tile (64, 128, 256: one
// stage, 16-byte, __ldg only but 128), least blocks an SM (1, or 16 at 128
// rows), stream
extern "C" int tile_variant_launch(const void* raw, const void* pps, const void* raw_len,
                                   const void* up_rows, const void* up_len, const void* items,
                                   const void* temp_rows, const void* temp_len,
                                   const void* ptemp, const void* words, int m_osd, int n, int w,
                                   int P, int erasure, void* out, int ldg, int stages, int nat,
                                   int persistent, int rows, int min_blocks, void* stream) {
  if (n <= 0) return 0;
  const auto* a = (const int32_t*)raw;
  const auto* b = (const uint32_t*)pps;
  const auto* c = (const int32_t*)raw_len;
  const auto* d = (const int32_t*)up_rows;
  const auto* e = (const int32_t*)up_len;
  const auto* f = (const int32_t*)items;
  const auto* g = (const int32_t*)temp_rows;
  const auto* h = (const int32_t*)temp_len;
  const auto* k = (const int32_t*)ptemp;
  const auto* wd = (const uint32_t*)words;
  auto* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool per = persistent != 0;
#define V(L, S_, N_, T_, M_) \
  return v_width<L, S_, N_, T_, M_>(a, b, c, d, e, f, g, h, k, wd, m_osd, n, w, P, erasure, o, s, per)
  if (rows == 64) V(true, 1, true, 64, 1);
  if (rows == 256) V(true, 1, true, 256, 1);
  if (min_blocks == 16) V(true, 1, true, 128, 16);
  if (nat) {
    if (ldg) {
      if (stages == 1) V(true, 1, true, 128, 1);
      if (stages == 2) V(true, 2, true, 128, 1);
      if (stages == 3) V(true, 3, true, 128, 1);
      V(true, 4, true, 128, 1);
    }
    if (stages == 1) V(false, 1, true, 128, 1);
    if (stages == 2) V(false, 2, true, 128, 1);
    if (stages == 3) V(false, 3, true, 128, 1);
    V(false, 4, true, 128, 1);
  }
  if (ldg) {
    if (stages == 2) V(true, 2, false, 128, 1);
    if (stages == 3) V(true, 3, false, 128, 1);
    V(true, 4, false, 128, 1);
  }
  if (stages == 2) V(false, 2, false, 128, 1);
  if (stages == 3) V(false, 3, false, 128, 1);
  V(false, 4, false, 128, 1);
#undef V
}

// placement.cu's operands, then the carveout (-1: the default),
// stream: placement.cu's kernel launched as launch_ladder launches it, but
// at this carveout instead of words_carveout's
extern "C" int this_carveout_launch(const void* raw, const void* pps, const void* raw_len,
                                    const void* up_rows, const void* up_len, const void* items,
                                    const void* temp_rows, const void* temp_len,
                                    const void* ptemp, const void* words, int m_osd, int n, int w,
                                    int P, int erasure, void* out, int carveout, void* stream) {
  if (n <= 0) return 0;
  return by_width(w, [&](auto wb) {
    const auto kernel = pg_finish_ladder_kernel<decltype(wb)::value>;
    const int rows = kTileRows;
    const size_t smem = Tile::bytes(rows, w, P);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(n + rows - 1) / rows, rows, smem, (cudaStream_t)stream>>>(
        (const int32_t*)raw, (const uint32_t*)pps, (const int32_t*)raw_len,
        (const int32_t*)up_rows, (const int32_t*)up_len, (const int32_t*)items,
        (const int32_t*)temp_rows, (const int32_t*)temp_len, (const int32_t*)ptemp,
        (const uint32_t*)words, m_osd, n, w, P, erasure, Tile(rows, w), (int32_t*)out);
    return (int)cudaGetLastError();
  });
}
#endif  // AB_FIRST_ONLY
