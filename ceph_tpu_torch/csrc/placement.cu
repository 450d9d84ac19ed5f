// The fused placement tail (ops/placement_kernel.py): pg_finish_ladder.
// It replaces the JAX package's jitted ladder, ceph_tpu/ops/placement_kernel.py
// _ladder_impl (reached through _ladder_jit and run_ladder), which XLA ran as
// a chain of sorts, gathers and selects over (N, W) tables.
//
// Bound: bytes.  The function needs 4W + 8P + 12 bytes of a row's operands
// (the raw row, the pairs, up_len, temp_len, ptemp) and writes 8W + 16 (204
// bytes at W = 12, P = 4); raw_len is read on erasure pools only, the pg_temp
// row and pps only where the row has one or needs the coin flip.  The kernel
// also reads every row's W pg_upmap cells: reading only up_len of them moved
// fewer bytes but did not make it faster.  Against that, a few hundred
// integer operations (more only where primary affinity needs the coin-flip
// hash), so the card's memory rate bounds it; the design reads each operand
// once, keeps every intermediate in registers and writes the packed row once.
//
// One thread finishes one PG row: the raw CRUSH row (W cells), then
// pg_upmap_items (P pairs, in order), pg_upmap, the up/state filter, the
// primary-affinity coin flip (hash32_2 of straw2_common.cuh) and the
// pg_temp / primary_temp overrides, into the packed row
// [up (W) | acting (W) | up_len | up_primary | acting_len | acting_primary].
// It computes exactly ladder_ref (placement_kernel.py), step for step.
//
// Rows are independent, so there is no shared memory and no cooperation
// between threads.  A row's cells sit in registers: one template instance
// per width bucket WB (4, 8, 16, 32) covers every W <= WB, and every loop
// over cells is unrolled to WB with a `c < w` guard, so no cell array is
// indexed by a run-time value.  A stable compaction (replicated rows) takes
// the j-th kept cell for each output j: O(WB^2) compares, all in registers.
// P is a run-time loop.
//
// Per-OSD reads clamp the id to 0 .. m_osd - 1 (as the reference's gather
// does) and are masked by the range test, so the garbage rows of a padded
// bucket read nothing out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "straw2_common.cuh"

namespace {

constexpr int32_t kNoOsd = -1;
constexpr int32_t kMaxAffinity = 0x10000;
constexpr int32_t kOsdExists = 1;
constexpr int32_t kOsdUp = 2;

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

template <int WB>
__global__ void pg_finish_ladder_kernel(
    const int32_t* __restrict__ raw, const uint32_t* __restrict__ pps,
    const int32_t* __restrict__ raw_len, const int32_t* __restrict__ up_rows,
    const int32_t* __restrict__ up_len, const int32_t* __restrict__ items,
    const int32_t* __restrict__ temp_rows, const int32_t* __restrict__ temp_len,
    const int32_t* __restrict__ ptemp, OsdVectors osd, int n, int w, int P,
    int erasure, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t rw = (int64_t)i * w;

  // -- the base row: replicated rows compact their NONE holes first
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

  // -- pg_upmap_items: each pair sees the previous pair's rewrite; the
  // scans cover the active length only (a NONE frm never matches a pad)
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

  // -- pg_upmap: wholesale when present and every entry exists and is in
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

  // -- raw -> up: drop nonexistent and down osds
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

  // -- primary affinity: skipped when every member has default affinity;
  // else the first member that wins its coin flip, or the positional one
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

  // -- temps: pg_temp replaces acting; primary_temp wins over both
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

}  // namespace

// raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp,
// state, weight, affinity, m_osd, n, w, P, erasure, out, stream
extern "C" int pg_finish_ladder_launch(const void* raw, const void* pps, const void* raw_len,
                                       const void* up_rows, const void* up_len, const void* items,
                                       const void* temp_rows, const void* temp_len,
                                       const void* ptemp, const void* state, const void* weight,
                                       const void* affinity, int m_osd, int n, int w, int P,
                                       int erasure, void* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || w > 32 || m_osd < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const OsdVectors osd{(const int32_t*)state, (const long long*)weight,
                       (const int32_t*)affinity, m_osd};
  const auto* a_raw = (const int32_t*)raw;
  const auto* a_pps = (const uint32_t*)pps;
  const auto* a_rl = (const int32_t*)raw_len;
  const auto* a_ur = (const int32_t*)up_rows;
  const auto* a_ul = (const int32_t*)up_len;
  const auto* a_it = (const int32_t*)items;
  const auto* a_tr = (const int32_t*)temp_rows;
  const auto* a_tl = (const int32_t*)temp_len;
  const auto* a_pt = (const int32_t*)ptemp;
  auto* a_out = (int32_t*)out;
  const int blocks = blocks_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= 4)
    pg_finish_ladder_kernel<4><<<blocks, kThreads, 0, s>>>(
        a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, osd, n, w, P, erasure, a_out);
  else if (w <= 8)
    pg_finish_ladder_kernel<8><<<blocks, kThreads, 0, s>>>(
        a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, osd, n, w, P, erasure, a_out);
  else if (w <= 16)
    pg_finish_ladder_kernel<16><<<blocks, kThreads, 0, s>>>(
        a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, osd, n, w, P, erasure, a_out);
  else
    pg_finish_ladder_kernel<32><<<blocks, kThreads, 0, s>>>(
        a_raw, a_pps, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, osd, n, w, P, erasure, a_out);
  return (int)cudaGetLastError();
}
