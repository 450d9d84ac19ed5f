// CRUSH straw2 column kernels for the chooseleaf/choose firstn fast path.
//
// Replace the TPU kernels of ceph_tpu/ops/pallas_straw2.py:
//   straw2_root     <- _root_kernel    (PallasColumns.root_columns)
//   straw2_leaf     <- _leaf_kernel    (PallasColumns.leaf_columns)
//   firstn_consume  <- _consume_kernel (consume_columns)
// and keep their (R, N) column layout: row r of every output is one r value
// of the retry ladder, over the N inputs x.
//
// Design.  One thread per (x, r) walks the bucket's items and keeps the winner
// of bucket_straw2_choose (mapper.c:361-384): the draw is
// trunc((crush_ln(hash32_3(x, id, r) & 0xffff) - 2^48) / w), which for w > 0 is
// -(P / w) with P = 2^48 - crush_ln(...) >= 0, so the largest draw is the least
// unsigned quotient P / w.  A strict '<' keeps the first of equal quotients, as
// the reference's strict '>' keeps the first maximum; a zero-weight item gets
// the quotient 2^64-1 and never beats an item with weight.  Hopper has __clz,
// unsigned compares and 64-bit integers, so crush_ln runs as in mapper.c
// (RH/LH/LL tables in shared memory, u64 wrap-around product) and the divide is
// a plain u64 division: none of the TPU kernel's Mosaic workarounds (f32
// bit-length, sign-biased compares, one-hot table and row lookups, limb magic
// division) is needed.  The leaf kernel reads the winning host's row with a
// plain indexed load.  The consume kernel runs the firstn ladder of one x per
// thread.
//
// Bound on the H100: operations.  Each draw is ~200 32-bit integer operations
// (the rjenkins mix dominates) plus one 64-bit divide; the columns move only a
// few bytes per draw.

#include "straw2_common.cuh"

namespace {

__global__ void straw2_root_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                   const int32_t* __restrict__ ids,
                                   const int64_t* __restrict__ w, int S,
                                   const uint64_t* __restrict__ ln_tab,
                                   int32_t* __restrict__ out_pos,
                                   int32_t* __restrict__ out_id) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_tab = smem;
  int64_t* s_w = reinterpret_cast<int64_t*>(smem + kLnEntries);
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_w + S);
  load_ln(s_tab, ln_tab);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_w[i] = w[i];
    s_ids[i] = ids[i];
  }
  __syncthreads();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)n * R) return;
  const int r = (int)(tid / n);
  const uint32_t x = xs[tid - (int64_t)r * n];
  int best = 0;
  uint64_t best_q = 0;
  for (int s = 0; s < S; ++s) {
    const uint64_t q = straw2_q(x, s_ids[s], (uint32_t)r, s_w[s], s_tab);
    if (s == 0 || q < best_q) {
      best_q = q;
      best = s;
    }
  }
  out_pos[tid] = best;
  out_id[tid] = s_ids[best];
}

__global__ void straw2_leaf_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                   const int32_t* __restrict__ root_pos,
                                   const int32_t* __restrict__ leaf_ids,
                                   const int64_t* __restrict__ leaf_w, int H, int S,
                                   int vary_r, const uint64_t* __restrict__ ln_tab,
                                   int32_t* __restrict__ out_id) {
  __shared__ uint64_t s_tab[kLnEntries];
  load_ln(s_tab, ln_tab);
  __syncthreads();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)n * R) return;
  const int r = (int)(tid / n);
  const uint32_t x = xs[tid - (int64_t)r * n];
  const int host = root_pos[tid];
  if (host < 0 || host >= H) {     // not a root winner: nothing to descend
    out_id[tid] = kItemNone;
    return;
  }
  // r_leaf = vary_r ? r >> (vary_r - 1) : 0  (mapper.c:578)
  const uint32_t r_leaf = vary_r ? ((uint32_t)r >> (vary_r - 1)) : 0u;
  const int32_t* row_ids = leaf_ids + (int64_t)host * S;
  const int64_t* row_w = leaf_w + (int64_t)host * S;
  int best = 0;
  uint64_t best_q = 0;
  for (int s = 0; s < S; ++s) {
    const uint64_t q = straw2_q(x, row_ids[s], r_leaf, row_w[s], s_tab);
    if (s == 0 || q < best_q) {
      best_q = q;
      best = s;
    }
  }
  out_id[tid] = row_ids[best];
}

// crush_choose_firstn (mapper.c:460-648) over precomputed winner columns:
// replica rep draws with r = rep + ftotal, so an active lane at attempt i of
// replica rep reads row rep + i.  A candidate is rejected if its host or device
// equals any slot placed so far (unfilled slots hold NONE, which never equals a
// real id) or if it is out.  A lane still active when the rows run out before
// `tries` attempts raises its overflow flag.
__global__ void firstn_consume_kernel(const int32_t* __restrict__ hw,
                                      const int32_t* __restrict__ lw,
                                      const uint8_t* __restrict__ lb, int R, int n,
                                      int numrep, int tries, int32_t* out_h,
                                      int32_t* out_l, int32_t* __restrict__ ovf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int rep = 0; rep < numrep; ++rep) {
    out_h[(int64_t)rep * n + i] = kItemNone;
    out_l[(int64_t)rep * n + i] = kItemNone;
  }
  int flag = 0;
  for (int rep = 0; rep < numrep; ++rep) {
    const int steps = min(tries, R - rep);
    bool done = false;
    for (int a = 0; a < steps && !done; ++a) {
      const int64_t off = (int64_t)(rep + a) * n + i;
      const int32_t hb = hw[off];
      const int32_t lf = lw[off];
      bool bad = lb[off] != 0;
      for (int j = 0; j < numrep; ++j)
        bad = bad || out_h[(int64_t)j * n + i] == hb || out_l[(int64_t)j * n + i] == lf;
      if (!bad) {
        out_h[(int64_t)rep * n + i] = hb;
        out_l[(int64_t)rep * n + i] = lf;
        done = true;
      }
    }
    if (steps < tries && !done) flag = 1;
  }
  ovf[i] = flag;
}

}  // namespace

extern "C" int straw2_root_launch(const void* xs, int n, int R, const void* ids,
                                  const void* w, int S, const void* ln_tab,
                                  void* out_pos, void* out_id, void* stream) {
  const size_t smem = kLnEntries * sizeof(uint64_t) + (size_t)S * (8 + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        straw2_root_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  straw2_root_kernel<<<blocks_for((int64_t)n * R), kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)ids, (const int64_t*)w, S,
      (const uint64_t*)ln_tab, (int32_t*)out_pos, (int32_t*)out_id);
  return (int)cudaGetLastError();
}

extern "C" int straw2_leaf_launch(const void* xs, int n, int R, const void* root_pos,
                                  const void* leaf_ids, const void* leaf_w, int H,
                                  int S, int vary_r, const void* ln_tab, void* out_id,
                                  void* stream) {
  straw2_leaf_kernel<<<blocks_for((int64_t)n * R), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)root_pos, (const int32_t*)leaf_ids,
      (const int64_t*)leaf_w, H, S, vary_r, (const uint64_t*)ln_tab, (int32_t*)out_id);
  return (int)cudaGetLastError();
}

extern "C" int firstn_consume_launch(const void* hw, const void* lw, const void* lb,
                                     int R, int n, int numrep, int tries,
                                     void* out_h, void* out_l, void* ovf,
                                     void* stream) {
  firstn_consume_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hw, (const int32_t*)lw, (const uint8_t*)lb, R, n, numrep, tries,
      (int32_t*)out_h, (int32_t*)out_l, (int32_t*)ovf);
  return (int)cudaGetLastError();
}
