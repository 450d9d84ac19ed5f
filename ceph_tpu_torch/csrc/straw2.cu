// CRUSH straw2 column kernels for the chooseleaf/choose firstn fast path.
//
// Replace the TPU kernels of ceph_tpu/ops/pallas_straw2.py:
//   straw2_root     <- _root_kernel    (PallasColumns.root_columns)
//   straw2_leaf     <- _leaf_kernel    (PallasColumns.leaf_columns)
//   firstn_consume  <- _consume_kernel (consume_columns)
// and keep their (R, N) column layout: row r of every output is one r value
// of the retry ladder, over the N inputs x.
//
// The draw.  bucket_straw2_choose (mapper.c:361-384) draws
// trunc((crush_ln(hash32_3(x, id, r) & 0xffff) - 2^48) / w), which for w > 0
// is -(P / w) with P = 2^48 - crush_ln(...) >= 0, so the largest draw is the
// least unsigned quotient P / w.  A strict '<' keeps the first of equal
// quotients, as the reference's strict '>' keeps the first maximum; a
// zero-weight item gets the quotient 2^64-1 and never beats an item with
// weight.  crush_ln runs as in mapper.c (RH/LH/LL tables in shared memory,
// u64 wrap-around product).  None of the TPU kernel's Mosaic workarounds
// (f32 bit-length, sign-biased compares, one-hot lookups) is needed.
//
// Bound on the H100: operations, and of those the integer pipe.  A draw is
// the rjenkins hash32_3 (135 instructions, 120 of them IADD3/LOP3/SHF on
// the integer pipe, 64 lanes an SM), crush_ln and the quotient; the columns
// move a few bytes per draw.  The root kernel's design removes what used to
// sit on top of the hash:
//  * no 64-bit divide: Hopper has no integer divider, and P / w was a
//    multi-instruction routine per item.  The host turns each item weight
//    into a magic pair (m, s) once per map (straw2_cuda.magic_tables), and
//    the quotient is __umul64hi(P, m) >> s (straw2_qm), exact for every
//    P <= 2^48;
//  * a full grid at small launches: stage 2 of the fast path (4,096 x 9
//    columns) and small flat maps are a fraction of a wave at one thread per
//    (x, r).  A group of G lanes (a power of two <= 32, chosen by the
//    wrapper to fill one wave, straw2_cuda.group_lanes) shares each (x, r):
//    lane l draws the items s = l (mod G) and the group merges its first
//    minima by a shuffle butterfly (merge_least).  G = 1 at stage 1
//    (65,536 x 4 columns), G = 8 at the stage-2 launch.
// The leaf kernel is launched at the same shapes but draws only the winning
// host's row, with the same two measures: the host builds one 16-byte record
// {int32 id, int32 shift, u64 magic} per (host, slot) once per map
// (straw2_cuda.leaf_records, the TPU kernel's packed [ids | wz | off | magic]
// host row in u64 form), so an item is one 16-byte read-only load and a
// magic quotient, and G lanes share each (x, r) (G = 8 at the stage-2
// launch; the wide map's 10-item rows cap it at 8).
//
// The consume kernel runs the firstn ladder of one x per thread and decides
// is_out itself (mapper.c:424-438, ops/crush_kernel.is_out): the TPU kernel
// takes the verdicts as a column computed outside it (a Mosaic miscompile,
// ceph_tpu/crush/fastpath.py:358-363), which in torch is ~170 eager
// operations over every (r, x); here only the rows the ladder reads are
// judged, and only those that collide with no earlier replica are hashed
// (hash32_2 and one 8-byte reweight load).  Its bound is the rows it reads
// and, beyond the launch, the chain of dependent steps of one x: the design
// keeps that chain out of memory.  A template instance per numrep (1..8)
// keeps the selections in registers (fully unrolled over replicas, written
// once at the end, never read back) and loads the first numrep + 1 rows
// (all of stage 1's columns) before the ladder starts; a generic instance
// serves any larger numrep, keeping its selections in its own output
// columns and reading them back.  The wrapper picks the block size
// so that the stage-2 launch (4,096 x) spreads over the SMs
// (straw2_cuda.consume_threads).

#include "straw2_common.cuh"

namespace {

// (R, N) root columns: G = 1 << lg lanes per (x, r), see the header
__global__ void straw2_root_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                   const int32_t* __restrict__ ids,
                                   const uint64_t* __restrict__ magic,
                                   const int32_t* __restrict__ shift, int S, int lg,
                                   const uint64_t* __restrict__ ln_tab,
                                   int32_t* __restrict__ out_pos,
                                   int32_t* __restrict__ out_id) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_tab = smem;
  uint64_t* s_m = smem + kLnEntries;
  int32_t* s_s = reinterpret_cast<int32_t*>(s_m + S);
  int32_t* s_ids = s_s + S;
  load_ln(s_tab, ln_tab);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_m[i] = magic[i];
    s_s[i] = shift[i];
    s_ids[i] = ids[i];
  }
  __syncthreads();
  // no early return: every lane of a warp takes part in the shuffles
  const int G = 1 << lg;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t col = tid >> lg;
  const int lane = (int)(tid & (G - 1));
  const bool valid = col < (int64_t)n * R;
  // 32-bit: the wrapper keeps n * R < 2^31, and a 64-bit divide is a routine
  const int r = valid ? (int)((uint32_t)col / (uint32_t)n) : 0;
  const uint32_t x = valid ? xs[(int)col - r * n] : 0u;
  int best = lane;               // G <= S: every lane has an item
  uint64_t best_q = ~0ull;
  for (int s = valid ? lane : S; s < S; s += G) {
    const uint64_t q = straw2_qm(x, s_ids[s], (uint32_t)r, s_m[s], s_s[s], s_tab);
    if (q < best_q) {
      best_q = q;
      best = s;
    }
  }
  merge_least(best_q, best, G);
  if (valid && lane == 0) {
    out_pos[col] = best;
    out_id[col] = s_ids[best];
  }
}

// (R, N) leaf columns: the straw2 draw in the winning host's row of records,
// G = 1 << lg lanes per (x, r) as in the root kernel
__global__ void straw2_leaf_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                   const int32_t* __restrict__ root_pos,
                                   const int4* __restrict__ rec,
                                   const int32_t* __restrict__ leaf_ids, int H,
                                   int S, int lg, int vary_r,
                                   const uint64_t* __restrict__ ln_tab,
                                   int32_t* __restrict__ out_id) {
  __shared__ uint64_t s_tab[kLnEntries];
  load_ln(s_tab, ln_tab);
  __syncthreads();
  // no early return: every lane of a warp takes part in the shuffles
  const int G = 1 << lg;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t col = tid >> lg;
  const int lane = (int)(tid & (G - 1));
  const bool valid = col < (int64_t)n * R;
  // 32-bit: the wrapper keeps n * R < 2^31
  const int r = valid ? (int)((uint32_t)col / (uint32_t)n) : 0;
  const uint32_t x = valid ? xs[(int)col - r * n] : 0u;
  const int host = valid ? root_pos[col] : -1;
  // a position that is no root winner has nothing to descend: NONE
  const bool live = host >= 0 && host < H;
  // r_leaf = vary_r ? r >> (vary_r - 1) : 0  (mapper.c:578)
  const uint32_t r_leaf = vary_r ? ((uint32_t)r >> (vary_r - 1)) : 0u;
  const int4* row = rec + (live ? (int64_t)host * S : 0);
  int best = lane;               // G <= S: every lane has an item
  uint64_t best_q = ~0ull;       // all weights zero: position 0 wins
  for (int s = live ? lane : S; s < S; s += G) {
    const int4 e = __ldg(row + s);           // {id, shift, magic lo, magic hi}
    const uint64_t m = (uint64_t)(uint32_t)e.z | ((uint64_t)(uint32_t)e.w << 32);
    const uint64_t q = straw2_qm(x, e.x, r_leaf, m, e.y, s_tab);
    if (q < best_q) {
      best_q = q;
      best = s;
    }
  }
  merge_least(best_q, best, G);
  if (valid && lane == 0)
    out_id[col] = live ? leaf_ids[(int64_t)host * S + best] : kItemNone;
}

// is_out (mapper.c:424-438) of device id `id` for input x, as
// ops/crush_kernel.is_out decides it, on the int64 reweight vector: an id
// outside [0, n_rw) (NONE included) is out; a weight >= 0x10000 keeps, 0
// rejects, any other keeps when hash32_2(x, id) & 0xFFFF < w.  The compares
// are on int64, so a negative or oversized weight takes torch's branch.
__device__ __forceinline__ bool is_out(uint32_t x, int32_t id,
                                       const long long* __restrict__ rw, int n_rw) {
  if (id < 0 || id >= n_rw) return true;
  const long long w = __ldg(rw + id);
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return (long long)(hash32_2(x, (uint32_t)id) & 0xFFFFu) >= w;
}

// v[r] of a register array for a run-time r < P, by selects (an indexed
// read would put the array in local memory)
template <int P>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[P], int r) {
  int32_t out = v[0];
#pragma unroll
  for (int k = 1; k < P; ++k) out = r == k ? v[k] : out;
  return out;
}

// crush_choose_firstn (mapper.c:460-648) over precomputed winner columns:
// replica rep draws with r = rep + ftotal, so an active lane at attempt a of
// replica rep reads row rep + a.  A candidate is rejected if its host or
// device equals any slot placed so far (unfilled slots hold NONE, which never
// equals a real id) or if it is out.  A lane still active when the rows run
// out before `tries` attempts raises its overflow flag.  One instance per
// numrep NR in 1..8; NR = 0 is the generic instance below.
template <int NR>
__global__ void firstn_consume_kernel(const int32_t* __restrict__ hw,
                                      const int32_t* __restrict__ lw,
                                      const uint32_t* __restrict__ xs,
                                      const long long* __restrict__ rw, int n_rw,
                                      int R, int n, int numrep, int tries,
                                      int32_t* __restrict__ out_h,
                                      int32_t* __restrict__ out_l,
                                      int32_t* __restrict__ ovf) {
  constexpr int P = NR + 1;                     // rows loaded up front
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = __ldg(xs + i);
  int32_t ph[P], pl[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool in = k < R;
    ph[k] = in ? __ldg(hw + (int64_t)k * n + i) : kItemNone;
    pl[k] = in ? __ldg(lw + (int64_t)k * n + i) : kItemNone;
  }
  int32_t sh[NR], sl[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    sh[j] = kItemNone;
    sl[j] = kItemNone;
  }
  int flag = 0;
#pragma unroll
  for (int rep = 0; rep < NR; ++rep) {
    const int steps = min(tries, R - rep);
    bool done = false;
    for (int a = 0; a < steps && !done; ++a) {
      const int r = rep + a;
      int32_t hb, lf;
      if (r < P) {
        hb = pick(ph, r);
        lf = pick(pl, r);
      } else {
        hb = __ldg(hw + (int64_t)r * n + i);
        lf = __ldg(lw + (int64_t)r * n + i);
      }
      bool bad = false;
#pragma unroll
      for (int j = 0; j < NR; ++j) bad = bad || sh[j] == hb || sl[j] == lf;
      if (!bad && !is_out(x, lf, rw, n_rw)) {
        sh[rep] = hb;
        sl[rep] = lf;
        done = true;
      }
    }
    if (steps < tries && !done) flag = 1;
  }
#pragma unroll
  for (int rep = 0; rep < NR; ++rep) {
    out_h[(int64_t)rep * n + i] = sh[rep];
    out_l[(int64_t)rep * n + i] = sl[rep];
  }
  ovf[i] = flag;
}

// The generic instance: the same ladder for any numrep.  Slot j of input i
// is the output cell j * n + i itself: the one thread that owns input i
// fills it with NONE, places into it and reads it back, so the slots need no
// room in the thread.  While replica rep draws, slots rep and above still
// hold NONE, which only a NONE candidate equals: that test stands in for
// reading them.
template <>
__global__ void firstn_consume_kernel<0>(const int32_t* __restrict__ hw,
                                         const int32_t* __restrict__ lw,
                                         const uint32_t* __restrict__ xs,
                                         const long long* __restrict__ rw,
                                         int n_rw, int R, int n, int numrep,
                                         int tries, int32_t* __restrict__ out_h,
                                         int32_t* __restrict__ out_l,
                                         int32_t* __restrict__ ovf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = __ldg(xs + i);
  for (int j = 0; j < numrep; ++j) {
    out_h[(int64_t)j * n + i] = kItemNone;
    out_l[(int64_t)j * n + i] = kItemNone;
  }
  int flag = 0;
  for (int rep = 0; rep < numrep; ++rep) {
    const int steps = min(tries, R - rep);
    bool done = false;
    for (int a = 0; a < steps && !done; ++a) {
      const int r = rep + a;
      const int32_t hb = __ldg(hw + (int64_t)r * n + i);
      const int32_t lf = __ldg(lw + (int64_t)r * n + i);
      bool bad = hb == kItemNone || lf == kItemNone;
      for (int j = 0; j < rep && !bad; ++j)
        bad = out_h[(int64_t)j * n + i] == hb || out_l[(int64_t)j * n + i] == lf;
      if (!bad && !is_out(x, lf, rw, n_rw)) {
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
                                  const void* magic, const void* shift, int S,
                                  int lg, const void* ln_tab, void* out_pos,
                                  void* out_id, void* stream) {
  const size_t smem = kLnEntries * sizeof(uint64_t) + (size_t)S * (8 + 4 + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        straw2_root_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  straw2_root_kernel<<<blocks_for(((int64_t)n * R) << lg), kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)ids, (const uint64_t*)magic,
      (const int32_t*)shift, S, lg, (const uint64_t*)ln_tab, (int32_t*)out_pos,
      (int32_t*)out_id);
  return (int)cudaGetLastError();
}

extern "C" int straw2_leaf_launch(const void* xs, int n, int R, const void* root_pos,
                                  const void* rec, const void* leaf_ids, int H,
                                  int S, int lg, int vary_r, const void* ln_tab,
                                  void* out_id, void* stream) {
  straw2_leaf_kernel<<<blocks_for(((int64_t)n * R) << lg), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)root_pos, (const int4*)rec,
      (const int32_t*)leaf_ids, H, S, lg, vary_r, (const uint64_t*)ln_tab,
      (int32_t*)out_id);
  return (int)cudaGetLastError();
}

using ConsumeKernel = void (*)(const int32_t*, const int32_t*, const uint32_t*,
                              const long long*, int, int, int, int, int, int32_t*,
                              int32_t*, int32_t*);

extern "C" int firstn_consume_launch(const void* hw, const void* lw, const void* xs,
                                     const void* rw, int n_rw, int R, int n,
                                     int numrep, int tries, void* out_h,
                                     void* out_l, void* ovf, int threads,
                                     void* stream) {
  static const ConsumeKernel kInstances[] = {
      firstn_consume_kernel<0>, firstn_consume_kernel<1>, firstn_consume_kernel<2>,
      firstn_consume_kernel<3>, firstn_consume_kernel<4>, firstn_consume_kernel<5>,
      firstn_consume_kernel<6>, firstn_consume_kernel<7>, firstn_consume_kernel<8>};
  if (numrep < 1 || threads < 32 || threads > kThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  const ConsumeKernel k = kInstances[numrep <= 8 ? numrep : 0];
  k<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hw, (const int32_t*)lw, (const uint32_t*)xs,
      (const long long*)rw, n_rw, R, n, numrep, tries, (int32_t*)out_h,
      (int32_t*)out_l, (int32_t*)ovf);
  return (int)cudaGetLastError();
}
