// Approx-filter root columns and the f32 ln table their certificate rests on.
//
// Replace the TPU kernels of ceph_tpu/ops/pallas_straw2.py:
//   straw2_froot  <- _froot_kernel    (PallasColumns.froot_columns)
//   ln_f32_table  <- _ln_bound_kernel (_ln_f32_bound)
//
// straw2_froot computes what straw2_root computes — the exact straw2 winner
// position and id of the root for every (x, r), in the (R, N) column layout —
// but prices most items with a cheap f32 draw instead of the exact u64 one.
// For each item the f32 quotient q = (2^48 - ln_f32(u)) / w carries a band
// [q - m, q + m] that holds the exact quotient, with the margin of the TPU
// kernel: m = (D + 2^25) / w + q * 2^-20 + 4, where D is the measured
// max |ln_f32(u) - crush_ln(u)| over all 65,536 u.  The exact winner lies in
// the band of every item whose lower end is at most the least upper end.  The
// scan keeps the least upper end and the 5 least (lower end, position) pairs
// in registers, by insertion; the 4 first are verified with the exact
// quotient (first minimum by quotient, then position, as _verify_packed keeps
// it).  If the 5th lower end is still inside the band, more than 4 items may
// hold the winner: the x's flag is raised (atomicOr into a zeroed (N,) array)
// and the caller re-runs the exact root kernel on the whole batch.  None of
// the TPU kernel's 10-bit key packing, sign-biased compares or lane shuffles
// is needed.
//
// The certificate is only sound if D is measured with the very ln values the
// filter prices with.  ln_f32_table writes them, once per device, with the one
// f32 log of this file (ln_f32), and in the same launch reduces D itself, as
// the TPU's _ln_bound_kernel does: each thread also computes the exact
// crush_ln(u) (ln_p48 on the RH|LH|LL tables in shared memory, as the root
// kernels do), rounds it to f32 as torch does (round to nearest even) and
// takes |table - exact|; non-negative floats order as their bit patterns,
// so the maximum is a u32 maximum: __reduce_max_sync in the warp, shared
// memory in the block, one atomicMax per block into a word the launcher
// zeroes.  Its bound is the 65,536 log2f and crush_ln evaluations, a few
// microseconds; it runs once per device and process.  The filter reads the
// ln values back from that table
// (256 KiB, __ldg through L1/L2), and the plain torch version
// (ops/straw2_filter.py) reads the same table, so its bands and flags equal
// the kernel's bit for bit.  The library is built without --use_fast_math,
// and the band arithmetic uses the _rn intrinsics so that no multiply and
// add are fused into an FMA.
//
// Bound on the H100: operations, and of those the integer pipe.  Per item:
// the rjenkins hash (135 instructions, 120 on the integer pipe) and ~17 f32
// operations of the band; per (x, r): 4 exact draws.  The design keeps the
// hash alone in the item loop:
//  * no call per item: the ln value is one table load, not an out-of-line
//    log2f (a call and return of ~33 instructions);
//  * no 64-bit divide in the 4 verifications: the exact quotient is the
//    magic multiply of straw2_qm, as in straw2_root;
//  * a full grid at small launches: G lanes per (x, r) (a power of two
//    <= 32, chosen by the wrapper to fill one wave) scan the items
//    s = l (mod G); the group merges the least upper end by fminf and the
//    5 least (lower end, position) pairs by a shuffle butterfly — the
//    lexicographic order is the serial insertion's tie rule, so the
//    candidates are the serial ones — and lanes 0..3 verify one candidate
//    each.  G = 1 at stage 1 (65,536 x 4 columns), G = 8 at stage 2.

#include "straw2_common.cuh"

namespace {

constexpr int kKeep = 5;                               // K + 1 lower ends kept
constexpr int kCand = 4;                               // K candidates verified
constexpr float kTwo44 = 17592186044416.0f;            // 2^44
constexpr float kTwo48 = 281474976710656.0f;           // 2^48
constexpr float kTwo25 = 33554432.0f;                  // 2^25
constexpr float kTwoMinus20 = 9.5367431640625e-07f;    // 2^-20
constexpr float kBig = 3.0e38f;                        // zero-weight quotient

// 2^44 * log2(u + 1) in f32: the one f32 log, kept out of line so that its
// compiled body is the one D has always been measured on; the filter reads
// its values from the table
__device__ __noinline__ float ln_f32(uint32_t u) {
  return __fmul_rn(log2f(__fadd_rn((float)u, 1.0f)), kTwo44);
}

// the table for u < n (n <= 65,536) and, in *d_bits, the bit pattern of
// max |table - f32(crush_ln(u))| (the launcher zeroes it first)
__global__ void ln_f32_table_kernel(const uint64_t* __restrict__ ln_tab,
                                    float* __restrict__ out,
                                    unsigned* __restrict__ d_bits, int n) {
  __shared__ uint64_t s_tab[kLnEntries];
  __shared__ unsigned s_max[kThreads / 32];
  load_ln(s_tab, ln_tab);
  __syncthreads();
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned gap = 0u;
  if (u < n) {
    const float t = ln_f32((uint32_t)u);
    out[u] = t;
    const long long exact = (1ll << 48) - (long long)ln_p48((uint32_t)u, s_tab);
    gap = __float_as_uint(fabsf(__fsub_rn(t, __ll2float_rn(exact))));
  }
  gap = __reduce_max_sync(kFullMask, gap);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_max[warp] = gap;
  __syncthreads();
  if (warp == 0) {
    gap = lane < (int)(blockDim.x >> 5) ? s_max[lane] : 0u;
    gap = __reduce_max_sync(kFullMask, gap);
    if (lane == 0) atomicMax(d_bits, gap);
  }
}

// put (lo, pos) into the 5 least, kept sorted by (lower end, position)
__device__ __forceinline__ void keep_least(float (&c_lo)[kKeep], int (&c_pos)[kKeep],
                                           float lo, int pos) {
  if (lo < c_lo[kKeep - 1] || (lo == c_lo[kKeep - 1] && pos < c_pos[kKeep - 1])) {
    c_lo[kKeep - 1] = lo;
    c_pos[kKeep - 1] = pos;
#pragma unroll
    for (int j = kKeep - 1; j > 0; --j) {
      if (c_lo[j] < c_lo[j - 1] || (c_lo[j] == c_lo[j - 1] && c_pos[j] < c_pos[j - 1])) {
        const float tl = c_lo[j]; c_lo[j] = c_lo[j - 1]; c_lo[j - 1] = tl;
        const int tp = c_pos[j]; c_pos[j] = c_pos[j - 1]; c_pos[j - 1] = tp;
      }
    }
  }
}

// (R, N) filter columns: G = 1 << lg lanes per (x, r), see the header
__global__ void straw2_froot_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                    const int32_t* __restrict__ ids,
                                    const uint64_t* __restrict__ magic,
                                    const int32_t* __restrict__ shift,
                                    const float* __restrict__ wf, int S, int lg,
                                    float D, const uint64_t* __restrict__ ln_tab,
                                    const float* __restrict__ lnf,
                                    int32_t* __restrict__ out_pos,
                                    int32_t* __restrict__ out_id,
                                    int32_t* __restrict__ ovf) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_tab = smem;
  uint64_t* s_m = smem + kLnEntries;
  int32_t* s_s = reinterpret_cast<int32_t*>(s_m + S);
  float* s_wf = reinterpret_cast<float*>(s_s + S);
  float* s_mb = s_wf + S;                       // (D + 2^25) / w, per item
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_mb + S);
  load_ln(s_tab, ln_tab);
  const float d25 = __fadd_rn(D, kTwo25);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_m[i] = magic[i];
    s_s[i] = shift[i];
    s_wf[i] = wf[i];
    s_mb[i] = __fdiv_rn(d25, wf[i]);
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
  const int xi = valid ? (int)col - r * n : 0;
  const uint32_t x = valid ? xs[xi] : 0u;

  float min_hi = __int_as_float(0x7f800000);    // +inf
  float c_lo[kKeep];
  int c_pos[kKeep];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    c_lo[j] = __int_as_float(0x7f800000);
    c_pos[j] = kNoPos;
  }
  for (int s = valid ? lane : S; s < S; s += G) {
    float lo = kBig, hi = kBig;
    if (s_s[s] != kShiftZero) {
      const uint32_t u = hash32_3(x, (uint32_t)s_ids[s], (uint32_t)r) & 0xFFFFu;
      const float q = __fdiv_rn(__fsub_rn(kTwo48, __ldg(lnf + u)), s_wf[s]);
      const float m = __fadd_rn(__fadd_rn(s_mb[s], __fmul_rn(q, kTwoMinus20)), 4.0f);
      lo = __fsub_rn(q, m);
      hi = __fadd_rn(q, m);
    }
    min_hi = fminf(min_hi, hi);
    if (lo < c_lo[kKeep - 1]) {       // strict: an equal lower end ranks later
      c_lo[kKeep - 1] = lo;
      c_pos[kKeep - 1] = s;
#pragma unroll
      for (int j = kKeep - 1; j > 0; --j) {
        if (c_lo[j] < c_lo[j - 1]) {
          const float tl = c_lo[j]; c_lo[j] = c_lo[j - 1]; c_lo[j - 1] = tl;
          const int tp = c_pos[j]; c_pos[j] = c_pos[j - 1]; c_pos[j - 1] = tp;
        }
      }
    }
  }
  // the group's least upper end and 5 least (lower end, position) pairs
  for (int off = G >> 1; off > 0; off >>= 1) {
    min_hi = fminf(min_hi, __shfl_xor_sync(kFullMask, min_hi, off));
    float o_lo[kKeep];
    int o_pos[kKeep];
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      o_lo[j] = __shfl_xor_sync(kFullMask, c_lo[j], off);
      o_pos[j] = __shfl_xor_sync(kFullMask, c_pos[j], off);
    }
#pragma unroll
    for (int j = 0; j < kKeep; ++j) keep_least(c_lo, c_pos, o_lo[j], o_pos[j]);
  }

  // lane l verifies the candidates k = l (mod G); the group keeps the
  // first minimum by (quotient, position)
  int best = kNoPos;
  uint64_t best_q = ~0ull;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    const int p = c_pos[k];
    if ((k & (G - 1)) != lane || p >= S) continue;
    const uint64_t q = straw2_qm(x, s_ids[p], (uint32_t)r, s_m[p], s_s[p], s_tab);
    if (q < best_q || (q == best_q && p < best)) {
      best = p;
      best_q = q;
    }
  }
  merge_least(best_q, best, min(G, kCand));
  if (valid && lane == 0) {
    out_pos[col] = best;
    out_id[col] = s_ids[best];
    if (c_lo[kKeep - 1] <= min_hi) atomicOr(ovf + xi, 1);
  }
}

}  // namespace

extern "C" int ln_f32_table_launch(const void* ln_tab, void* out, void* d_bits,
                                   int n, void* stream) {
  if (n < 1 || n > 65536) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(d_bits, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  ln_f32_table_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)ln_tab, (float*)out, (unsigned*)d_bits, n);
  return (int)cudaGetLastError();
}

extern "C" int straw2_froot_launch(const void* xs, int n, int R, const void* ids,
                                   const void* magic, const void* shift,
                                   const void* wf, int S, int lg, float D,
                                   const void* ln_tab, const void* lnf,
                                   void* out_pos, void* out_id, void* ovf,
                                   void* stream) {
  const size_t smem = kLnEntries * sizeof(uint64_t) + (size_t)S * (8 + 4 + 4 + 4 + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        straw2_froot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  straw2_froot_kernel<<<blocks_for(((int64_t)n * R) << lg), kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)ids, (const uint64_t*)magic,
      (const int32_t*)shift, (const float*)wf, S, lg, D, (const uint64_t*)ln_tab,
      (const float*)lnf, (int32_t*)out_pos, (int32_t*)out_id, (int32_t*)ovf);
  return (int)cudaGetLastError();
}
