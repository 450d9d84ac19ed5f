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
// the band of every item whose lower end is at most the least upper end.  One
// pass keeps the least upper end and the 5 least (lower end, position) pairs
// in registers, by insertion; the 4 first are verified with the exact u64
// quotient (first minimum by quotient, then position, as _verify_packed keeps
// it).  If the 5th lower end is still inside the band, more than 4 items may
// hold the winner: the x's flag is raised (atomicOr into a zeroed (N,) array)
// and the caller re-runs the exact root kernel on the whole batch.  None of
// the TPU kernel's 10-bit key packing, sign-biased compares or lane shuffles
// is needed: a thread owns its (x, r) and its candidates.
//
// The certificate is only sound if D is measured with the very log2 the
// filter runs.  So both kernels call ONE function, ln_f32, which is kept out
// of line so that both use one compiled body; the library is built without
// --use_fast_math, and the band arithmetic uses the _rn intrinsics so that no
// multiply and add are fused into an FMA.  The plain torch version
// (ops/straw2_filter.py) reads its ln values from this kernel's table on the
// card, so its bands and flags equal the kernel's bit for bit.
//
// Bound on the H100: operations.  Per item: the rjenkins hash (~183 32-bit
// operations) and ~17 f32 operations of the band; per (x, r): 4 exact draws.
// The exact root kernel pays ~200 operations and a 64-bit divide per item.

#include "straw2_common.cuh"

namespace {

constexpr int kKeep = 5;                               // K + 1 lower ends kept
constexpr int kCand = 4;                               // K candidates verified
constexpr float kTwo44 = 17592186044416.0f;            // 2^44
constexpr float kTwo48 = 281474976710656.0f;           // 2^48
constexpr float kTwo25 = 33554432.0f;                  // 2^25
constexpr float kTwoMinus20 = 9.5367431640625e-07f;    // 2^-20
constexpr float kBig = 3.0e38f;                        // zero-weight quotient

// 2^44 * log2(u + 1) in f32: the one f32 log of both kernels
__device__ __noinline__ float ln_f32(uint32_t u) {
  return __fmul_rn(log2f(__fadd_rn((float)u, 1.0f)), kTwo44);
}

__global__ void ln_f32_table_kernel(float* __restrict__ out, int n) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < n) out[u] = ln_f32((uint32_t)u);
}

__global__ void straw2_froot_kernel(const uint32_t* __restrict__ xs, int n, int R,
                                    const int32_t* __restrict__ ids,
                                    const int64_t* __restrict__ w,
                                    const float* __restrict__ wf, int S, float D,
                                    const uint64_t* __restrict__ ln_tab,
                                    int32_t* __restrict__ out_pos,
                                    int32_t* __restrict__ out_id,
                                    int32_t* __restrict__ ovf) {
  extern __shared__ uint64_t smem[];
  uint64_t* s_tab = smem;
  int64_t* s_w = reinterpret_cast<int64_t*>(smem + kLnEntries);
  float* s_wf = reinterpret_cast<float*>(s_w + S);
  float* s_mb = s_wf + S;                       // (D + 2^25) / w, per item
  int32_t* s_ids = reinterpret_cast<int32_t*>(s_mb + S);
  load_ln(s_tab, ln_tab);
  const float d25 = __fadd_rn(D, kTwo25);
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_w[i] = w[i];
    s_wf[i] = wf[i];
    s_mb[i] = __fdiv_rn(d25, wf[i]);
    s_ids[i] = ids[i];
  }
  __syncthreads();
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)n * R) return;
  const int r = (int)(tid / n);
  const int xi = (int)(tid - (int64_t)r * n);
  const uint32_t x = xs[xi];

  float min_hi = __int_as_float(0x7f800000);    // +inf
  float c_lo[kKeep];
  int c_pos[kKeep];
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    c_lo[j] = __int_as_float(0x7f800000);
    c_pos[j] = 0x7FFFFFFF;
  }
  for (int s = 0; s < S; ++s) {
    float lo = kBig, hi = kBig;
    if (s_w[s] > 0) {
      const uint32_t u = hash32_3(x, (uint32_t)s_ids[s], (uint32_t)r) & 0xFFFFu;
      const float q = __fdiv_rn(__fsub_rn(kTwo48, ln_f32(u)), s_wf[s]);
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

  int best = -1;
  uint64_t best_q = 0;
#pragma unroll
  for (int k = 0; k < kCand; ++k) {
    const int p = c_pos[k];
    if (p >= S) continue;
    const uint64_t q = straw2_q(x, s_ids[p], (uint32_t)r, s_w[p], s_tab);
    if (best < 0 || q < best_q || (q == best_q && p < best)) {
      best = p;
      best_q = q;
    }
  }
  out_pos[tid] = best;
  out_id[tid] = s_ids[best];
  if (c_lo[kKeep - 1] <= min_hi) atomicOr(ovf + xi, 1);
}

}  // namespace

extern "C" int ln_f32_table_launch(void* out, int n, void* stream) {
  ln_f32_table_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int straw2_froot_launch(const void* xs, int n, int R, const void* ids,
                                   const void* w, const void* wf, int S, float D,
                                   const void* ln_tab, void* out_pos, void* out_id,
                                   void* ovf, void* stream) {
  const size_t smem = kLnEntries * sizeof(uint64_t) + (size_t)S * (8 + 4 + 4 + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        straw2_froot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  straw2_froot_kernel<<<blocks_for((int64_t)n * R), kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)xs, n, R, (const int32_t*)ids, (const int64_t*)w,
      (const float*)wf, S, D, (const uint64_t*)ln_tab, (int32_t*)out_pos,
      (int32_t*)out_id, (int32_t*)ovf);
  return (int)cudaGetLastError();
}
