// GF(2^8) matrix times stripe columns: out[s, i, b] = XOR_j M_p[i][j] * data[s, j, b]
// with p = pidx[s], the per-stripe pattern of a stacked (P, t, k) matrix table.
//
// Replaces the TPU's ceph_tpu/ops/gf_kernel.py::_pallas_kernel (erasure encode,
// launched by _encode_pallas) AND the XLA heterogeneous decode _decode_xla: encode
// is P = 1 with every index 0, recovery is a recovery matrix, and a batch mixing
// erasure patterns is one launch.
//
// Design.  GF(2^8) multiplication by a constant is a 256-entry lookup, and four
// products fit one 32-bit word.  The operand is the pattern's packed-product
// table (ops/gf_kernel.pack_rows): for each pass q of up to 4 outputs and each
// input j, tab[p][q][j][x] holds M_p[4q + ii][j] * x in byte ii, so one 32-bit
// shared-memory lookup yields the products of one data byte for four outputs
// ((t+3)/4 * k KiB a pattern: 8 KiB at k=8, t=4).  One thread owns 16
// consecutive byte columns of one stripe: it issues the 16-byte loads of all k
// inputs first (the kernel is a template on k = 8, so they are registers;
// other k run the same loop with k at run time), XORs the k lookups of each
// column into one word whose 4 bytes are the pass's 4 outputs, transposes the
// 16 words 4 x 4 bytes at a time with __byte_perm and writes one 16-byte store
// per output row.  A block walks a strided set of stripes and reloads the
// table only when the pattern changes, so an encode loads it once per block.
// Ragged or unaligned columns take a byte at a time through the same table.
// The TPU kernel's G=4 block-diagonal bit-matrix packing existed only to fill
// the MXU's output lanes and has no counterpart here.
//
// Bound on the H100: memory.  The bench encode (2048 stripes, k=8, m=4, 4 KiB
// chunks) must read 64 MiB and write 32 MiB (0.030 ms at 3.35 TB/s).  On top
// of that come its 67 M lookups, about five instructions each (byte extract,
// address, XOR; tools/sass_report counts them), and the shared-memory bank
// conflicts of random bytes; one byte lookup per (output, byte) took four
// times as many.  A split-nibble table (two conflict-free lookups a byte)
// and a k loop at run time for k = 8 were both slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;            // byte columns per thread
constexpr int kPack = 4;            // outputs per packed word, one byte each
constexpr int kGridStripes = 1024;  // at most this many blocks along the stripes
constexpr int kTabWords = 256;      // one packed table: a word per byte value

// a[c] holds column c's four outputs (byte ii = output ii); row[ii] gets
// output ii of the four columns (byte c = column c)
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t* row) {
  const uint32_t lo01 = __byte_perm(a[0], a[1], 0x5140);   // a0.0 a1.0 a0.1 a1.1
  const uint32_t hi01 = __byte_perm(a[0], a[1], 0x7362);   // a0.2 a1.2 a0.3 a1.3
  const uint32_t lo23 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t hi23 = __byte_perm(a[2], a[3], 0x7362);
  row[0] = __byte_perm(lo01, lo23, 0x5410);
  row[1] = __byte_perm(lo01, lo23, 0x7632);
  row[2] = __byte_perm(hi01, hi23, 0x5410);
  row[3] = __byte_perm(hi01, hi23, 0x7632);
}

// acc[c] ^= tb[byte c of the 16 bytes v], for one input's table tb
__device__ __forceinline__ void lookup16(uint32_t* acc, const uint4 v,
                                         const uint32_t* tb) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * q + b] ^= tb[(w[q] >> (8 * b)) & 0xFFu];
}

// the first n (<= 4) output rows of one pass over 16 columns
__device__ __forceinline__ void store16(const uint32_t* acc, uint8_t* o, int B,
                                        int n) {
  uint32_t rows[4][kPack];
#pragma unroll
  for (int g = 0; g < 4; ++g) transpose4(acc + 4 * g, rows[g]);
#pragma unroll
  for (int ii = 0; ii < kPack; ++ii)
    if (ii < n)
      *reinterpret_cast<uint4*>(o + (size_t)ii * B) =
          make_uint4(rows[0][ii], rows[1][ii], rows[2][ii], rows[3][ii]);
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// KT = k at compile time (its k loads issued together), or 0: k at run time.
// At most 64 registers, so four blocks share an SM: more loads in flight
// than at the 97 registers ptxas takes unbounded (measured 5-10% faster)
template <int KT>
__global__ void __launch_bounds__(kThreads, 4)
gf_matvec_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ tab,
                 const int32_t* __restrict__ pidx, uint8_t* __restrict__ out,
                 int S, int k_run, int t, int B, int vec) {
  extern __shared__ __align__(16) uint32_t s_tab[];
  const int k = KT > 0 ? KT : k_run;
  const int nq = (t + kPack - 1) / kPack;
  const int words = nq * k * kTabWords;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  int loaded = -1;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int p = pidx[s];             // uniform across the block
    if (p != loaded) {
      __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(tab + (size_t)p * words);
      uint4* dst = reinterpret_cast<uint4*>(s_tab);
      for (int o = threadIdx.x; o < words / 4; o += blockDim.x) dst[o] = src[o];
      __syncthreads();
      loaded = p;
    }
    if (col >= B) continue;            // no return: later stripes sync
    const uint8_t* d = data + (size_t)s * k * B + col;
    uint8_t* o = out + (size_t)s * t * B + col;
    if (vec) {                         // B % 16 == 0: all 16 columns exist
      if constexpr (KT > 0) {
        uint4 v[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) v[j] = load16(d + (size_t)j * B);
        for (int q = 0; q < nq; ++q) {
          uint32_t acc[kVec] = {};
#pragma unroll
          for (int j = 0; j < KT; ++j)
            lookup16(acc, v[j], s_tab + (q * KT + j) * kTabWords);
          store16(acc, o + (size_t)q * kPack * B, B, min(kPack, t - q * kPack));
        }
      } else {
        for (int q = 0; q < nq; ++q) {
          uint32_t acc[kVec] = {};
          for (int j = 0; j < k; ++j)
            lookup16(acc, load16(d + (size_t)j * B), s_tab + (q * k + j) * kTabWords);
          store16(acc, o + (size_t)q * kPack * B, B, min(kPack, t - q * kPack));
        }
      }
    } else {
      // ragged or unaligned columns: one byte at a time, same table
      const int nb = min(kVec, B - col);
      for (int q = 0; q < nq; ++q) {
        const int n = min(kPack, t - q * kPack);
        for (int b = 0; b < nb; ++b) {
          uint32_t a = 0;
          for (int j = 0; j < k; ++j)
            a ^= s_tab[(q * k + j) * kTabWords + d[(size_t)j * B + b]];
          for (int ii = 0; ii < n; ++ii)
            o[(size_t)(q * kPack + ii) * B + b] = (uint8_t)(a >> (8 * ii));
        }
      }
    }
  }
}

}  // namespace

extern "C" int gf_matvec_launch(const void* data, const void* tab, const void* pidx,
                                void* out, int S, int k, int t, int B, void* stream) {
  const int smem = (t + kPack - 1) / kPack * k * kTabWords * 4;
  const int vec = B % kVec == 0 && (uintptr_t)data % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  auto kernel = k == 8 ? gf_matvec_kernel<8> : gf_matvec_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_block = kThreads * kVec;
  dim3 grid((B + cols_per_block - 1) / cols_per_block,
            S < kGridStripes ? S : kGridStripes);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint32_t*)tab, (const int32_t*)pidx,
      (uint8_t*)out, S, k, t, B, vec);
  return (int)cudaGetLastError();
}
