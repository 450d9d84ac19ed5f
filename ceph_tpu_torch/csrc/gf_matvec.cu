// GF(2^8) matrix times stripe columns: out[s, i, b] = XOR_j M_p[i][j] * data[s, j, b]
// with p = pidx[s], the per-stripe pattern of a stacked (P, t, k) matrix table.
//
// Replaces the TPU's ceph_tpu/ops/gf_kernel.py::_pallas_kernel (erasure encode,
// launched by _encode_pallas) AND the XLA heterogeneous decode _decode_xla: encode
// is P = 1 with every index 0, recovery is a recovery matrix, and a batch mixing
// erasure patterns is one launch.
//
// Design.  GF(2^8) multiplication by a constant c is a 256-entry lookup, so the
// operand is the pattern's multiply rows rows[p][i][j][x] = M_p[i][j] * x
// (t*k*256 bytes: 8 KiB at k=8, t=4), held in shared memory.  One thread owns 16
// consecutive byte columns of one stripe: it loads 16 bytes of each of the k data
// chunks (one 16-byte load each, neighbouring threads on neighbouring addresses),
// looks every byte up in the row of each output, and XORs.  A block walks a
// strided set of stripes and reloads the rows only when the pattern changes, so
// an encode loads them once per block.  The TPU kernel's G=4 block-diagonal
// bit-matrix packing existed only to fill the MXU's output lanes and has no
// counterpart here.
//
// Bound on the H100: memory.  The bench encode (2048 stripes, k=8, m=4, 4 KiB
// chunks) must read 64 MiB and write 32 MiB; the k*t shared-memory lookups per
// byte column are the cost that keeps it above that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;            // byte columns per thread
constexpr int kOutsPerPass = 4;     // output rows accumulated in registers

__global__ void gf_matvec_kernel(const uint8_t* __restrict__ data,
                                 const uint8_t* __restrict__ rows,
                                 const int32_t* __restrict__ pidx,
                                 uint8_t* __restrict__ out,
                                 int S, int k, int t, int B, int vec) {
  extern __shared__ __align__(16) uint8_t tab[];
  const int tab_bytes = t * k * 256;
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  int loaded = -1;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int p = pidx[s];             // uniform across the block
    if (p != loaded) {
      __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(rows + (size_t)p * tab_bytes);
      uint4* dst = reinterpret_cast<uint4*>(tab);
      for (int o = threadIdx.x; o < tab_bytes / 16; o += blockDim.x) dst[o] = src[o];
      __syncthreads();
      loaded = p;
    }
    if (col >= B) continue;            // no return: later stripes sync
    const uint8_t* d = data + (size_t)s * k * B + col;
    uint8_t* o = out + (size_t)s * t * B + col;
    if (vec && col + kVec <= B) {
      for (int i0 = 0; i0 < t; i0 += kOutsPerPass) {
        const int ni = min(kOutsPerPass, t - i0);
        uint32_t acc[kOutsPerPass][4];
#pragma unroll
        for (int ii = 0; ii < kOutsPerPass; ++ii)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[ii][q] = 0u;
        for (int j = 0; j < k; ++j) {
          const uint4 v = *reinterpret_cast<const uint4*>(d + (size_t)j * B);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int ii = 0; ii < kOutsPerPass; ++ii) {
            if (ii < ni) {
              const uint8_t* tb = tab + ((i0 + ii) * k + j) * 256;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                uint32_t a = acc[ii][q];
#pragma unroll
                for (int b = 0; b < 4; ++b)
                  a ^= (uint32_t)tb[(w[q] >> (8 * b)) & 0xFFu] << (8 * b);
                acc[ii][q] = a;
              }
            }
          }
        }
#pragma unroll
        for (int ii = 0; ii < kOutsPerPass; ++ii)
          if (ii < ni)
            *reinterpret_cast<uint4*>(o + (size_t)(i0 + ii) * B) =
                make_uint4(acc[ii][0], acc[ii][1], acc[ii][2], acc[ii][3]);
      }
    } else {
      // ragged or unaligned columns: one byte at a time
      const int nb = min(kVec, B - col);
      for (int i = 0; i < t; ++i)
        for (int b = 0; b < nb; ++b) {
          uint8_t a = 0;
          for (int j = 0; j < k; ++j) a ^= tab[(i * k + j) * 256 + d[(size_t)j * B + b]];
          o[(size_t)i * B + b] = a;
        }
    }
  }
}

}  // namespace

extern "C" int gf_matvec_launch(const void* data, const void* rows, const void* pidx,
                                void* out, int S, int k, int t, int B, int vec,
                                void* stream) {
  const int smem = t * k * 256;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_block = kThreads * kVec;
  dim3 grid((B + cols_per_block - 1) / cols_per_block, S < 1024 ? S : 1024);
  gf_matvec_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const uint8_t*)rows, (const int32_t*)pidx,
      (uint8_t*)out, S, k, t, B, vec);
  return (int)cudaGetLastError();
}
