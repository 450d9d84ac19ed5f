// ab_bitplane.cu — the designs of bitplane_pack that ab_kernels.py times
// against the kernel of ceph_tpu_torch/csrc/bitplane.cu (built by
// ab_kernels.build_bitplane_variants into ceph_tpu_torch/_build/, never part
// of the package's library).  Each computes the same planes through the
// same arguments (data, out, S, W, stream):
//
//   first_bitplane_launch   the first version, as it was committed:
//                           one thread a 64-bit word over a flat grid-stride
//                           loop, the row by a 64-bit divide of the word's
//                           index, one 8-byte load and eight byte stores
//   staged_bitplane_launch  bitplane.cu's row-shaped grid with the piece
//                           staged through shared memory: 256 threads a
//                           4 KiB piece, each one 16-byte load (a warp's
//                           loads 512 contiguous bytes), its 2 bytes of
//                           each plane into the block's 8 x 512-byte planes,
//                           then each warp one plane, 16 bytes a thread
//                           (512 contiguous bytes a warp store)
//   empty_bitplane_launch   bitplane.cu's grid and blocks doing nothing:
//                           the floor of one launch
//   copy_bitplane_launch    bitplane.cu's grid and blocks, each thread
//                           copying its 16 kVec input bytes to the same
//                           offset of out with kVec 16-byte loads and
//                           stores: the bytes' floor without the transpose
//                           (its output is not the planes, and is not
//                           checked)
//
// bitplane.cu's own kernel at other kVec, cache hints or grids is built
// from its source with a few lines replaced (ab_kernels.BITPLANE_VARIANTS).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitplane.cu"

namespace first {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;   // the grid strides past this

__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

// words: S * W / 8 groups of 8 bytes; per_row: W / 8 (the plane length)
template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
first_bitplane_kernel(const uint8_t* __restrict__ data,
                      uint8_t* __restrict__ out, long long words,
                      int per_row) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < words; g += stride) {
    uint64_t x;
    if (kAligned) {
      x = __ldg(reinterpret_cast<const unsigned long long*>(data) + g);
    } else {
      x = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t)
        x |= (uint64_t)__ldg(data + 8 * g + t) << (8 * t);
    }
    const uint64_t y = transpose8(x);
    const long long row = g / per_row;
    uint8_t* o = out + row * 8 * per_row + (g - row * per_row);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[(long long)j * per_row] = (uint8_t)(y >> (8 * j));
  }
}

}  // namespace first

extern "C" int first_bitplane_launch(const void* data, void* out, int S,
                                     int W, void* stream) {
  constexpr int kThreads = first::kThreads;
  if (S < 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long words = (long long)S * (W / 8);
  if (words == 0) return (int)cudaSuccess;
  const long long need = (words + kThreads - 1) / kThreads;
  const int grid = (int)(need < first::kMaxBlocks ? need : first::kMaxBlocks);
  auto kernel = (uintptr_t)data % 8 == 0
                    ? first::first_bitplane_kernel<true>
                    : first::first_bitplane_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (uint8_t*)out, words, W / 8);
  return (int)cudaGetLastError();
}

namespace staged {

constexpr int kThreads = 256;            // 16 bytes a thread: a 4 KiB piece
constexpr int kPlane = kPiece / 8;       // a piece's bytes of one plane

__global__ void __launch_bounds__(kThreads)
staged_bitplane_kernel(const uint8_t* __restrict__ data,
                       uint8_t* __restrict__ out, int S, int W) {
  __shared__ __align__(16) uint8_t planes[8][kPlane];
  const unsigned x0 = blockIdx.x * kPiece + threadIdx.x * 16;
  const int P = W / 8;
  const int p0 = blockIdx.x * kPlane;      // the piece's first plane byte
  const int n = min(kPlane, P - p0);       // its bytes of each plane
  const int j = threadIdx.x / 32;          // the plane this warp stores
  const int b = (threadIdx.x % 32) * 16;   // this thread's 16 bytes of it
  for (long long row = blockIdx.y; row < S; row += gridDim.y) {
    const uint8_t* in = data + row * W + x0;
    uint64_t y0 = 0, y1 = 0;
    if (x0 + 16 <= (unsigned)W && (uintptr_t)in % 16 == 0) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(in));
      y0 = v.x | (uint64_t)v.y << 32;
      y1 = v.z | (uint64_t)v.w << 32;
    } else {
      if (x0 < (unsigned)W) y0 = load8(in);
      if (x0 + 8 < (unsigned)W) y1 = load8(in + 8);
    }
    uint32_t q[4];
    planes2(transpose8(y0), transpose8(y1), q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<uint16_t*>(&planes[2 * k][2 * threadIdx.x]) =
          (uint16_t)q[k];
      *reinterpret_cast<uint16_t*>(&planes[2 * k + 1][2 * threadIdx.x]) =
          (uint16_t)(q[k] >> 16);
    }
    __syncthreads();
    uint8_t* dst = out + row * W + j * P + p0 + b;
    if (b + 16 <= n && (uintptr_t)dst % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(&planes[j][b]);
    } else {
      for (int i = 0; i < 16 && b + i < n; ++i) dst[i] = planes[j][b + i];
    }
    __syncthreads();                       // the planes are rewritten next
  }
}

}  // namespace staged

extern "C" int staged_bitplane_launch(const void* data, void* out, int S,
                                      int W, void* stream) {
  if (S < 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((W + kPiece - 1LL) / kPiece),
                  (unsigned)(S < kGridRows ? S : kGridRows));
  staged::staged_bitplane_kernel<<<grid, staged::kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const uint8_t*)data, (uint8_t*)out, S, W);
  return (int)cudaGetLastError();
}

namespace floor_ {

__global__ void __launch_bounds__(kThreads)
empty_bitplane_kernel(uint8_t* __restrict__ out, int S) {
  if (S < 0) out[threadIdx.x] = 0;
}

__global__ void __launch_bounds__(kThreads)
copy_bitplane_kernel(const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int S, int W) {
  constexpr unsigned kBytes = 16 * kVec;
  const unsigned x0 = blockIdx.x * kPiece + threadIdx.x * kBytes;
  if (x0 >= (unsigned)W) return;
  for (long long row = blockIdx.y; row < S; row += gridDim.y) {
    const uint8_t* in = data + row * W + x0;
    uint8_t* o = out + row * W + x0;
    if (x0 + kBytes <= (unsigned)W &&
        ((uintptr_t)in | (uintptr_t)o) % 16 == 0) {
      uint4 v[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        v[i] = __ldg(reinterpret_cast<const uint4*>(in) + i);
#pragma unroll
      for (int i = 0; i < kVec; ++i) reinterpret_cast<uint4*>(o)[i] = v[i];
    } else {
      for (unsigned i = 0; i < kBytes && x0 + i < (unsigned)W; ++i)
        o[i] = in[i];
    }
  }
}

dim3 grid_of(int S, int W) {
  return dim3((unsigned)((W + kPiece - 1LL) / kPiece),
              (unsigned)(S < kGridRows ? S : kGridRows));
}

}  // namespace floor_

extern "C" int empty_bitplane_launch(const void* data, void* out, int S,
                                     int W, void* stream) {
  if (S <= 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid = floor_::grid_of(S, W);
  floor_::empty_bitplane_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, S);
  return (int)cudaGetLastError();
}

extern "C" int copy_bitplane_launch(const void* data, void* out, int S,
                                    int W, void* stream) {
  if (S <= 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid = floor_::grid_of(S, W);
  floor_::copy_bitplane_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (uint8_t*)out, S, W);
  return (int)cudaGetLastError();
}
