// Bit-plane transpose of byte rows, the tpu_bitplane compressor's pack:
// out[s, j, b] = sum over t < 8 of ((data[s, 8b + t] >> j) & 1) << t, for an
// (S, W) uint8 batch with W % 8 == 0 and an (S, 8, W/8) uint8 output.  Plane
// j packs bit j of every byte of the row, least significant bit first.
//
// Replaces the XLA function ceph_tpu/ops/compression_kernel.py::_jit_planes
// (reached through bitplane_planes_batched and pack_planes), which had no
// Pallas kernel: its expression makes a byte a bit, then 16-bit products,
// and moves about 25 times its input through memory.
//
// Design.  One thread takes 8 consecutive bytes of a row as one 64-bit word,
// whose byte t is input byte t.  Read as an 8 x 8 bit matrix (row t = byte
// t, column j = bit j, bit 8t + j of the word), the planes are its
// transpose: byte j of the result holds bit j of the 8 bytes, byte t's bit
// at bit t.  Three masked delta swaps transpose it (Hacker's Delight, 7-3:
// the 2 x 2 blocks, then the 4 x 4 blocks of 2 x 2, then the two 4 x 4
// halves), and the thread stores byte j into plane j.  Neighbouring threads
// take neighbouring words of a row, so each of a warp's 8 plane stores
// writes 32 neighbouring bytes.  A data pointer that is not 8-byte aligned
// reads its bytes one at a time through the same transpose.  The grid
// strides over the words when the batch has more than a grid's worth.
//
// Bound on the H100: memory.  The kernel reads each input byte once and
// writes each plane byte once, 2 S W bytes: (1,024, 4,096), a BlueStore
// write of 4 MiB, is 8 MiB in all, 0.0025 ms at 3.35 TB/s.  The transpose
// is about 18 integer operations a word, far under the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;   // the grid strides past this

// byte t of x = input byte t  ->  byte j of the result = plane j's byte
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
bitplane_pack_kernel(const uint8_t* __restrict__ data,
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

}  // namespace

// data (S, W) uint8, W a positive multiple of 8; out (S, 8, W / 8) uint8.
// Returns cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int bitplane_pack_launch(const void* data, void* out, int S, int W,
                                    void* stream) {
  if (S < 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long words = (long long)S * (W / 8);
  if (words == 0) return (int)cudaSuccess;
  const long long need = (words + kThreads - 1) / kThreads;
  const int grid = (int)(need < kMaxBlocks ? need : kMaxBlocks);
  auto kernel = (uintptr_t)data % 8 == 0 ? bitplane_pack_kernel<true>
                                         : bitplane_pack_kernel<false>;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (uint8_t*)out,
                                    words, W / 8);
  return (int)cudaGetLastError();
}
