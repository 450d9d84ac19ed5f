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
// Bound on the H100: memory.  The kernel reads each input byte once and
// writes each plane byte once, 2 S W bytes: (1,024, 4,096), a BlueStore
// write of 4 MiB, is 8 MiB in all, 0.0025 ms at 3.35 TB/s.  The transpose
// is about 18 integer operations a word, far under the byte bound.
//
// The transpose.  8 consecutive bytes of a row, read as one 64-bit word
// whose byte t is input byte t, are an 8 x 8 bit matrix (row t = byte t,
// column j = bit j, bit 8t + j of the word); the planes are its transpose:
// byte j of the result holds bit j of the 8 bytes, byte t's bit at bit t.
// Three masked delta swaps transpose it (Hacker's Delight, 7-3: the 2 x 2
// blocks, then the 4 x 4 blocks of 2 x 2, then the two 4 x 4 halves).
//
// Design.  The grid is shaped like the batch: block (x, y) takes the 4 KiB
// piece x of row y (4 KiB is one BlueStore block), and a block loops over
// the rows past the grid's 65,535 in y.  A row's base is one 64-bit
// multiply a row; every index inside a row is 32-bit, and nothing divides.
// Each of the block's kThreads threads takes 16 kVec consecutive bytes of
// the piece with kVec 16-byte loads, transposes its 2 kVec words,
// gathers byte j of each word into one 2 kVec-byte value with byte
// permutes (PRMT) and stores it into plane j: with kVec = 2, 32 bytes in,
// eight 4-byte stores out, so each of a warp's plane stores writes 128
// contiguous bytes, a whole line.  A (1,024, 4,096) call is 1,024 blocks of
// 128 threads, under one wave of the card's 132 SMs with all 4 MiB of loads
// in flight at once; a (256, 4,096) batch still gives every SM blocks.  The
// ragged edges, in the kernel: a row whose bytes lie off 16-byte alignment
// (W not a multiple of 16, or a data pointer off it) loads the aligned
// chunks around them and shifts them into place in registers; the row's
// last thread, when the row ends inside its 16 kVec bytes, loads its words
// by 8 bytes where aligned, else by bytes; plane stores off their 2 kVec-
// byte alignment (W not a multiple of 16 kVec, or the output pointer off
// it) and that last thread's store bytes.
//
// The design it replaces, the first version: one thread a 64-bit word over
// a flat grid-stride loop, the row found by a 64-bit divide of the word's
// index by W / 8 (a call to the division routine, tens of instructions a
// word), one 8-byte load and eight 1-byte stores a thread (32 bytes a warp
// store), two waves of 256-thread blocks at (1,024, 4,096); unaligned data
// read a byte at a time.
//
// What the A/B measured (`ab_kernels.py --kernels bitplane_pack`, H100
// 80GB HBM3 at 700 W, graph replay; PERF.md holds the table).  Warm at (1,024,
// 4,096) this kernel takes 0.0032-0.0036 ms against the first version's
// 0.0040-0.0042.  Cold it takes 0.0051-0.0054 ms, and so do the first
// version, kVec = 1 and 4, the shared-memory design and cache hints, within
// the runs' spread: a kernel of the same grid that only copies the bytes
// takes 0.0052-0.0055 and torch's copy_ of them 0.0052-0.0054, of which
// 0.0017-0.0020 is one launch of empty blocks.  Cold, the bytes and the
// launch set the pace, not the instructions; behind a queued kernel, so
// that the host's submission of the replay does not show, 0.0049 ms, half
// the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 2;                      // 16-byte loads a thread
constexpr int kPiece = 4096;                 // bytes of a row a block takes
constexpr int kThreads = kPiece / (16 * kVec);
constexpr int kGridRows = 65535;             // grid.y; blocks loop past it

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

// transposed words a, b -> q[k]: plane 2k's bytes of a, b in its low half,
// plane 2k + 1's in its high half (byte order a, b)
__device__ __forceinline__ void planes2(uint64_t a, uint64_t b,
                                        uint32_t (&q)[4]) {
  const uint32_t al = (uint32_t)a, ah = (uint32_t)(a >> 32);
  const uint32_t bl = (uint32_t)b, bh = (uint32_t)(b >> 32);
  q[0] = __byte_perm(al, bl, 0x5140);
  q[1] = __byte_perm(al, bl, 0x7362);
  q[2] = __byte_perm(ah, bh, 0x5140);
  q[3] = __byte_perm(ah, bh, 0x7362);
}

// transposed words y[0..3] -> p[j]: plane j's bytes of y[0], ..., y[3]
__device__ __forceinline__ void planes4(const uint64_t* y, uint32_t (&p)[8]) {
  uint32_t q[4], r[4];
  planes2(y[0], y[1], q);
  planes2(y[2], y[3], r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p[2 * k] = __byte_perm(q[k], r[k], 0x5410);
    p[2 * k + 1] = __byte_perm(q[k], r[k], 0x7632);
  }
}

// 8 bytes at p, in one load where p is 8-byte aligned
__device__ __forceinline__ uint64_t load8(const uint8_t* p) {
  if ((uintptr_t)p % 8 == 0)
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  uint64_t x = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) x |= (uint64_t)__ldg(p + t) << (8 * t);
  return x;
}

// A thread's 16 V bytes at in, inside the row -> its 2 V words.  Aligned:
// V 16-byte loads.  Off alignment by d bytes: the V + 1 aligned 16-byte
// chunks that hold them (each holds one of the row's bytes, so no load
// leaves the row's pages), shifted down by d in registers.  d is the same
// for every thread of a row
template <int V>
__device__ __forceinline__ void load_whole(const uint8_t* in,
                                           uint64_t (&x)[2 * V]) {
  const unsigned d = (uintptr_t)in % 16;
  if (d == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + i);
      x[2 * i] = v.x | (uint64_t)v.y << 32;
      x[2 * i + 1] = v.z | (uint64_t)v.w << 32;
    }
    return;
  }
  const uint4* c = reinterpret_cast<const uint4*>(in - d);
  uint32_t r[4 * V + 4];
#pragma unroll
  for (int i = 0; i <= V; ++i) {
    const uint4 v = __ldg(c + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
  if (d & 8) {
#pragma unroll
    for (int k = 0; k < 4 * V + 2; ++k) r[k] = r[k + 2];
  }
  if (d & 4) {
#pragma unroll
    for (int k = 0; k < 4 * V + 1; ++k) r[k] = r[k + 1];
  }
#pragma unroll
  for (int k = 0; k < 4 * V; ++k)
    r[k] = __funnelshift_r(r[k], r[k + 1], 8 * (d & 3));
#pragma unroll
  for (int w = 0; w < 2 * V; ++w)
    x[w] = r[2 * w] | (uint64_t)r[2 * w + 1] << 32;
}

// The row's last thread, whose `words` (< 2 V) words end the row: each by
// 8 bytes where aligned, else by bytes, all before the first store
template <int V>
__device__ __forceinline__ void load_edge(const uint8_t* in, int words,
                                          uint64_t (&x)[2 * V]) {
#pragma unroll
  for (int w = 0; w < 2 * V; ++w) x[w] = w < words ? load8(in + 8 * w) : 0;
}

// Transposed words y -> 2 V bytes of each plane at o + j P, 2 V-byte aligned
template <int V>
__device__ __forceinline__ void store_whole(const uint64_t (&y)[2 * V],
                                            uint8_t* o, int P) {
  if constexpr (V == 1) {
    uint32_t q[4];
    planes2(y[0], y[1], q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<uint16_t*>(o + 2 * k * P) = (uint16_t)q[k];
      *reinterpret_cast<uint16_t*>(o + (2 * k + 1) * P) =
          (uint16_t)(q[k] >> 16);
    }
  } else if constexpr (V == 2) {
    uint32_t p[8];
    planes4(y, p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(o + j * P) = p[j];
  } else {
    static_assert(V == 4, "kVec is 1, 2 or 4");
    uint32_t lo[8], hi[8];
    planes4(y, lo);
    planes4(y + 4, hi);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<unsigned long long*>(o + j * P) =
          lo[j] | (unsigned long long)hi[j] << 32;
  }
}

// The same by bytes, for `words` words: planes off alignment (P not a
// multiple of 2 V, or the output pointer off it) or the row's last thread
template <int V>
__device__ __forceinline__ void store_bytes(const uint64_t (&y)[2 * V],
                                            uint8_t* o, int P, int words) {
#pragma unroll
  for (int w = 0; w < 2 * V; ++w) {
    if (w >= words) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j * P + w] = (uint8_t)(y[w] >> (8 * j));
  }
}

template <int V>
__global__ void __launch_bounds__(kPiece / (16 * V))
bitplane_pack_kernel(const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, int S, int W) {
  const unsigned x0 = blockIdx.x * kPiece + threadIdx.x * (16 * V);
  if (x0 >= (unsigned)W) return;
  const int P = W / 8;                       // a shift: W is positive
  const int b0 = (int)(x0 / 8);              // the thread's first plane byte
  const int words = min(2 * V, P - b0);
  for (long long row = blockIdx.y; row < S; row += gridDim.y) {
    const uint8_t* in = data + row * W + x0;
    uint8_t* o = out + row * W + b0;         // plane 0; plane j at o + j P
    uint64_t y[2 * V];
    if (words == 2 * V)
      load_whole<V>(in, y);
    else
      load_edge<V>(in, words, y);
#pragma unroll
    for (int w = 0; w < 2 * V; ++w) y[w] = transpose8(y[w]);
    if (words == 2 * V && P % (2 * V) == 0 && (uintptr_t)o % (2 * V) == 0)
      store_whole<V>(y, o, P);
    else
      store_bytes<V>(y, o, P, words);
  }
}

}  // namespace

// data (S, W) uint8, W a positive multiple of 8; out (S, 8, W / 8) uint8.
// Any pointers: the kernel masks the ragged and unaligned edges itself.
// Returns cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int bitplane_pack_launch(const void* data, void* out, int S, int W,
                                    void* stream) {
  if (S < 0 || W <= 0 || W % 8 != 0) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((W + kPiece - 1LL) / kPiece),
                  (unsigned)(S < kGridRows ? S : kGridRows));
  auto kernel = bitplane_pack_kernel<kVec>;
  cudaStream_t st = (cudaStream_t)stream;
  kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (uint8_t*)out, S,
                                    W);
  return (int)cudaGetLastError();
}
