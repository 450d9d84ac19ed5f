"""The bit-plane pack's CUDA source, built for the host and held against its
plain version on the CPU.

`bitplane_pack` (ceph_tpu_torch/csrc/bitplane.cu) runs only on the card, but
each of its threads works alone: it loads 16 kVec bytes of a row (realigned
in registers off 16-byte alignment), transposes each 8 x 8 bit matrix with
three delta swaps, gathers each plane's bytes with byte permutes and stores
them into the 8 planes, or takes its words one at a time at a row's ragged
end.  No shared memory, barrier or shuffle.  So this test compiles the
whole source with the host C++ compiler behind a small header that defines
the CUDA names it uses as host code (``__byte_perm`` and
``__funnelshift_r`` as PRMT and SHF compute them), rewrites the launcher's
``<<<grid, block, smem, st>>>`` launch to a host loop that calls the kernel
once per (block y, block x, thread), and compares the planes with
`bitplane_planes_plain` and the numpy oracle `bitplane_planes_ref` at ragged
S and W (W = 8, 24, 40 and 4,104: not multiples of 16 or 32), at W =
65,536, past the grid's 65,535 rows (the row loop), and on data and plane
pointers off 16-byte alignment.  The same cases run on the source with
kVec = 1 and 4, the variants `ab_kernels.py` times.  The tolerance is exact
equality: the transpose is a permutation of bits.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ops import compression_kernel as bk

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "ceph_tpu_torch",
                    "csrc")
#: bitplane.cu's 16-byte loads a thread, as the source sets it
KVEC = "constexpr int kVec = 2;"

#: the CUDA names bitplane.cu uses, as host code; a launch runs its blocks
#: and their threads one after another
SHIM = r"""
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
struct uint4 { uint32_t x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
// SHF.R: the low word of the pair hi:lo shifted right by s & 31
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((uint64_t)hi << 32 | lo) >> (s & 31));
}
// PRMT: byte n of the result is byte (s >> 4n) & 7 of the pair y:x
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = x | (uint64_t)y << 32;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
}
inline long long host_grid_x = 0, host_grid_y = 0;
template <class K, class... A>
void host_launch(dim3 grid, int block, size_t, K kernel, A... args) {
  gridDim = grid;
  blockDim = dim3(block);
  host_grid_x = grid.x;
  host_grid_y = grid.y;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (int t = 0; t < block; ++t) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(t);
        kernel(args...);
      }
}
extern "C" long long host_last_grid_x() { return host_grid_x; }
extern "C" long long host_last_grid_y() { return host_grid_y; }
"""


def _build(out, kvec: int | None = None) -> ctypes.CDLL:
    """bitplane.cu (at ``kvec`` 16-byte loads a thread, else as it is)
    compiled for the host into ``out``, its launcher through ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    with open(os.path.join(CSRC, "bitplane.cu")) as f:
        src = f.read()
    assert src.count(KVEC) == 1, "bitplane.cu sets kVec once"
    if kvec is not None:
        src = src.replace(KVEC, f"constexpr int kVec = {kvec};")
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), st>>>\(",
                     r"host_launch(\2, \3, \4, \1, ", src)
    assert n == 1, "the launch of bitplane.cu rewritten"
    (out / "cuda_shim.h").write_text(SHIM)
    (out / "bitplane_host.cpp").write_text(src)
    so = out / "libbitplane_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-w", "-shared", "-fPIC",
                    "-o", str(so), str(out / "bitplane_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bitplane_pack_launch.argtypes = [P, P, I, I, P]
    lib.bitplane_pack_launch.restype = I
    lib.host_last_grid_x.restype = ctypes.c_longlong
    lib.host_last_grid_y.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def host_pack(tmp_path_factory):
    """bitplane.cu compiled for the host, its launcher through ctypes."""
    return _build(tmp_path_factory.mktemp("bitplane_host"))


@pytest.fixture(scope="module", params=[1, 4], ids=lambda v: f"kVec{v}")
def host_pack_vec(request, tmp_path_factory):
    """bitplane.cu at the A/B's other kVec, compiled for the host."""
    return _build(tmp_path_factory.mktemp(f"bitplane_host_{request.param}"),
                  request.param)


def _buffer(n: int, offset: int) -> np.ndarray:
    """n zero bytes starting ``offset`` bytes past a 16-byte boundary."""
    buf = np.zeros(n + offset + 32, np.uint8)
    start = (offset - buf.ctypes.data) % 16
    view = buf[start:start + n]
    assert view.ctypes.data % 16 == offset
    return view


def _rows(seed: int, s: int, w: int, offset: int = 0) -> np.ndarray:
    """(s, w) uint8 rows of mixed content (random, 7-bit, small integers,
    zeros), starting ``offset`` bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    rows = _buffer(s * w, offset).reshape(s, w)
    top = rng.choice([256, 128, 8, 1], size=(s, 1))
    rows[:] = (rng.integers(0, 256, (s, w)) % top).astype(np.uint8)
    return rows


def _pack(lib, rows: np.ndarray, out_offset: int = 0) -> np.ndarray:
    s, w = rows.shape
    out = _buffer(s * w, out_offset).reshape(s, 8, w // 8)
    out[:] = 0xA5
    assert lib.bitplane_pack_launch(rows.ctypes.data, out.ctypes.data, s, w,
                                    None) == 0
    return out


def _check(got: np.ndarray, rows: np.ndarray) -> None:
    plain = bk.bitplane_planes_plain(torch.from_numpy(rows.copy())).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, bk.bitplane_planes_ref(rows))


#: (S, W): W = 8, 24, 40 (not multiples of 16: every word an edge word),
#: 4,104 and 4,112 (a piece's tail; not multiples of 32), 4,128 (a whole
#: last thread in a second piece), BlueStore's 1,024 blocks of 4 KiB, W =
#: 65,528 and 65,536 (pack_planes' widest), odd S
SHAPES = [(1, 8), (5, 8), (3, 24), (2, 24), (9, 40), (37, 4096), (7, 4104),
          (33, 4104), (2, 4112), (1, 4128), (1024, 4096), (3, 65536),
          (17, 65536), (3, 65528)]


@pytest.mark.parametrize("s,w", SHAPES)
def test_pack_source_matches_plain(host_pack, s, w):
    """Ragged S and W, W = 8 (one word a row), BlueStore's 1,024 blocks of
    4 KiB and the widest rows: the kernel's planes == the plain version and
    the oracle."""
    rows = _rows(s * 31 + w, s, w)
    assert rows.ctypes.data % 16 == 0
    _check(_pack(host_pack, rows), rows)


@pytest.mark.parametrize("s,w", [(1, 8), (37, 4096), (9, 136)])
def test_pack_source_unaligned_pointer(host_pack, s, w):
    """A data pointer one byte off takes the realigned loads (and at W =
    8 the byte loads of a row's last word), with the same planes."""
    rows = _rows(s + w, s, w, offset=1)
    assert rows.ctypes.data % 16 == 1
    _check(_pack(host_pack, rows), rows)


@pytest.mark.parametrize("offset", [1, 4, 8, 12, 15])
@pytest.mark.parametrize("s,w", [(3, 4104), (2, 65536), (5, 40), (3, 4096)])
def test_pack_source_unaligned_offsets(host_pack, s, w, offset):
    """A data pointer 1, 4, 8, 12 or 15 bytes past a 16-byte boundary (every
    shift of the realigned loads: bytes, a word, two words) with the same
    planes, at ragged and the widest rows; at W = 4,104 the rows' offsets
    alternate."""
    rows = _rows(s + w + offset, s, w, offset=offset)
    assert rows.ctypes.data % 16 == offset
    _check(_pack(host_pack, rows), rows)


@pytest.mark.parametrize("out_offset", [1, 2, 8])
def test_pack_source_unaligned_planes(host_pack, out_offset):
    """Plane stores off their alignment (an output pointer 1, 2 or 8 bytes
    past a 16-byte boundary) take the byte stores."""
    rows = _rows(out_offset, 5, 4096)
    _check(_pack(host_pack, rows, out_offset), rows)


def test_pack_source_grid_stride(host_pack):
    """More rows than the grid's 65,535 in y: the grid caps there and each
    block loops over the rest of the rows, edge words (W = 24) and whole
    ones (W = 32)."""
    s = 65535 + 5
    for w in (24, 32):
        rows = _rows(7 + w, s, w)
        _check(_pack(host_pack, rows), rows)
        assert host_pack.host_last_grid_y() == 65535
        assert host_pack.host_last_grid_x() == 1


def test_pack_source_grid_pieces(host_pack):
    """A row wider than a block's 4 KiB piece spreads over blocks in x."""
    rows = _rows(3, 2, 65536)
    _check(_pack(host_pack, rows), rows)
    assert host_pack.host_last_grid_x() == 16
    assert host_pack.host_last_grid_y() == 2


@pytest.mark.parametrize("s,w,offset", [(5, 8, 0), (9, 40, 0), (37, 4096, 0),
                                        (7, 4104, 0), (3, 65536, 0),
                                        (37, 4096, 4), (3, 4104, 1)])
def test_pack_source_other_widths(host_pack_vec, s, w, offset):
    """The source at kVec = 1 (2-byte plane stores) and 4 (8-byte), as the
    A/B builds it: the same planes on ragged widths and pointers."""
    rows = _rows(s * 7 + w + offset, s, w, offset=offset)
    _check(_pack(host_pack_vec, rows), rows)


def test_pack_source_bit_order(host_pack):
    """Byte t holding only bit j lands as bit t of plane j's byte, and
    nowhere else: the transpose's orientation is the oracle's, through the
    edge words (W = 8) and the whole ones with their byte permutes (W =
    32, the byte at each of its 32 places)."""
    for w in (8, 32):
        rows = np.zeros((64 * (w // 8), w), np.uint8)
        for c in range(w // 8):
            for t in range(8):
                for j in range(8):
                    rows[64 * c + 8 * t + j, 8 * c + t] = 1 << j
        got = _pack(host_pack, rows)
        for c in range(w // 8):
            for t in range(8):
                for j in range(8):
                    want = np.zeros((8, w // 8), np.uint8)
                    want[j, c] = 1 << t
                    assert np.array_equal(got[64 * c + 8 * t + j], want), \
                        (w, c, t, j)
        _check(got, rows)


def test_pack_launcher_refuses_bad_shapes(host_pack):
    """W not a positive multiple of 8, or S negative: refused, not run;
    S = 0 launches nothing and writes nothing."""
    rows = np.zeros((2, 16), np.uint8)
    out = np.full((2, 8, 2), 0x5A, np.uint8)
    for s, w in ((2, 12), (2, 0), (2, -8), (-1, 16)):
        assert host_pack.bitplane_pack_launch(rows.ctypes.data,
                                              out.ctypes.data, s, w,
                                              None) != 0
    assert host_pack.bitplane_pack_launch(rows.ctypes.data, out.ctypes.data,
                                          0, 16, None) == 0
    assert (out == 0x5A).all()
