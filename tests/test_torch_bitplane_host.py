"""The bit-plane pack's CUDA source, built for the host and held against its
plain version on the CPU.

`bitplane_pack` (ceph_tpu_torch/csrc/bitplane.cu) runs only on the card, but
each of its threads works alone: it loads 8 bytes of a row, transposes the
8 x 8 bit matrix with three delta swaps and stores one byte into each of the
8 planes.  So this test compiles the whole source with the host C++ compiler
behind a small header that defines the CUDA names it uses as host code,
rewrites the launcher's ``<<<grid, block, smem, st>>>`` launch to a host
loop that calls the kernel once per (block, thread), and compares the
planes with `bitplane_planes_plain` and the numpy oracle `bitplane_planes_ref`
at ragged S and W, at W = 8, past one grid's worth of words (the grid
stride), and on a data pointer one byte off (the byte-at-a-time loads).
The tolerance is exact equality: the transpose is a permutation of bits.
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

#: the CUDA names bitplane.cu uses, as host code; a launch runs its blocks
#: and their threads one after another
SHIM = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline Dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline long long host_blocks = 0;
template <class K, class... A>
void host_launch(int grid, int block, size_t, K kernel, A... args) {
  gridDim.x = grid;
  blockDim.x = block;
  host_blocks = grid;
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel(args...);
    }
}
extern "C" long long host_last_grid() { return host_blocks; }
"""


@pytest.fixture(scope="module")
def host_pack(tmp_path_factory):
    """bitplane.cu compiled for the host, its launcher through ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    out = tmp_path_factory.mktemp("bitplane_host")
    with open(os.path.join(CSRC, "bitplane.cu")) as f:
        src = f.read()
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
    lib.host_last_grid.restype = ctypes.c_longlong
    return lib


def _rows(seed: int, s: int, w: int, offset: int = 0) -> np.ndarray:
    """(s, w) uint8 rows of mixed content (random, 7-bit, small integers,
    zeros), starting ``offset`` bytes into their buffer."""
    rng = np.random.default_rng(seed)
    buf = np.zeros(s * w + offset + 8, np.uint8)
    rows = buf[offset:offset + s * w].reshape(s, w)
    top = rng.choice([256, 128, 8, 1], size=(s, 1))
    rows[:] = (rng.integers(0, 256, (s, w)) % top).astype(np.uint8)
    return rows


def _pack(lib, rows: np.ndarray) -> np.ndarray:
    s, w = rows.shape
    out = np.full((s, 8, w // 8), 0xA5, np.uint8)
    assert lib.bitplane_pack_launch(rows.ctypes.data, out.ctypes.data, s, w,
                                    None) == 0
    return out


def _check(got: np.ndarray, rows: np.ndarray) -> None:
    plain = bk.bitplane_planes_plain(torch.from_numpy(rows.copy())).numpy()
    assert np.array_equal(got, plain)
    assert np.array_equal(got, bk.bitplane_planes_ref(rows))


@pytest.mark.parametrize("s,w", [(1, 8), (5, 8), (3, 24), (37, 4096),
                                 (7, 4104), (1024, 4096), (3, 65536)])
def test_pack_source_matches_plain(host_pack, s, w):
    """Ragged S and W, W = 8 (one word a row), and BlueStore's 1,024 blocks
    of 4 KiB: the kernel's planes == the plain version and the oracle."""
    rows = _rows(s * 31 + w, s, w)
    assert rows.ctypes.data % 8 == 0
    _check(_pack(host_pack, rows), rows)


@pytest.mark.parametrize("s,w", [(1, 8), (37, 4096), (9, 136)])
def test_pack_source_unaligned_pointer(host_pack, s, w):
    """A data pointer one byte off takes the byte-at-a-time loads, with
    the same planes."""
    rows = _rows(s + w, s, w, offset=1)
    assert rows.ctypes.data % 8 == 1
    _check(_pack(host_pack, rows), rows)


def test_pack_source_grid_stride(host_pack):
    """More words than one grid of 4,096 blocks x 256 threads: the grid
    caps and each thread strides over the rest."""
    s, w = 2100, 4096
    rows = _rows(7, s, w)
    _check(_pack(host_pack, rows), rows)
    assert host_pack.host_last_grid() == 4096
    assert s * w // 8 > 4096 * 256


def test_pack_source_bit_order(host_pack):
    """Byte t holding only bit j lands as bit t of plane j's byte, and
    nowhere else: the transpose's orientation is the oracle's."""
    rows = np.zeros((64, 8), np.uint8)
    for t in range(8):
        for j in range(8):
            rows[8 * t + j, t] = 1 << j
    got = _pack(host_pack, rows)
    for t in range(8):
        for j in range(8):
            want = np.zeros((8, 1), np.uint8)
            want[j, 0] = 1 << t
            assert np.array_equal(got[8 * t + j], want), (t, j)
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
