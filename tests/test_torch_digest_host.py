"""The scrub digest's CUDA source, built for the host and held against its
plain version on the CPU.

`scrub_digest` (ceph_tpu_torch/csrc/digest.cu) runs only on the card, but
its blocks talk only through shared memory and ``__syncthreads``.  So this
test compiles the whole source with the host C++ compiler behind a header
that defines the CUDA names it uses as host code: a block runs as one
std::thread per CUDA thread, ``__shared__`` variables are the kernel's static
locals (one copy the block's threads share), ``__syncthreads`` is a
std::barrier, and each ``<<<grid, block>>>`` launch of the C launcher runs its
blocks one after another.  Every path of the launcher (rows below a segment,
rows up to a tile, wide rows with 1 to 8 tiles a block and their join) is
compared with `scrub_digest_plain`, bit for bit: all of it is integer
arithmetic.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu_torch.gf.tables import gf_exp, gf_log
from ceph_tpu_torch.ops import checksum_kernel as ck
from ceph_tpu_torch.ops import digest_cuda as dc

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "ceph_tpu_torch",
                    "csrc")

#: the CUDA names digest.cu uses, as host code
SHIM = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __shared__ static
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx;
inline Dim3 blockIdx, blockDim;
struct uint4 { uint32_t x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
template <class K, class... A>
void host_launch(int grid, int block, K kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    blockDim.x = block;
    std::barrier<> bar(block);
    block_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] { threadIdx.x = t; kernel(args...); });
    for (auto& th : threads) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_digest(tmp_path_factory):
    """digest.cu compiled for the host, its launcher through ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    out = tmp_path_factory.mktemp("digest_host")
    with open(os.path.join(CSRC, "digest.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), 0, st>>>\(",
                     r"host_launch(\2, \3, \1, ", src)
    assert n == 4, "every launch of digest.cu rewritten"
    (out / "cuda_shim.h").write_text(SHIM)
    (out / "digest_host.cpp").write_text(src)
    so = out / "libdigest_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-w", "-pthread", "-shared",
                    "-fPIC", "-o", str(so), str(out / "digest_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.scrub_digest_launch.argtypes = [P, P, P, P, P, P, P, P, I,
                                        ctypes.c_uint, I, I, I, P, P, P]
    lib.scrub_digest_launch.restype = I
    return lib


def _batch(seed: int, s: int, w: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, w + 1, s)
    lens[0] = w
    data = np.zeros((s, w), np.uint8)
    for i, n in enumerate(lens):
        data[i, :n] = rng.integers(0, 256, n)
    mats, invp = ck.digest_operands(lens, w)
    return data, mats, invp


def _run(lib, data, mats, invp, tpb):
    s, w = data.shape
    zcols, alpha = ck.shift_operands(w)
    log = gf_log()
    log[0] = 0
    tabs = [np.ascontiguousarray(a) for a in (
        ck._crc_tables(), gf_exp().astype(np.uint8), log.astype(np.uint8),
        zcols.reshape(-1) if zcols.size else np.zeros(1, np.uint32),
        alpha if alpha.size else np.zeros(1, np.uint8))]
    parts = max(1, s * (w // dc.TILE_BYTES) // tpb)
    part = np.zeros((parts, 2), np.uint32)
    out = np.zeros((s, 2), np.uint32)
    rc = lib.scrub_digest_launch(
        data.ctypes.data, mats.ctypes.data, invp.ctypes.data,
        *[a.ctypes.data for a in tabs], zcols.shape[0], ck.init_term(w), s,
        w, tpb, part.ctypes.data, out.ctypes.data, None)
    assert rc == 0
    return out


@pytest.mark.parametrize("w,s", [(8, 5), (16, 3), (32, 300), (64, 7),
                                 (128, 130), (1024, 20), (16384, 3),
                                 (32768, 2)])
def test_digest_source_matches_plain(host_digest, w, s):
    """Rows below a segment (a thread a row, past one block at S = 300),
    rows up to a tile (whole rows a tile, a partial last tile, several
    rows a block) and the first wide width."""
    data, mats, invp = _batch(w + s, s, w)
    tpb = dc.tiles_per_block(s, w) if w > dc.TILE_BYTES else 1
    got = _run(host_digest, data, mats, invp, tpb)
    want = ck.scrub_digest_plain(torch.from_numpy(data),
                                 torch.from_numpy(mats),
                                 torch.from_numpy(invp)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tpb", [1, 2, 4, 8])
def test_digest_source_wide_rows_every_tile_split(host_digest, tpb):
    """Wide rows (8 tiles of 16 KiB): each block folds tpb tiles into its
    running span, the join kernel joins the 8 / tpb partials."""
    data, mats, invp = _batch(tpb, 2, 8 * dc.TILE_BYTES)
    got = _run(host_digest, data, mats, invp, tpb)
    want = ck.scrub_digest_plain(torch.from_numpy(data),
                                 torch.from_numpy(mats),
                                 torch.from_numpy(invp)).numpy()
    assert np.array_equal(got, want)


def test_launcher_refuses_a_bad_split(host_digest):
    """A tile split that does not cover the row is refused, not run."""
    data, mats, invp = _batch(0, 1, 2 * dc.TILE_BYTES)
    with pytest.raises(AssertionError):
        _run(host_digest, data, mats, invp, 3)


def test_tiles_per_block_fills_the_card():
    """One tile a block until the blocks fill the card, and never more
    than 256 partials a row."""
    assert dc.tiles_per_block(32, 1 << 19) == 1
    assert dc.tiles_per_block(32, 1 << 22) == 4
    assert dc.tiles_per_block(2, 1 << 22) == 1
    assert dc.tiles_per_block(2048, 1 << 22) == 256
    for s in (1, 3, 64, 1024):
        for lg in range(15, 23):
            tpb = dc.tiles_per_block(s, 1 << lg)
            assert (1 << lg) // dc.TILE_BYTES // tpb <= 256
