"""The consume kernel's CUDA source, built for the host and held against its
plain version on the CPU.

`firstn_consume` (ceph_tpu_torch/csrc/straw2.cu) runs only on the card, but
each of its threads works alone: the firstn ladder of one x, the is_out
verdict with hash32_2, the selections of the unrolled instances (numrep
1..8) and of the generic one.  So this test compiles the source's anonymous
namespace with the host C++ compiler behind a small header that defines the
CUDA names it uses as host code, calls the kernel once per (block, thread),
and compares every output with `consume_columns_plain` (torch's is_out, then
the ladder) on random and adversarial columns and reweights.  The tolerance
is exact equality: all of it is integer arithmetic.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ops import straw2_cuda as sc

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "ceph_tpu_torch",
                    "csrc")
NONE = 0x7FFFFFFF

#: the CUDA names the kernels of straw2.cu use, as host code; a kernel runs
#: as a function called once per (block, thread)
SHIM = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __restrict__ __restrict
#define __shared__
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
static Dim3 blockIdx, threadIdx, blockDim;
struct int4 { int x, y, z, w; };
template <class T> T __ldg(const T* p) { return *p; }
using std::min;
typedef int cudaError_t;
inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((__uint128_t)a * b) >> 64);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline void __syncthreads() {}
"""

HARNESS = r"""
#include "straw2_kernels.inc"
extern "C" void run_consume(int nr, const int32_t* hw, const int32_t* lw,
                            const uint32_t* xs, const long long* rw, int n_rw,
                            int R, int n, int numrep, int tries, int32_t* oh,
                            int32_t* ol, int32_t* ovf, int threads) {
  static void (*const k[])(const int32_t*, const int32_t*, const uint32_t*,
                           const long long*, int, int, int, int, int,
                           int32_t*, int32_t*, int32_t*) = {
      firstn_consume_kernel<0>, firstn_consume_kernel<1>,
      firstn_consume_kernel<2>, firstn_consume_kernel<3>,
      firstn_consume_kernel<4>, firstn_consume_kernel<5>,
      firstn_consume_kernel<6>, firstn_consume_kernel<7>,
      firstn_consume_kernel<8>};
  blockDim.x = threads;
  for (int b = 0; b < (n + threads - 1) / threads; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      k[nr](hw, lw, xs, rw, n_rw, R, n, numrep, tries, oh, ol, ovf);
    }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The consume kernel of straw2.cu compiled for the host, through
    ctypes: the source's anonymous namespace (the kernels and the shared
    device code of straw2_common.cuh) behind the shim."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    out = tmp_path_factory.mktemp("consume_host")
    with open(os.path.join(CSRC, "straw2.cu")) as f:
        src = f.read()
    body = src[src.index("namespace {"):src.index("}  // namespace") + 1]
    with open(os.path.join(CSRC, "straw2_common.cuh")) as f:
        common = re.sub(r"#include <cuda_runtime.h>", "", f.read())
    (out / "cuda_shim.h").write_text(SHIM)
    (out / "straw2_kernels.inc").write_text(
        '#include "cuda_shim.h"\n' + common + "\n" + body + "\n")
    (out / "harness.cpp").write_text(HARNESS)
    so = out / "libconsume_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", "-shared", "-fPIC",
                    "-o", str(so), str(out / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_consume.argtypes = [I, P, P, P, P, I, I, I, I, I, P, P, P, I]
    lib.run_consume.restype = None
    return lib


def _case(seed: int, numrep: int, kind: str):
    """Winner columns with few distinct ids (collisions, rejects, tries
    exhaustion, overflow), ids -1, n_rw and NONE among them, and a
    reweight vector of the given kind."""
    rng = np.random.default_rng(seed)
    R = int(rng.integers(max(1, numrep - 2), numrep + 9))
    n = int(rng.integers(1, 300))
    nid = int(rng.integers(2, 40))
    n_rw = int(rng.integers(1, nid + 2))
    hw = rng.integers(-8, -1, (R, n)).astype(np.int32)
    lw = rng.integers(0, nid, (R, n)).astype(np.int32)
    lw[rng.random((R, n)) < 0.03] = -1
    lw[rng.random((R, n)) < 0.03] = NONE
    lw[rng.random((R, n)) < 0.03] = n_rw
    if kind == "flat":             # choose_flat: one column for both
        hw = lw.copy()
    rw = {"zero": np.zeros(n_rw),
          "full": np.full(n_rw, 0x10000),
          "0xFFFF": np.full(n_rw, 0xFFFF),
          "above and negative": rng.choice(
              [0x10001, 0x7FFFFFFF, 2 ** 40, -1, -0x10000], n_rw),
          "partial": rng.integers(0, 0x10001, n_rw),
          "flat": rng.choice([0, 0x10000, 0x8000, 0x20000, -3, 1], n_rw),
          }[kind].astype(np.int64)
    xs = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    tries = int(rng.choice([1, 2, 3, 5, 51]))
    return hw, lw, xs, rw, tries


@pytest.mark.parametrize("kind", ["zero", "full", "0xFFFF",
                                  "above and negative", "partial", "flat"])
@pytest.mark.parametrize("numrep", [1, 3, 8, 9])
def test_consume_kernel_source_matches_plain(host_kernel, numrep, kind):
    """Every unrolled instance the paths use (3), the ends of the unrolled
    range (1, 8) and the generic instance (9), over 20 random shapes each:
    selections and overflow flags equal to the plain version's."""
    for seed in range(20):
        hw, lw, xs, rw, tries = _case(1000 * numrep + seed, numrep, kind)
        R, n = hw.shape
        x32 = sc.xs_i32(torch.from_numpy(xs)).numpy()
        oh = np.empty((numrep, n), np.int32)
        ol = np.empty_like(oh)
        ovf = np.empty(n, np.int32)
        host_kernel.run_consume(
            numrep if numrep <= 8 else 0, hw.ctypes.data, lw.ctypes.data,
            x32.ctypes.data, rw.ctypes.data, rw.shape[0], R, n, numrep, tries,
            oh.ctypes.data, ol.ctypes.data, ovf.ctypes.data,
            sc.consume_threads(n, 132))
        ph, pl, pov = sc.consume_columns_plain(
            torch.from_numpy(hw), torch.from_numpy(lw), torch.from_numpy(xs),
            torch.from_numpy(rw), numrep=numrep, tries=tries)
        np.testing.assert_array_equal(oh, ph.numpy())
        np.testing.assert_array_equal(ol, pl.numpy())
        np.testing.assert_array_equal(ovf, pov.numpy())


@pytest.mark.parametrize("kind", ["partial", "flat"])
@pytest.mark.parametrize("numrep", [65, 100])
def test_consume_generic_instance_past_64_matches_plain(host_kernel, numrep,
                                                        kind):
    """The generic instance keeps its selections in its output columns, so
    it takes any numrep: at 65 and 100, equal to the plain version's
    selections and overflow flags over 3 random shapes each, with fewer
    tries than the test above so that the plain ladder stays quick."""
    for seed in range(3):
        hw, lw, xs, rw, _tries = _case(1000 * numrep + seed, numrep, kind)
        tries = (2, 5, 12)[seed]
        R, n = hw.shape
        x32 = sc.xs_i32(torch.from_numpy(xs)).numpy()
        oh = np.empty((numrep, n), np.int32)
        ol = np.empty_like(oh)
        ovf = np.empty(n, np.int32)
        host_kernel.run_consume(
            0, hw.ctypes.data, lw.ctypes.data, x32.ctypes.data,
            rw.ctypes.data, rw.shape[0], R, n, numrep, tries,
            oh.ctypes.data, ol.ctypes.data, ovf.ctypes.data,
            sc.consume_threads(n, 132))
        ph, pl, pov = sc.consume_columns_plain(
            torch.from_numpy(hw), torch.from_numpy(lw), torch.from_numpy(xs),
            torch.from_numpy(rw), numrep=numrep, tries=tries)
        np.testing.assert_array_equal(oh, ph.numpy())
        np.testing.assert_array_equal(ol, pl.numpy())
        np.testing.assert_array_equal(ovf, pov.numpy())
