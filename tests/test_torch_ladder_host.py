"""The fused placement tail's CUDA source, built for the host and held
against its plain version on the CPU.

`pg_finish_ladder` (ceph_tpu_torch/csrc/placement.cu) runs only on the card,
but each of its threads finishes one PG row alone, with `finish_row`, from
the row's operands (in the kernel, staged into shared memory) and the
epoch's per-OSD word table (`osd_word`).  So this test compiles the source's
first anonymous namespace, which holds those functions, with the host C++
compiler behind the shim of tests/test_torch_consume_host.py (the CUDA names
it uses, as host code), packs the words and calls `finish_row` once per row
for every width instance (4, 8, 16, 32), and compares every output cell with
`ladder_plain` on the seeded adversarial operands of
tests/test_torch_placement.py.  The tolerance is
exact equality: all of it is integer arithmetic.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_consume_host import CSRC, SHIM
from test_torch_placement import EDGE, ladder_case, plain, port_operands

from ceph_tpu_torch.ops.straw2_cuda import xs_i32

#: the names the row finish uses beyond those of the consume kernel
SHIM_EXTRA = r"""
#define __host__
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((uint64_t)a * b) >> 32);
}
"""

HARNESS = r"""
#include "placement_rows.inc"
extern "C" void pack_words(const int32_t* state, const long long* weight,
                           const int32_t* affinity, int m, uint32_t* out) {
  for (int i = 0; i < m; ++i) out[i] = osd_word(state[i], weight[i], affinity[i]);
}

template <int WB, class Words>
static void rows(const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
                 const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
                 const int32_t* temp_rows, const int32_t* temp_len, const int32_t* ptemp,
                 const Words& word, int n, int w, int P, int erasure, int32_t* out) {
  for (int64_t i = 0; i < n; ++i)
    finish_row<WB>(raw + i * w, raw_len[i], items + i * 2 * P, P, up_len[i], up_rows + i * w,
                   temp_len[i], temp_rows + i * w, ptemp[i], pps + i, w, erasure != 0, word,
                   out + i * (2 * w + 4));
}

template <class Words>
static void run(int wb, const int32_t* raw, const uint32_t* pps, const int32_t* raw_len,
                const int32_t* up_rows, const int32_t* up_len, const int32_t* items,
                const int32_t* temp_rows, const int32_t* temp_len, const int32_t* ptemp,
                const Words& word, int n, int w, int P, int erasure, int32_t* out) {
  if (wb == 4)
    rows<4>(raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, word, n, w,
            P, erasure, out);
  else if (wb == 8)
    rows<8>(raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, word, n, w,
            P, erasure, out);
  else if (wb == 16)
    rows<16>(raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, word, n, w,
             P, erasure, out);
  else
    rows<32>(raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp, word, n, w,
             P, erasure, out);
}

extern "C" void run_rows(int wb, const int32_t* raw, const uint32_t* pps,
                         const int32_t* raw_len, const int32_t* up_rows, const int32_t* up_len,
                         const int32_t* items, const int32_t* temp_rows, const int32_t* temp_len,
                         const int32_t* ptemp, const uint32_t* words, int m_osd, int n, int w,
                         int P, int erasure, int32_t* out) {
  run(wb, raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp,
      OsdWords{words, m_osd}, n, w, P, erasure, out);
}

// k in [0, kmax) whose div_small quotient by d is wrong
extern "C" long long div_errors(unsigned d, unsigned kmax) {
  const uint32_t magic = div_magic(d);
  long long bad = 0;
  for (uint32_t k = 0; k < kmax; ++k) bad += div_small(k, d, magic) != k / d;
  return bad;
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """placement.cu's row finish and word packing (its first anonymous
    namespace, with the shared device code of straw2_common.cuh) compiled
    for the host behind the shim, through ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    out = tmp_path_factory.mktemp("ladder_host")
    with open(os.path.join(CSRC, "placement.cu")) as f:
        src = f.read()
    body = src[src.index("namespace {"):src.index("}  // namespace") + 1]
    with open(os.path.join(CSRC, "straw2_common.cuh")) as f:
        common = re.sub(r"#include <cuda_runtime.h>", "", f.read())
    (out / "cuda_shim.h").write_text(SHIM + SHIM_EXTRA)
    (out / "placement_rows.inc").write_text(
        '#include "cuda_shim.h"\n' + common + "\n" + body + "\n")
    (out / "harness.cpp").write_text(HARNESS)
    so = out / "libladder_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-w", "-shared", "-fPIC",
                    "-o", str(so), str(out / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pack_words.argtypes = [P, P, P, I, P]
    lib.pack_words.restype = None
    lib.run_rows.argtypes = [I] + [P] * 10 + [I] * 5 + [P]
    lib.run_rows.restype = None
    lib.div_errors.argtypes = [ctypes.c_uint, ctypes.c_uint]
    lib.div_errors.restype = ctypes.c_longlong
    return lib


def _bucket(w: int) -> int:
    return 4 if w <= 4 else 8 if w <= 8 else 16 if w <= 16 else 32


def host_words(lib, state, weight, affinity) -> np.ndarray:
    """The word table as placement.cu's osd_word packs it, as int32."""
    vec = [np.ascontiguousarray(state, dtype=np.int32),
           np.ascontiguousarray(weight, dtype=np.int64),
           np.ascontiguousarray(affinity, dtype=np.int32)]
    out = np.zeros(vec[0].shape[0], dtype=np.uint32)
    lib.pack_words(*[v.ctypes.data for v in vec], vec[0].shape[0],
                   out.ctypes.data)
    return out.view(np.int32)


def run_host(lib, case: dict, wb: int | None = None) -> np.ndarray:
    """Every row of ``case`` through finish_row, on the host-packed
    words."""
    op = port_operands(case)
    n, w = op.raw.shape
    p = op.items.shape[1]
    arrs = [np.ascontiguousarray(a) for a in (op.raw,) + op.aux()]
    words = host_words(lib, op.state, op.weight, op.affinity)
    out = np.full((n, 2 * w + 4), 0x5A5A5A5A, dtype=np.int32)
    lib.run_rows(wb or _bucket(w), *[a.ctypes.data for a in arrs],
                 words.ctypes.data,
                 words.shape[0], n, w, p, int(op.erasure), out.ctypes.data)
    return out


@pytest.mark.parametrize("erasure", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("w", [1, 3, 4, 5, 8, 12, 16, 17, 32])
def test_ladder_kernel_source_matches_plain(host_kernel, w, p, erasure):
    """Every width instance at its edges (4, 8, 16, 32) and inside them,
    N = 1, 37 and a non-power-of-two 203 with a pad row in the middle:
    every output cell equal to ladder_plain's."""
    for k, n in enumerate((1, 37, 203)):
        case = ladder_case(900 * w + 30 * p + 3 * k + int(erasure), n, w, p,
                           erasure)
        np.testing.assert_array_equal(run_host(host_kernel, case),
                                      plain(case))


@pytest.mark.parametrize("wb", [4, 8, 16, 32])
def test_ladder_kernel_wider_instances_agree(host_kernel, wb):
    """A row narrower than its instance's width gives the same cells in
    every wider instance (the `c < w` guards hold the pad cells out)."""
    case = ladder_case(4242, 61, 3, 2, False)
    want = plain(case)
    np.testing.assert_array_equal(run_host(host_kernel, case, wb), want)


@pytest.mark.parametrize("name", sorted(EDGE))
def test_ladder_kernel_edge_cases(host_kernel, name):
    """The hand-built edge cases of the tail (NONE frm against pad cells,
    chained pairs, first occurrence, the upmap gate, the affinity skip,
    temps equal to up, primary_temp)."""
    case = EDGE[name]
    np.testing.assert_array_equal(run_host(host_kernel, case), plain(case))


def test_pps_bit_pattern_reaches_the_kernel_as_u32(host_kernel):
    """Seeds at and above 2^31 pass as their int32 bit pattern and draw the
    same coin flips as the plain version's u32 values."""
    case = ladder_case(31, 64, 4, 1, False)
    case["affinity"] = np.full_like(case["affinity"], 0x8000)
    case["pps"] = np.arange(64, dtype=np.uint32) + np.uint32(0xFFFFFFC0)
    got = run_host(host_kernel, case)
    np.testing.assert_array_equal(got, plain(case))
    assert xs_i32(torch.from_numpy(case["pps"].astype(np.int64))
                      ).numpy().view(np.uint32).tolist() == case["pps"]\
        .tolist()
