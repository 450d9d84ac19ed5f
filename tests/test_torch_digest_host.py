"""The scrub digest's CUDA source, built for the host and held against its
plain version and zlib on the CPU.

`scrub_digest` (ceph_tpu_torch/csrc/digest.cu) runs only on the card, but
its threads talk only through shared memory, ``__syncthreads``, warp
shuffles and the scratch its second launch reads.  So this test compiles
the whole source with the host C++ compiler behind a header that defines
the CUDA names it uses as host code: a block runs as one std::thread per
CUDA thread, the block's dynamic shared memory is one buffer its threads
share (filled with a poison byte first), ``__syncthreads`` is a
std::barrier of the block, each warp's ``__shfl_*_sync`` is an exchange
between two barriers of its 32 threads, and each ``<<<grid, block, smem,
st>>>`` launch of the C launcher runs its blocks one after another.  The
number of SMs the launcher sees is set per case (``host_set_sms``), so a
wide row's items spread over several blocks before the join launch
finishes the row; the split (``scrub_digest_plan``) is the source's own.
Every path (a lane a row, several rows a warp item, a row over one item,
rows over many items), with and without row lengths, is compared with
`scrub_digest_plain` and with zlib, bit for bit: all of it is integer
arithmetic.
"""

import ctypes
import os
import re
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch.gf.tables import gf_exp, gf_log
from ceph_tpu_torch.ops import checksum_kernel as ck

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "ceph_tpu_torch",
                    "csrc")

#: the CUDA names digest.cu uses, as host code
SHIM = r"""
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx;
inline Dim3 blockIdx, blockDim, gridDim;
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// the modelled card's SMs; each count is a device of its own (numbered in
// the order the counts are first set), so that the launcher's per-device
// cache sees a change
inline int host_sms_of[64];
inline int host_devices = 0, host_dev = 0;
extern "C" void host_set_sms(int n) {
  for (host_dev = 0; host_dev < host_devices; ++host_dev)
    if (host_sms_of[host_dev] == n) return;
  host_sms_of[host_devices++] = n;
}
inline cudaError_t cudaGetDevice(int* d) { *d = host_dev; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int d) {
  *v = host_sms_of[d];
  return 0;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
struct HostWarp {
  std::barrier<> bar{32};
  uint32_t slot[32];
};
inline std::barrier<>* block_barrier;
inline std::vector<std::unique_ptr<HostWarp>>* block_warps;
inline unsigned char* host_smem;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline uint32_t host_exchange(uint32_t v, unsigned src) {
  HostWarp& w = *(*block_warps)[threadIdx.x / 32];
  w.slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  const uint32_t r = w.slot[src];
  w.bar.arrive_and_wait();
  return r;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  return host_exchange(v, src & 31);
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, unsigned d) {
  const unsigned l = threadIdx.x % 32;
  return host_exchange(v, l + d < 32 ? l + d : l);
}
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int m) {
  return host_exchange(v, (threadIdx.x % 32) ^ m);
}
#define DIGEST_SHARED_TABLES(name) \
  Tables& name = *reinterpret_cast<Tables*>(host_smem)
template <class K, class... A>
void host_launch(int grid, int block, size_t smem, K kernel, A... args) {
  gridDim.x = grid;
  blockDim.x = block;
  const size_t bytes = (smem + 63) / 64 * 64;
  unsigned char* buf = static_cast<unsigned char*>(std::aligned_alloc(64,
                                                                      bytes));
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(buf, 0xA5, bytes);
    std::barrier<> bar(block);
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (int w = 0; w < block / 32; ++w)
      warps.push_back(std::make_unique<HostWarp>());
    block_barrier = &bar;
    block_warps = &warps;
    host_smem = buf;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] { threadIdx.x = t; kernel(args...); });
    for (auto& th : threads) th.join();
  }
  std::free(buf);
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
    src, n = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), st>>>\(",
                     r"host_launch(\2, \3, \4, \1, ", src)
    assert n == 2, "both launches of digest.cu rewritten"
    (out / "cuda_shim.h").write_text(SHIM)
    (out / "digest_host.cpp").write_text(src)
    so = out / "libdigest_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-w", "-pthread", "-shared",
                    "-fPIC", "-o", str(so), str(out / "digest_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.scrub_digest_launch.argtypes = [P] * 10 + [I, ctypes.c_uint, I, I,
                                                   I, P, P, P]
    lib.scrub_digest_launch.restype = I
    lib.scrub_digest_plan.argtypes = [I, I, P, P]
    lib.scrub_digest_plan.restype = I
    lib.host_set_sms.argtypes = [I]
    return lib


def _plan(lib, s, w, run=0, sms=132):
    """(run, spans): the source's split of an (s, w) batch on a card of
    ``sms`` SMs (run 0: picked, else checked)."""
    r, spans = ctypes.c_int(run), ctypes.c_longlong(0)
    lib.host_set_sms(sms)
    rc = lib.scrub_digest_plan(s, w, ctypes.byref(r), ctypes.byref(spans))
    assert rc == 0, (s, w, run, rc)
    return r.value, spans.value


def _batch(seed: int, s: int, w: int, lens=None):
    """(data, mats, invp, lens): s zero-padded rows of width w, random
    lengths (the first row full) unless ``lens`` is given."""
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(0, w + 1, s)
        lens[0] = w
    lens = np.asarray(lens, dtype=np.int32)
    data = np.zeros((s, w), np.uint8)
    for i, n in enumerate(lens):
        data[i, :n] = rng.integers(0, 256, n)
    mats, invp = ck.digest_operands(lens, w)
    return data, mats, invp, lens


#: what the scratch holds before a launch: every item of a wide row
#: overwrites its slot
POISON = 0x5A5A5A5A


def _spans(scratch, s):
    """(s, items a row, 2): each warp item's span, moved to its row's end;
    every slot written, those of items past the row's length zero."""
    spans = scratch.reshape(s, -1, 2)
    assert not (spans == POISON).all(axis=2).any()
    return spans


def _tables(zcols):
    """The launcher's table operands after invp: crc, gaps, gexp, glog,
    zcols, zbytes."""
    log = gf_log()
    log[0] = 0
    return [np.ascontiguousarray(a) for a in (
        ck._crc_tables(), ck.chunk_gap_tables(), gf_exp().astype(np.uint8),
        log.astype(np.uint8),
        zcols.reshape(-1) if zcols.size else np.zeros(1, np.uint32),
        ck.tree_tables(ck.CHUNK_BYTES))]


def _run(lib, data, mats, invp, run=0, lens=None, sms=2, scratch_out=None):
    """The launch on the host at ``run`` (0: the run the source picks for
    132 SMs), its blocks spread as on a card of ``sms`` SMs."""
    s, w = data.shape
    run, spans = _plan(lib, s, w, run)
    zcols, _alpha = ck.shift_operands(w, run)
    tabs = _tables(zcols)
    scratch = np.full((max(spans, 1), 2), POISON, np.uint32)
    out = np.zeros((s, 2), np.uint32)
    lib.host_set_sms(sms)
    rc = lib.scrub_digest_launch(
        data.ctypes.data, None if lens is None else lens.ctypes.data,
        mats.ctypes.data, invp.ctypes.data, *[a.ctypes.data for a in tabs],
        zcols.shape[0], ck.init_term(w), s, w, run,
        scratch.ctypes.data if spans else None, out.ctypes.data,
        None)
    assert rc == 0
    if scratch_out is not None:
        scratch_out.append(scratch)
    return out


def _plain(data, mats, invp):
    return ck.scrub_digest_plain(torch.from_numpy(data),
                                 torch.from_numpy(mats),
                                 torch.from_numpy(invp)).numpy()


def _check(got, data, mats, invp, lens):
    """``got`` == the plain version over the whole padded rows, and == zlib
    and the GF loop over each row's first lens[i] bytes."""
    assert np.array_equal(got, _plain(data, mats, invp))
    assert np.array_equal(got, ck.scrub_digest_ref(data, lens))


@pytest.mark.parametrize("w,s", [(8, 5), (16, 3), (32, 300), (64, 7),
                                 (128, 130), (1024, 20), (16384, 3),
                                 (32768, 2)])
def test_digest_source_matches_plain(host_digest, w, s):
    """Whole rows (no lengths) at the run the wrapper picks: a lane a row
    (W <= 64, past one warp item at S = 300), several rows a warp item
    (W = 128, 1,024) and rows over several items (16 KiB, 32 KiB)."""
    data, mats, invp, _lens = _batch(w + s, s, w)
    got = _run(host_digest, data, mats, invp)
    assert np.array_equal(got, _plain(data, mats, invp))


@pytest.mark.parametrize("tpb", [1, 2, 4, 8])
def test_digest_source_wide_rows_every_tile_split(host_digest, tpb):
    """Wide rows (128 KiB, 64 warp items of 32 runs of 64 bytes each)
    spread over tpb blocks: every item moves its span to the row's end, and
    the join launch XORs a row's spans and finishes it."""
    data, mats, invp, lens = _batch(tpb, 2, 8 * 16384)
    got = _run(host_digest, data, mats, invp, 64, sms=tpb)
    _check(got, data, mats, invp, lens)


def test_launcher_refuses_a_bad_split(host_digest):
    """A run that does not split the row (not a power of two, past the row,
    past 1,024 bytes), levels that do not match the run, or no scratch for
    a row over several warp items: refused, not run."""
    w = 2 * 16384
    data, mats, invp, _lens = _batch(0, 1, w)
    zcols, _alpha = ck.shift_operands(w, 64)
    tabs = _tables(zcols)
    out = np.zeros((1, 2), np.uint32)
    scratch = np.zeros((_plan(host_digest, 1, w, 64)[1], 2), np.uint32)

    def rc(run, levels, scr=scratch):
        return host_digest.scrub_digest_launch(
            data.ctypes.data, None, mats.ctypes.data, invp.ctypes.data,
            *[a.ctypes.data for a in tabs], levels, ck.init_term(w), 1, w,
            run, None if scr is None else scr.ctypes.data, out.ctypes.data,
            None)

    assert rc(64, zcols.shape[0]) == 0
    for run, levels in ((48, 9), (1 << 16, 0), (2048, 4), (64, 8), (8, 12),
                        (w, 0), (2048, 9)):
        assert rc(run, levels) != 0, run
    assert rc(64, zcols.shape[0], None) != 0


#: row lengths of a case, as a function of (rows, width, rng)
LENGTHS = {
    "zero": lambda s, w, rng: np.zeros(s, np.int64),
    "one_to_three": lambda s, w, rng: rng.integers(1, 4, s),
    "not_a_multiple_of_4": lambda s, w, rng: np.maximum(
        1, rng.integers(0, w // 4, s) * 4 + rng.integers(1, 4, s))
    .clip(max=w - 1),
    "exactly_w": lambda s, w, rng: np.full(s, w),
    "one_far_shorter": lambda s, w, rng: np.concatenate(
        [np.full(s - 1, w), [min(w, 5)]]),
}


@pytest.mark.parametrize("w", [8, 64, 4096, 1 << 16, 1 << 19])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_digest_source_row_lengths(host_digest, w, case):
    """Rows read only up to their lengths: L = 0, 1-3, not a multiple of 4,
    exactly W, and one row far shorter than the rest, at the run the wrapper
    picks for 3 rows (a lane a row up to 64 bytes, a row over one or more
    warp items above), bit for bit the whole-row digest and zlib."""
    rng = np.random.default_rng(w)
    s = 3
    data, mats, invp, lens = _batch(w, s, w, LENGTHS[case](s, w, rng))
    got = _run(host_digest, data, mats, invp, lens=lens, sms=3)
    _check(got, data, mats, invp, lens)


@pytest.mark.parametrize("run", [64, 256, 1024])
def test_digest_source_omap_chunk(host_digest, run):
    """A scrub chunk's shape, cut to 2^16: 4 data rows full and 4 omap
    rows under 64 bytes, with their lengths, at three runs; the omap rows'
    items past their first read nothing and leave zero spans."""
    rng = np.random.default_rng(run)
    w = 1 << 16
    lens = np.concatenate([np.full(4, w), rng.integers(0, 64, 4)])
    data, mats, invp, lens = _batch(run, 8, w, lens)
    scratch = []
    got = _run(host_digest, data, mats, invp, run, lens=lens, sms=4,
               scratch_out=scratch)
    _check(got, data, mats, invp, lens)
    spans = _spans(scratch[0], 8)
    assert not spans[4:, 1:].any()


def test_digest_source_row_split_last_block_finish(host_digest):
    """Rows of 2^16 over 32 warp items of 2 KiB, on 4 blocks: every item
    leaves its span (zero past the row's length), and the join launch
    finishes each row from them."""
    data, mats, invp, lens = _batch(5, 3, 1 << 16,
                                    [1 << 16, 40000, (1 << 16) - 3])
    scratch = []
    got = _run(host_digest, data, mats, invp, 64, lens=lens, sms=4,
               scratch_out=scratch)
    _check(got, data, mats, invp, lens)
    spans = _spans(scratch[0], 3)
    span = 32 * 64
    for i, n in enumerate(lens):
        assert not spans[i, -(-int(n) // span):].any()


@pytest.mark.parametrize("run", [64, 128])
def test_digest_source_bluestore_blocks(host_digest, run):
    """BlueStore's shape: 1,024 rows of one 4 KiB block each, every row
    full, at 64 (two warp items a row, the join launch) and at the
    wrapper's run, 128 (one warp item a row)."""
    rng = np.random.default_rng(run)
    s, w = 1024, 4096
    data = rng.integers(0, 256, (s, w), dtype=np.uint8)
    lens = np.full(s, w, np.int32)
    mats, invp = ck.digest_operands(lens, w)
    got = _run(host_digest, data, mats, invp, run, lens=lens, sms=4)
    _check(got, data, mats, invp, lens)
    if run == 128:
        assert _plan(host_digest, s, w)[0] == run


def test_plan_fills_the_card(host_digest):
    """The run the source picks is twice what would spread the padded batch
    over one wave of 132 x 1,024 lanes, a power of two within 64 .. 1,024
    bytes; a row of up to twice its item (and at most 32 KiB) is one item;
    a row under 512 bytes is one lane's.  Every pick passes the launcher's
    check, and the scratch holds one span for each item of a row over
    several."""
    def plan(s, w):
        return _plan(host_digest, s, w)

    assert plan(32, 1 << 22) == (1024, 32 * 128)
    assert plan(32, 1 << 19)[0] == 128
    assert plan(1024, 4096) == (128, 0)
    assert plan(2048, 1 << 22)[0] == 1024
    assert plan(5, 8) == (8, 0)
    assert plan(3, 256) == (256, 0)
    assert plan(3, 512) == (16, 0)
    assert plan(3, 4096) == (128, 0)
    # 2,048 rows of 64 KiB: run 1,024, and a row (two such items) stays two
    # items, since one item of 2 KiB a lane is past the kernel's run
    assert plan(2048, 1 << 16) == (1024, 2048 * 2)
    for s in (1, 3, 64, 1024, 2048, 4096):
        for lg in range(3, 23):
            w = 1 << lg
            run, spans = plan(s, w)
            assert run & (run - 1) == 0
            assert _plan(host_digest, s, w, run) == (run, spans)
            if w < 512:
                assert run == w and spans == 0
                continue
            assert 32 * run <= w and 16 <= run <= 1024
            assert spans == (s * (w // (32 * run)) if w > 32 * run else 0)
            assert run >= min(64, w // 32)
            if run < w // 32:       # a wide row: a run spreads the batch
                assert w // 32 > 2 * run or w // 32 > 1024
                assert run == 1024 or s * w < 132 * 1024 * run


def test_tree_tables_are_the_level_shifts():
    """tree_tables(run)[k] is Z^(run 2^k) split by byte: the XOR of the four
    lookups of a register equals the level's columns applied to it."""
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    for run in (8, 64, 1024):
        tabs = ck.tree_tables(run)
        zcols, _alpha = ck.shift_operands(1 << 22, run)
        for k in range(ck.TREE_LEVELS):
            got = (tabs[k, 0][vals & 0xFF] ^ tabs[k, 1][(vals >> 8) & 0xFF]
                   ^ tabs[k, 2][(vals >> 16) & 0xFF] ^ tabs[k, 3][vals >> 24])
            assert np.array_equal(got, ck._apply_cols(zcols[k], vals))


def test_digest_zlib_spot_check(host_digest):
    """One odd-length row at 2^19 against zlib.crc32 directly."""
    data, mats, invp, lens = _batch(9, 1, 1 << 19, [(1 << 19) - 7])
    got = _run(host_digest, data, mats, invp, 1024, lens=lens, sms=2)
    assert int(got[0, 0]) == zlib.crc32(data[0, :int(lens[0])].tobytes())
