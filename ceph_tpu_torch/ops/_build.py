"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for sm_90a by its own nvcc process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes — no PyTorch headers, so the
build takes seconds, not minutes.  The library is built at the first CUDA
call, keyed by a hash of the sources, headers and flags, into
``ceph_tpu_torch/_build/`` (git-ignored); importing this module needs no nvcc.

Each C launcher takes ``c_void_p`` pointers (``tensor.data_ptr()``), ``c_int``
sizes, ``c_uint`` words, ``c_float`` scalars and the stream as ``c_void_p``
(``torch.cuda.current_stream().cuda_stream``), launches on that stream
without synchronising, and returns ``cudaGetLastError()``; ``launch`` raises
``KernelLaunchError`` when that is not 0.  A failed build raises
``KernelBuildError``.  The dispatch engine treats both as permanent: no
retry, no host fallback.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: the one
place that shows which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess

from ceph_tpu_torch.common import lockdep

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_OUT = os.path.join(_PKG, "_build")

#: compile flags of every source; the link adds -shared.  No
#: --use_fast_math: the approx filter's certificate (csrc/straw2_filter.cu)
#: rests on the library's full-precision log2f
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

#: C entry -> argument types (every entry returns a cudaError_t int)
SIGNATURES = {
    # data, packed table, pidx, out, S, k, t, B, stream
    "gf_matvec_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xs, n, R, ids, magic, shift, S, lg, ln_tab, out_pos, out_id, stream
    "straw2_root_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # xs, n, R, root_pos, leaf_rec, leaf_ids, H, S, lg, vary_r, ln_tab,
    # out_id, stream
    "straw2_leaf_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                           _P],
    # hw, lw, xs, reweight, n_rw, R, n, numrep, tries, out_h, out_l, ovf,
    # threads, stream
    "firstn_consume_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                              _I, _P],
    # xs, n, R, ids, magic, shift, wf, S, lg, D, ln_tab, lnf, out_pos,
    # out_id, ovf, stream
    "straw2_froot_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _F, _P, _P,
                            _P, _P, _P, _P],
    # ln_tab, out, d_bits, n, stream
    "ln_f32_table_launch": [_P, _P, _P, _I, _P],
    # raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len, ptemp,
    # words, m_osd, n, w, P, erasure, out, stream
    "pg_finish_ladder_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _P, _P],
    # state, weight, affinity, m_osd, out, stream
    "pg_osd_words_launch": [_P, _P, _P, _I, _P, _P],
    # data, lens, mats, invp, crc, gaps, gexp, glog, zcols, zbytes, levels,
    # init, S, W, run, scratch, out, stream
    "scrub_digest_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _U,
                            _I, _I, _I, _P, _P, _P],
    # S, W, run (int*, in and out), spans (long long*, out); no stream: not
    # a launch, the split the launcher checks
    "scrub_digest_plan": [_I, _I, _P, _P],
    # data, out, S, W, stream
    "bitplane_pack_launch": [_P, _P, _I, _I, _P],
}

#: kernel name -> launches made by its wrapper since the last reset
LAUNCHES = {"gf_matvec": 0, "straw2_root": 0, "straw2_leaf": 0,
            "firstn_consume": 0, "straw2_froot": 0, "ln_f32_table": 0,
            "pg_finish_ladder": 0, "pg_osd_words": 0, "scrub_digest": 0,
            "bitplane_pack": 0}

_LOCK = lockdep.make_lock("ops._build")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source, or the link failed."""


class KernelLaunchError(RuntimeError):
    """A C launcher returned a CUDA error instead of launching."""

_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found: the CUDA kernels cannot be built")


def _check(proc: subprocess.Popen, what: str) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {what} ({proc.returncode}):\n"
                           f"{out}\n{err}")


def build() -> str:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them
    into the cached shared library; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + _headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(_OUT, f"libkernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_OUT, exist_ok=True)
    # one build for every process on the checkout (the daemons of a
    # ProcCluster meet a cold _build/ together): the first to take the
    # lock compiles, the others wait on it and load its result
    with open(os.path.join(_OUT, "build.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            _compile(out)
    return out


def _compile(out: str) -> None:
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(_OUT, f"{os.path.basename(src)}.{os.getpid()}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        for src, proc in procs:
            _check(proc, os.path.basename(src))
        _check(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            "the link")
    finally:
        for _src, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                so = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = so
        return _LIB


def launch(kernel: str, launcher: str, *args) -> None:
    """Call one C launcher on the current stream; raise on a launch error
    and count the launch against ``kernel``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), launcher)(*args, stream)
    if err != 0:
        raise KernelLaunchError(
            f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1
