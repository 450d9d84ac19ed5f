"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ONE nvcc call for sm_90a into a
shared library with a plain C interface, loaded with ctypes — no PyTorch
headers, so the build takes seconds, not minutes.  The library is built at
the first CUDA call, keyed by a hash of the sources and flags, into
``ceph_tpu_torch/_build/`` (git-ignored); importing this module needs no nvcc.

Each C launcher takes ``c_void_p`` pointers (``tensor.data_ptr()``), ``c_int``
sizes and the stream as ``c_void_p`` (``torch.cuda.current_stream().
cuda_stream``), launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: the one
place that shows which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_OUT = os.path.join(_PKG, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C launcher -> argument types (every launcher returns a cudaError_t int)
SIGNATURES = {
    # data, mul_rows, pidx, out, S, k, t, B, vec, stream
    "gf_matvec_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xs, n, R, ids, w, S, ln_tab, out_pos, out_id, stream
    "straw2_root_launch": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _P],
    # xs, n, R, root_pos, leaf_ids, leaf_w, H, S, vary_r, ln_tab, out_id,
    # stream
    "straw2_leaf_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # hw, lw, lb, R, n, numrep, tries, out_h, out_l, ovf, stream
    "firstn_consume_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
}

#: kernel name -> launches made by its wrapper since the last reset
LAUNCHES = {"gf_matvec": 0, "straw2_root": 0, "straw2_leaf": 0,
            "firstn_consume": 0}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile csrc/*.cu into the cached shared library; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(_OUT, f"libkernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
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
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1
