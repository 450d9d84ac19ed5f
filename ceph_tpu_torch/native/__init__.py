"""Native (C) single-core GF(2^8) encode, compiled on first use.

The codecs' ``native`` runtime and the CPU yardstick beside the card's
kernel: an ISA-L-class split-nibble encode (``baseline.c``, the encode half
of the reference package's baseline).  The shared library builds with the
system C compiler at the first call, keyed by a hash of the source, into
``ceph_tpu_torch/_build/`` (git-ignored); no pip or cmake involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ceph_tpu_torch.common import lockdep

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "baseline.c")
_OUT = os.path.join(os.path.dirname(_DIR), "_build")
#: the C encode keeps at most this many accumulators (parity rows)
MAX_ROWS = 32
CFLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]

_LOCK = lockdep.make_lock("native.lib")
_LIB: ctypes.CDLL | None = None


class NativeUnavailable(RuntimeError):
    pass


def build() -> str:
    """Compile baseline.c into the cached shared library; returns its path."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    out = os.path.join(_OUT, f"baseline_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *CFLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out
    raise NativeUnavailable("no working C compiler found")


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            so.ec_encode_c.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_long, ctypes.c_long]
            so.ec_encode_c.restype = None
            _LIB = so
        return _LIB


def ec_encode_native(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Single-core C encode.  matrix (m, k) uint8 with m <= MAX_ROWS; data
    (stripes, k, chunk) uint8.  Returns parity (stripes, m, chunk)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    m, k = matrix.shape
    stripes, k2, chunk = data.shape
    if k2 != k:
        raise ValueError(f"data has k={k2}, the matrix k={k}")
    if m > MAX_ROWS:
        raise ValueError(f"the C encode takes at most {MAX_ROWS} rows, "
                         f"got {m}")
    parity = np.empty((stripes, m, chunk), dtype=np.uint8)
    lib().ec_encode_c(
        matrix.ctypes.data_as(ctypes.c_char_p), k, m,
        data.ctypes.data_as(ctypes.c_char_p),
        parity.ctypes.data_as(ctypes.c_char_p), stripes, chunk)
    return parity
