"""Native (C) single-core baseline kernels, compiled on first use.

The CPU yardsticks beside the card's kernels (``baseline.c``, the reference
package's baseline): an ISA-L-class split-nibble GF(2^8) encode, which is
also the codecs' ``native`` runtime, and ``CrushBaseline``, a scalar straw2
``crush_do_rule`` (semantics of src/crush/mapper.c:900) on one host core.
The shared library builds with the system C compiler at the first call,
keyed by a hash of the source, into ``ceph_tpu_torch/_build/``
(git-ignored); no pip or cmake involved.  Nothing here touches the card.
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
            so.crush_init.argtypes = [ctypes.POINTER(ctypes.c_int64)]
            so.crush_init.restype = ctypes.c_void_p
            so.crush_free.argtypes = [ctypes.c_void_p]
            so.crush_free.restype = None
            so.crush_do_rule_c.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
            so.crush_do_rule_c.restype = ctypes.c_int
            so.crush_batch_c.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32)]
            so.crush_batch_c.restype = ctypes.c_int
            so.cpu_brand_c.argtypes = [ctypes.c_char_p]
            so.cpu_brand_c.restype = None
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


def cpu_name() -> str:
    """The host CPU's name, beside which a one-core number is given: CPUID's
    brand string, else /proc/cpuinfo's model name, else "unknown"."""
    buf = ctypes.create_string_buffer(49)
    lib().cpu_brand_c(buf)
    name = " ".join(buf.value.decode("ascii", "replace").split())
    if name:
        return name
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip() or "unknown"
    except OSError:
        pass
    return "unknown"


_TUNABLE_FIELDS = (
    "choose_local_tries", "choose_local_fallback_tries", "choose_total_tries",
    "chooseleaf_descend_once", "chooseleaf_vary_r", "chooseleaf_stable",
    "straw_calc_version")

CRUSH_ITEM_NONE = 0x7FFFFFFF


def _map_blob(crush_map) -> np.ndarray:
    """Serialize a crush.types.CrushMap into the int64 blob crush_init eats
    (format 0xCB02: header, tunables, buckets, rules, then the rh/lh/ll
    ln tables)."""
    from ceph_tpu_torch.crush.ln_table import lh_table, ll_table, rh_table
    from ceph_tpu_torch.crush.types import (CRUSH_BUCKET_STRAW,
                                            CRUSH_BUCKET_TREE)

    words: list[int] = [0xCB02, crush_map.max_devices,
                        crush_map.max_buckets, crush_map.max_rules]
    words += [getattr(crush_map.tunables, f) for f in _TUNABLE_FIELDS]
    for b in crush_map.buckets:
        if b is None:
            words.append(0)
            continue
        words += [1, b.id, b.type, b.alg, b.size]
        words += list(b.items)
        if b.alg == CRUSH_BUCKET_STRAW:
            words += list(b.straws)  # straw draws use straws, not weights
        else:
            words += list(b.item_weights) if b.item_weights \
                else [b.item_weight] * b.size
        if b.alg == CRUSH_BUCKET_TREE:
            words += [len(b.node_weights)]
            words += list(b.node_weights)
    for r in crush_map.rules:
        if r is None:
            words.append(0)
            continue
        words += [1, len(r.steps)]
        for s in r.steps:
            words += [s.op, s.arg1, s.arg2]
    words += [int(v) for v in rh_table()]
    words += [int(v) for v in lh_table()]
    words += [int(v) for v in ll_table()]
    return np.asarray(
        [w - (1 << 64) if w >= (1 << 63) else w for w in words],
        dtype=np.int64)


class CrushBaseline:
    """Scalar C crush_do_rule over a frozen CrushMap (one host core, one x
    at a time): the one-core number beside the card's batched placement.
    It runs on the host and takes no device."""

    #: the C working set holds this many result slots
    result_max_limit = 64

    def __init__(self, crush_map):
        self._blob = _map_blob(crush_map)
        self._h = lib().crush_init(
            self._blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if not self._h:
            raise NativeUnavailable("crush_init failed")

    def close(self) -> None:
        if getattr(self, "_h", None):
            lib().crush_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _guard(self, rc: int, result_max: int) -> None:
        if rc < 0:
            raise ValueError(
                f"result_max {result_max} exceeds the C baseline's "
                f"working-set capacity ({self.result_max_limit})")

    def do_rule(self, ruleno: int, x: int, result_max: int,
                weights) -> list[int]:
        w = np.ascontiguousarray(weights, dtype=np.uint32)
        out = np.full(result_max, CRUSH_ITEM_NONE, dtype=np.int32)
        n = lib().crush_do_rule_c(
            self._h, ruleno, x & 0xFFFFFFFF,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), result_max,
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(w))
        self._guard(n, result_max)
        return [int(v) for v in out[:n]]

    def do_rule_batch(self, ruleno: int, xs, result_max: int,
                      weights) -> np.ndarray:
        """(nx, result_max) int32, NONE-padded: the bulk-remap workload."""
        xs = np.ascontiguousarray(xs, dtype=np.uint32)
        w = np.ascontiguousarray(weights, dtype=np.uint32)
        out = np.empty((len(xs), result_max), dtype=np.int32)
        rc = lib().crush_batch_c(
            self._h, ruleno,
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(xs),
            result_max,
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        self._guard(rc, result_max)
        return out
