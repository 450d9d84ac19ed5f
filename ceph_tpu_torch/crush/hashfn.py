"""rjenkins1 32-bit hash family — the only hash CRUSH uses.

Semantics match src/crush/hash.c exactly: Robert Jenkins' 1997 96-bit mix applied to
fixed seeds (crush_hash_seed = 1315423911, x = 231232, y = 1232) in arity-specific
schedules (hash.c:26-90).  Scalar variants operate on Python ints (the oracle); the
batched torch variants live in ops.crush_kernel and are validated against these.
"""

from __future__ import annotations


CRUSH_HASH_RJENKINS1 = 0
CRUSH_HASH_SEED = 1315423911

_M32 = 0xFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b - c) & _M32; a ^= c >> 13
    b = (b - c - a) & _M32; b ^= (a << 8) & _M32
    c = (c - a - b) & _M32; c ^= b >> 13
    a = (a - b - c) & _M32; a ^= c >> 12
    b = (b - c - a) & _M32; b ^= (a << 16) & _M32
    c = (c - a - b) & _M32; c ^= b >> 5
    a = (a - b - c) & _M32; a ^= c >> 3
    b = (b - c - a) & _M32; b ^= (a << 10) & _M32
    c = (c - a - b) & _M32; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= _M32
    h = (CRUSH_HASH_SEED ^ a) & _M32
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= _M32; b &= _M32
    h = (CRUSH_HASH_SEED ^ a ^ b) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= _M32; b &= _M32; c &= _M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= _M32; b &= _M32; c &= _M32; d &= _M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= _M32; b &= _M32; c &= _M32; d &= _M32; e &= _M32
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e) & _M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h
