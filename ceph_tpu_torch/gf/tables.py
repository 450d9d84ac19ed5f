"""GF(2^8) table construction.

The field is GF(2)[x]/(x^8 + x^4 + x^3 + x^2 + 1), i.e. reduction polynomial 0x11d,
with generator 2 — the same field the reference's EC plugins compute in (ISA-L ec_base /
gf-complete w=8; see SURVEY.md §2.1).  Tables are built once at import from first
principles (repeated multiplication by the generator), not copied from anywhere.

Two table families:

* exp/log and the dense 256x256 product table ``mul_table()`` — the numpy oracle's
  ground truth, and the source of the per-coefficient multiply rows that the CUDA
  kernel in ops.gf_kernel keeps in shared memory.
* ``bit_matrix(coeff)`` — the coding matrix as a (k*8, m*8) GF(2) matrix: the
  table operand format of ``ec_decode_batched`` (see ``decode_bit_table``).
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D
GF_ORDER = 256


@functools.lru_cache(maxsize=None)
def _exp_log() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # periodic extension so gf_mul can index log[a]+log[b] without a modulo
    exp[255:510] = exp[0:255]
    log[0] = -1  # log of zero is undefined; callers must special-case
    return exp, log


def gf_exp() -> np.ndarray:
    """exp table (length 512, periodically extended)."""
    return _exp_log()[0].copy()


def gf_log() -> np.ndarray:
    """log table (length 256; log[0] = -1 sentinel)."""
    return _exp_log()[1].copy()


def gf_mul(a: int, b: int) -> int:
    exp, log = _exp_log()
    if a == 0 or b == 0:
        return 0
    return int(exp[log[a] + log[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    exp, log = _exp_log()
    return int(exp[(log[a] - log[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    exp, log = _exp_log()
    return int(exp[255 - log[a]])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log = _exp_log()
    return int(exp[(int(log[a]) * (n % 255)) % 255])


@functools.lru_cache(maxsize=None)
def _mul_table() -> np.ndarray:
    exp, log = _exp_log()
    a = np.arange(256)
    la = log[a]
    t = exp[np.add.outer(la, la)]
    t[0, :] = 0
    t[:, 0] = 0
    t = t.astype(np.uint8)
    t.flags.writeable = False
    return t


def mul_table() -> np.ndarray:
    """Dense 256x256 product table M[a, b] = a*b in GF(2^8).  64 KiB, read-only."""
    return _mul_table()


def bit_matrix(coeff: np.ndarray) -> np.ndarray:
    """Flatten a GF(2^8) coding matrix into a GF(2) bit matrix.

    GF(2^8) multiplication by a constant c is GF(2)-linear in the bits of the
    input byte: c * x = XOR_s bit_s(x) * (c * 2^s).  A whole (m, k) coding
    matrix therefore becomes one 0/1 matrix W of shape (k*8, m*8):

        W[j*8 + s, i*8 + r] = bit r of (coeff[i, j] * 2^s)

    and encoding is ``bits(data) @ W mod 2``.  Row ``j*8`` holds the bits of
    coeff[:, j] itself, so the matrix also carries the coefficients back out
    (ops.gf_kernel.coeffs_from_bit_table).
    Plays the role ISA-L's ``ec_init_tables`` expansion plays for PSHUFB
    (reference: src/erasure-code/isa/ErasureCodeIsa.cc:118-130).
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    m, k = coeff.shape
    mt = _mul_table()
    powers = (1 << np.arange(8)).astype(np.uint8)              # 2^s
    prods = mt[coeff.T[:, None, :], powers[None, :, None]]     # (k, 8, m)
    bits = (prods[..., None] >> np.arange(8)) & 1              # (k, 8, m, 8)
    return bits.reshape(k * 8, m * 8).astype(np.uint8)

