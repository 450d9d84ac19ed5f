"""GF(2^8) matrix generators and inversion.

Matrix semantics follow the reference's ISA plugin contract
(src/erasure-code/isa/ErasureCodeIsa.cc:367-420 calls gf_gen_rs_matrix /
gf_gen_cauchy1_matrix from ISA-L; the library itself is an empty submodule in the
reference checkout, so these are reimplemented from the published constructions):

* cauchy1: rows 0..k-1 are the identity; coding row (i >= k) has
  a[i][j] = inv(i ^ j).  MDS for any k, m with k + m <= 256.
* rs_vandermonde: rows 0..k-1 identity; coding row i >= k is the geometric
  progression [1, g, g^2, ...] with g = 2^(i-k).  NOT guaranteed MDS for large k/m —
  the reference guards k<=32, m<=4 (ErasureCodeIsa.cc:330-361); we expose the same
  construction and the same guard lives in the plugin layer.

Inversion is Gauss-Jordan with row pivoting, mirroring gf_invert_matrix's observable
behaviour (returns failure on a singular matrix; ErasureCodeIsa.cc:274).
"""

from __future__ import annotations

import numpy as np

from .tables import _mul_table, gf_inv


def gen_cauchy1_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) generator matrix: identity stacked on the cauchy block."""
    if k + m > 256:
        raise ValueError(f"k+m={k + m} exceeds GF(2^8) field size")
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k, :k] = np.eye(k, dtype=np.uint8)
    for i in range(k, k + m):
        for j in range(k):
            a[i, j] = gf_inv(i ^ j)
    return a


def gen_rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) generator matrix: identity stacked on geometric-progression rows."""
    if k + m > 256:
        raise ValueError(f"k+m={k + m} exceeds GF(2^8) field size")
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k, :k] = np.eye(k, dtype=np.uint8)
    gen = 1
    for i in range(k, k + m):
        p = 1
        for j in range(k):
            a[i, j] = p
            p = _gf_mul_int(p, gen)
        gen = _gf_mul_int(gen, 2)
    return a


def _gf_mul_int(a: int, b: int) -> int:
    return int(_mul_table()[a, b])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of uint8 matrices (XOR-accumulated products)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    mt = _mul_table()
    # products[i, l, j] = a[i, l] * b[l, j]; XOR-reduce over l
    prods = mt[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(prods, axis=1)


def recovery_matrix(gen: np.ndarray, chosen: list[int],
                    targets: list[int]) -> np.ndarray:
    """Decode matrix: reconstruct chunk rows ``targets`` from chunk rows ``chosen``.

    Mirrors the reference decode structure (ErasureCodeIsa.cc:150-310 /
    jerasure_matrix_decode): take the k surviving generator rows, invert, and
    multiply by the target rows.  ``gen`` is the (k+m, k) generator matrix,
    ``chosen`` exactly k surviving chunk indices, ``targets`` the chunk indices to
    rebuild.  Returns (len(targets), k) uint8 — apply it to the chosen chunks with
    the same batched kernel used for encode.

    Raises ValueError if the chosen rows are singular (non-MDS corner or bad choice).
    """
    gen = np.asarray(gen, dtype=np.uint8)
    k = gen.shape[1]
    if len(chosen) != k:
        raise ValueError(f"need exactly k={k} chosen rows, got {len(chosen)}")
    sub = gen[list(chosen)]
    inv = gf_invert_matrix(sub)
    if inv is None:
        raise ValueError(f"chosen rows {chosen} give a singular submatrix")
    return gf_matmul(gen[list(targets)], inv)


def gf_invert_matrix(mat: np.ndarray) -> np.ndarray | None:
    """Invert a square GF(2^8) matrix; returns None if singular."""
    mat = np.asarray(mat, dtype=np.uint8)
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError("matrix must be square")
    mt = _mul_table()
    aug = np.concatenate([mat.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot_rows = np.nonzero(aug[col:, col])[0]
        if pivot_rows.size == 0:
            return None
        pr = col + int(pivot_rows[0])
        if pr != col:
            aug[[col, pr]] = aug[[pr, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = mt[aug[col], inv_p]
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= mt[aug[col], aug[row, col]]
    return aug[:, n:].copy()
