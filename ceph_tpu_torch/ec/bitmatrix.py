"""Bitmatrix (word-schedule) RAID-6 techniques: blaum_roth, liberation, liber8tion.

The reference's jerasure plugin implements these with per-word XOR schedules
(jerasure_schedule_encode/decode_lazy, ErasureCodeJerasure.cc:259-356).  Here
a bitmatrix code over w-bit words is a GF(2) matrix applied to k*w packet
rows — and {0,1} is the subfield of GF(2^8), so the very same batched
GF(2^8) product used for byte codes executes the schedule, with the (m*w,
k*w) 0/1 matrix as coefficients and chunks reshaped into w packet rows.  No
schedule interpreter, no per-word loop.  Its packed table, ceil(2w/4) * k*w
KiB, can exceed the card kernel's shared memory (blaum_roth at k=7, w=10:
350 KiB; liber8tion at k=8: 256 KiB): ``ops.gf_kernel.make_encoder`` then
cuts it into groups of rows, a launch each.

Constructions:
  blaum_roth   exact: Q block j = multiply-by-x^j in GF(2)[x]/((x^p-1)/(x-1)),
               w = p-1, p prime > k (Blaum & Roth 1993, as in jerasure).
  liberation   rotation blocks Q_j = R^j plus one extra bit per nonzero j
               (Plank, "The RAID-6 Liberation Codes", w prime >= k).  The extra
               bit is placed by deterministic search at init to the first
               position making every 2-erasure pattern decodable — the defining
               liberation property; bit-for-bit identity with liberation.c is
               not claimed (the reference ships no source for it either: empty
               submodule, SURVEY.md §2.4).
  liber8tion   the w=8 member of the same family (m=2, w=8).

All three are RAID-6 (m=2) codes, matching the reference's classes
(ErasureCodeJerasure.h:192-253).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.gf.matrix import gf_invert_matrix, recovery_matrix

from .base import ErasureCode, SIMD_ALIGN


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for d in range(2, int(n ** 0.5) + 1):
        if n % d == 0:
            return False
    return True


# ---------------------------------------------------------------------------
# constructions
# ---------------------------------------------------------------------------

def _poly_mod_x_pow(e: int, p: int) -> np.ndarray:
    """Coefficients of x^e mod h(x), h = x^(p-1) + ... + x + 1, over GF(2).
    Returns a (p-1,) 0/1 vector."""
    w = p - 1
    coeffs = np.zeros(e + 1, dtype=np.uint8)
    coeffs[e] = 1
    # reduce: x^(p-1) = sum_{i<p-1} x^i (mod 2)
    for d in range(e, w - 1, -1):
        if coeffs[d]:
            coeffs[d] = 0
            coeffs[d - w:d] ^= 1
    out = np.zeros(w, dtype=np.uint8)
    out[:min(w, coeffs.size)] = coeffs[:w]
    return out


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, k*w) coding bitmatrix: P row = identities, Q block j = mult-by-x^j
    in the ring GF(2)[x]/((x^p-1)/(x-1)) with p = w+1 prime."""
    p = w + 1
    if not _is_prime(p):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w, got k={k} w={w}")
    mat = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        mat[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        for c in range(w):
            mat[w:, j * w + c] = _poly_mod_x_pow(c + j, p)
    return mat


def _rotation(w: int, shift: int) -> np.ndarray:
    """R^shift: ones at (r, c) with r = (c + shift) mod w."""
    m = np.zeros((w, w), dtype=np.uint8)
    for c in range(w):
        m[(c + shift) % w, c] = 1
    return m


def _invertible(m: np.ndarray) -> bool:
    return gf_invert_matrix(m) is not None


@functools.lru_cache(maxsize=None)
def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, k*w) coding bitmatrix: P = identities; Q_j = R^j plus, for j > 0,
    one extra bit (the liberation minimal-density shape: k*w + k - 1 ones in Q).

    RAID-6 decodability reduces to pairwise conditions: losing {data_j, P}
    needs X_j invertible; losing {data_a, data_b} needs X_a xor X_b invertible
    (substitute d_b = s1 + d_a into the Q equation).  Extra bits are chosen by
    deterministic backtracking over those cheap w x w checks."""
    if w < k:
        raise ValueError(f"liberation requires w >= k, got k={k} w={w}")
    blocks = [_rotation(w, j) for j in range(k)]

    def ok(j: int, cand: np.ndarray) -> bool:
        if not _invertible(cand):
            return False
        return all(_invertible(cand ^ blocks[i]) for i in range(j))

    def candidates(base: np.ndarray):
        """Single extra bits first (odd w), then bit pairs (even w: R^a xor R^b
        is always singular — all-ones null vector — and a pair is needed)."""
        free = [(r, c) for r in range(w) for c in range(w) if not base[r, c]]
        for rc in free:
            yield (rc,)
        for i in range(len(free)):
            for j2 in range(i + 1, len(free)):
                yield (free[i], free[j2])

    def search(j: int) -> bool:
        if j == k:
            return True
        base = blocks[j].copy()
        for bits in candidates(base):
            cand = base.copy()
            for r, c in bits:
                cand[r, c] = 1
            if ok(j, cand):
                blocks[j] = cand
                if search(j + 1):
                    return True
                blocks[j] = base
        return False

    if k > 1 and not search(1):
        raise ValueError(f"no liberation extra-bit assignment for k={k} w={w}")
    mat = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        mat[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        mat[w:, j * w:(j + 1) * w] = blocks[j]
    return mat


# ---------------------------------------------------------------------------
# plugin classes
# ---------------------------------------------------------------------------

class BitmatrixCode(ErasureCode):
    """RAID-6 code defined by a (2w, k*w) GF(2) coding bitmatrix; chunks are
    reshaped into w packet rows and run through the byte-code product."""

    #: recovery matrices here are PACKET-level ((t*w, k*w) over GF(2)
    #: rows), incompatible with the base pattern table's (t, k) chunk
    #: geometry — decodes stay on the synchronous path
    supports_submit_decode = False

    TECHNIQUE = ""
    FIXED_W: int | None = None

    def parse(self, profile):
        super().parse(profile)
        self.m = 2
        self.technique = profile.get("technique", self.TECHNIQUE)
        self.w = (self.FIXED_W if self.FIXED_W is not None
                  else self.to_int("w", profile, self._default_w()))
        self.packetsize = self.to_int("packetsize", profile, 2048)

    def _default_w(self) -> int:
        return 7

    def _build_coding_bitmatrix(self) -> np.ndarray:
        raise NotImplementedError

    def _build_generator(self):
        """Full (k+m)*w x k*w GF(2) generator over packet rows."""
        coding = self._build_coding_bitmatrix()
        kw = self.k * self.w
        gen = np.zeros(((self.k + 2) * self.w, kw), dtype=np.uint8)
        gen[:kw] = np.eye(kw, dtype=np.uint8)
        gen[kw:] = coding
        return gen

    # the generator is packet-level: the chunk-level entry points reshape
    # chunks into packet rows around the base's product

    def get_alignment(self) -> int:
        return self.k * self.w * SIMD_ALIGN

    def _sub_rows(self, chunk_indices) -> list[int]:
        return [c * self.w + r for c in chunk_indices for r in range(self.w)]

    def _split(self, data_chunks):
        """(S, n, B) -> (S, n*w, B/w) packet rows (a numpy array or a
        tensor, as given)."""
        s, n, b = data_chunks.shape
        if b % self.w:
            raise ValueError(f"chunk size {b} not a multiple of w={self.w}")
        return data_chunks.reshape(s, n * self.w, b // self.w)

    def _join(self, packet_rows):
        s, nw, pb = packet_rows.shape
        return packet_rows.reshape(s, nw // self.w, pb * self.w)

    @staticmethod
    def _chunks(data_chunks):
        return (data_chunks if isinstance(data_chunks, torch.Tensor)
                else np.asarray(data_chunks, dtype=np.uint8))

    def _coding(self) -> np.ndarray:
        return self.generator[self.k * self.w:]

    def encode_chunks(self, data_chunks):
        return self._join(super().encode_chunks(
            self._split(self._chunks(data_chunks))))

    def decode_chunks(self, chosen, chunks, targets):
        return self._join(self._recover(
            tuple(chosen), tuple(targets),
            self._split(self._chunks(chunks))))

    def _recovery(self, chosen: tuple, targets: tuple) -> np.ndarray:
        def build():
            try:
                return recovery_matrix(self.generator,
                                       self._sub_rows(chosen),
                                       self._sub_rows(targets))
            except ValueError as e:
                raise IOError(str(e))
        return self._lru(self._decode_cache, (chosen, targets), build)


class BlaumRoth(BitmatrixCode):
    TECHNIQUE = "blaum_roth"

    def _default_w(self) -> int:
        return 10  # w+1=11 prime, and w >= the default k=7

    def _build_coding_bitmatrix(self):
        return blaum_roth_bitmatrix(self.k, self.w)


class Liberation(BitmatrixCode):
    TECHNIQUE = "liberation"

    def _default_w(self) -> int:
        return 7

    def _build_coding_bitmatrix(self):
        if not _is_prime(self.w):
            raise ValueError(f"liberation requires prime w, got {self.w}")
        return liberation_bitmatrix(self.k, self.w)


class Liber8tion(BitmatrixCode):
    TECHNIQUE = "liber8tion"
    FIXED_W = 8

    def _build_coding_bitmatrix(self):
        return liberation_bitmatrix(self.k, 8)


TECHNIQUES = {
    "blaum_roth": BlaumRoth,
    "liberation": Liberation,
    "liber8tion": Liber8tion,
}
