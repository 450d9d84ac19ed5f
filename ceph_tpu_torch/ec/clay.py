"""CLAY — coupled-layer MSR regenerating code
(src/erasure-code/clay/ErasureCodeClay.cc analog; the reason the plugin
interface carries sub-chunks, ErasureCodeInterface.h:259).

Construction (Clay codes, FAST'18): n = k + m nodes on a q x t grid
(q = m, t = n/q), each chunk split into alpha = q^t sub-chunks indexed
by z in Z_q^t.  A virtual UNCOUPLED code U is MDS per z-plane (an [n,k]
RS codeword across the nodes); the physical chunks C couple sub-chunk
PAIRS across planes with an invertible 2x2 GF(2^8) transform:

    pair of (x, y, z) with x != z_y  is  (z_y, y, z(y->x))
    C1 = U1 + g*U2        C2 = g*U1 + U2        (g = 2; 1+g^2 != 0)
    x == z_y: C = U (fixed points)

Encode treats the m parities as erasures and runs the generic decoder.
Decode walks planes by INTERSECTION SCORE s(z) = |{y : (z_y, y) is
erased}|: in score order, every surviving node's U is computable (its
partner is either surviving, or an erased node in a lower-score plane
already recovered), the plane's RS codeword is then decoded for the
erased nodes, and finally erased C values come back through the pair
transform.

Single-node repair is the headline: only the q^(t-1) planes S =
{z : z_{y0} = x0} are read from each of the d = n-1 helpers — alpha/q
sub-chunks instead of whole chunks, the MSR repair-bandwidth optimum.
On each S-plane the y != y0 rows uncouple internally (their partners
stay inside S), the y0 row's q unknowns fall to the plane's m = q RS
parity equations, and the pair algebra then yields the failed node's
off-S sub-chunks from helper row y0's coupled values.  All transforms
are elementwise table lookups over the sub-chunk byte axis — batched,
vectorized compute, no per-byte loops.  Each plane's RS product is one
call of the codec's product: on the cuda runtime a gf_matvec launch with
one stripe, then an explicit copy to the host.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.gf.matrix import gen_cauchy1_matrix
from ceph_tpu_torch.gf.tables import gf_inv, gf_mul, mul_table

from .base import ErasureCode, to_host
from .interface import ErasureCodeProfile
from .registry import register

GAMMA = 2


def _mul(coef: int, arr: np.ndarray) -> np.ndarray:
    """scalar * vector over GF(2^8), one table-row gather."""
    return mul_table()[coef][arr]


class ErasureCodeClay(ErasureCode):
    supports_rmw_striping = False

    def __init__(self):
        super().__init__()
        self.q = 0
        self.t = 0

    def _default_k(self) -> int:
        return 4

    def _default_m(self) -> int:
        return 2

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        n = self.k + self.m
        if n % self.m != 0:
            raise ValueError(
                f"clay requires m | (k+m); got k={self.k} m={self.m} "
                f"(the reference shortens instead; not implemented)")
        self.q = self.m
        self.t = n // self.q

    def _build_generator(self) -> np.ndarray:
        return gen_cauchy1_matrix(self.k, self.m)

    # -- geometry -------------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.q ** self.t

    def get_alignment(self) -> int:
        return self.k * self.get_sub_chunk_count()

    def node_xy(self, i: int) -> tuple[int, int]:
        return i % self.q, i // self.q

    def node_id(self, x: int, y: int) -> int:
        return y * self.q + x

    def _planes(self):
        """All z vectors (alpha of them), as tuples."""
        import itertools
        return list(itertools.product(range(self.q), repeat=self.t))

    @staticmethod
    def _zset(z: tuple, y: int, x: int) -> tuple:
        return z[:y] + (x,) + z[y + 1:]

    # -- pair transforms (vectorized over the sub-chunk byte axis).
    # the forward coupling C1 = U1 ^ g*U2 lives inline in _decode_planes
    # and repair; only the inverse needs a helper.

    @staticmethod
    def _uncouple(c1, c2):
        inv = gf_inv(1 ^ gf_mul(GAMMA, GAMMA))
        u1 = _mul(inv, c1 ^ _mul(GAMMA, c2))
        u2 = _mul(inv, _mul(GAMMA, c1) ^ c2)
        return u1, u2

    # -- the generic layered decoder ------------------------------------------

    def _decode_planes(self, C: dict, erased: list[int]):
        """C: {(node, z): uint8 array} for all surviving nodes and all
        planes.  Returns (U, C) completed for every node and plane
        (ErasureCodeClay recover: intersection-score order)."""
        n = self.k + self.m
        planes = self._planes()
        er = set(erased)
        surv = [i for i in range(n) if i not in er]
        if len(surv) < self.k:
            raise IOError(f"clay cannot decode {sorted(er)}")
        U: dict = {}

        def score(z):
            return sum(1 for y in range(self.t)
                       if self.node_id(z[y], y) in er)

        for z in sorted(planes, key=score):
            # uncouple every surviving node on this plane
            for i in surv:
                x, y = self.node_xy(i)
                if z[y] == x:
                    U[(i, z)] = C[(i, z)]
                    continue
                partner = self.node_id(z[y], y)
                zp = self._zset(z, y, x)
                if partner in er:
                    # partner plane has lower score: its U is recovered
                    U[(i, z)] = C[(i, z)] ^ _mul(GAMMA, U[(partner, zp)])
                else:
                    u1, _u2 = self._uncouple(C[(i, z)], C[(partner, zp)])
                    U[(i, z)] = u1
            # plane RS decode for the erased nodes
            chosen = surv[:self.k]
            arr = np.stack([U[(i, z)] for i in chosen])
            rebuilt = self._apply(tuple(chosen), tuple(sorted(er)), arr)
            for idx, i in enumerate(sorted(er)):
                U[(i, z)] = rebuilt[idx]
        # couple the erased nodes' C back from U
        for z in planes:
            for i in sorted(er):
                x, y = self.node_xy(i)
                if z[y] == x:
                    C[(i, z)] = U[(i, z)]
                else:
                    partner = self.node_id(z[y], y)
                    zp = self._zset(z, y, x)
                    C[(i, z)] = U[(i, z)] ^ _mul(GAMMA, U[(partner, zp)])
        return U, C

    def _apply(self, chosen: tuple, targets: tuple,
               arr: np.ndarray) -> np.ndarray:
        """The (chosen, targets) recovery matrix times (c, B) rows, on the
        selected runtime, back on the host."""
        return to_host(self._recover(chosen, targets, arr[None]))[0]

    # -- chunk <-> sub-chunk plumbing -----------------------------------------

    def _split(self, chunk: np.ndarray) -> dict:
        alpha = self.get_sub_chunk_count()
        sub = len(chunk) // alpha
        planes = self._planes()
        return {z: chunk[i * sub:(i + 1) * sub]
                for i, z in enumerate(planes)}

    def _join(self, per_plane: dict) -> bytes:
        return b"".join(per_plane[z].tobytes() for z in self._planes())

    # -- encode: parities are erasures of the generic decoder -----------------

    def encode(self, want_to_encode: set, data: bytes) -> dict:
        chunks = self.encode_prepare(data)     # (k, chunk)
        C: dict = {}
        for i in range(self.k):
            for z, sub in self._split(chunks[i]).items():
                C[(i, z)] = sub.copy()
        erased = list(range(self.k, self.k + self.m))
        _U, C = self._decode_planes(C, erased)
        out = {}
        for i in want_to_encode:
            per_plane = {z: C[(i, z)] for z in self._planes()}
            out[i] = self._join(per_plane)
        return out

    def encode_chunks(self, data_chunks):
        raise NotImplementedError("clay encodes via its coupled layers")

    # -- decode ---------------------------------------------------------------

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        available = set(chunks)
        missing = sorted(want_to_read - available)
        if not missing:
            return {i: chunks[i] for i in want_to_read}
        C: dict = {}
        for i in available:
            arr = np.frombuffer(chunks[i], dtype=np.uint8)
            for z, sub in self._split(arr).items():
                C[(i, z)] = sub.copy()
        erased = [i for i in range(self.k + self.m) if i not in available]
        _U, C = self._decode_planes(C, erased)
        out = {}
        for i in want_to_read:
            if i in available:
                out[i] = chunks[i]
            else:
                out[i] = self._join({z: C[(i, z)]
                                     for z in self._planes()})
        return out

    # -- repair-bandwidth-optimal single-node repair --------------------------

    def repair_subchunks(self, lost: int) -> list[int]:
        """Sub-chunk indices each helper must send to repair `lost` —
        the q^(t-1) planes with z_{y0} = x0 (minimum_to_decode's
        sub-chunk range payload, ErasureCodeInterface.h:297-300)."""
        x0, y0 = self.node_xy(lost)
        return [i for i, z in enumerate(self._planes()) if z[y0] == x0]

    def repair(self, lost: int, helper_subchunks: dict) -> bytes:
        """Rebuild node `lost` from alpha/q sub-chunks per helper.

        helper_subchunks: {node: {z_tuple: uint8 array}} covering
        exactly the S-planes from every surviving node.
        """
        n = self.k + self.m
        x0, y0 = self.node_xy(lost)
        planes = self._planes()
        S = [z for z in planes if z[y0] == x0]
        surv = [i for i in range(n) if i != lost]
        U: dict = {}
        # 1. on each S-plane, uncouple the y != y0 rows (partners stay
        # inside S) and RS-solve the y0 row (q unknowns, m = q checks)
        for z in S:
            known: dict[int, np.ndarray] = {}
            for i in surv:
                x, y = self.node_xy(i)
                if y == y0:
                    continue
                if z[y] == x:
                    known[i] = helper_subchunks[i][z]
                else:
                    partner = self.node_id(z[y], y)
                    zp = self._zset(z, y, x)
                    u1, _ = self._uncouple(helper_subchunks[i][z],
                                           helper_subchunks[partner][zp])
                    known[i] = u1
            chosen = sorted(known)[:self.k]
            targets = [self.node_id(x, y0) for x in range(self.q)]
            rebuilt = self._apply(tuple(chosen), tuple(targets),
                                  np.stack([known[i] for i in chosen]))
            for idx, i in enumerate(targets):
                U[(i, z)] = rebuilt[idx]
        # 2. the failed node's S sub-chunks are fixed points: C = U
        out_planes: dict = {z: U[(lost, z)] for z in S}
        # 3. off-S sub-chunks via the pair algebra through row y0:
        #    for zt in S and x != x0:  z = zt(y0->x)  pairs (lost, z)
        #    with helper (x, y0, zt):
        #      C_helper = g*U(lost, z) + U(helper, zt)
        ginv = gf_inv(GAMMA)
        for zt in S:
            for x in range(self.q):
                if x == x0:
                    continue
                helper = self.node_id(x, y0)
                z = self._zset(zt, y0, x)
                u_lost_z = _mul(ginv, helper_subchunks[helper][zt]
                                ^ U[(helper, zt)])
                out_planes[z] = u_lost_z ^ _mul(GAMMA, U[(helper, zt)])
        return self._join(out_planes)


register("clay", lambda profile: ErasureCodeClay())
